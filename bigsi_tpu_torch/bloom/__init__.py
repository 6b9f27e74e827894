from bigsi_tpu_torch.bloom.bloomfilter import (
    BloomFilter,
    generate_hashes,
    build_bloom_from_kmer_matrix,
    load_bloom_file,
    save_bloom_file,
)

__all__ = [
    "BloomFilter",
    "generate_hashes",
    "build_bloom_from_kmer_matrix",
    "load_bloom_file",
    "save_bloom_file",
]
