from bigsi_tpu_torch.hashing.murmur3 import (
    murmur3_32,
    murmur3_32_batch,
    generate_hashes,
    hash_kmer_matrix,
)

__all__ = [
    "murmur3_32",
    "murmur3_32_batch",
    "generate_hashes",
    "hash_kmer_matrix",
]
