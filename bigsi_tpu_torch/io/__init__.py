from bigsi_tpu_torch.io.cortex import GraphReader, extract_kmers_from_ctx, extract_kmer_matrix_from_ctx
from bigsi_tpu_torch.io.fasta import read_fasta

__all__ = [
    "GraphReader",
    "extract_kmers_from_ctx",
    "extract_kmer_matrix_from_ctx",
    "read_fasta",
]
