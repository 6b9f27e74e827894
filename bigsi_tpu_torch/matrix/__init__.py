from bigsi_tpu_torch.matrix.packing import (
    WORD_BITS,
    words_for,
    pack_bits_lsb,
    unpack_bits_lsb,
    bloom_bytes_to_bools,
    bools_to_bloom_bytes,
)
from bigsi_tpu_torch.matrix.bitmatrix import BitSliceMatrix, transpose_blooms

__all__ = [
    "WORD_BITS",
    "words_for",
    "pack_bits_lsb",
    "unpack_bits_lsb",
    "bloom_bytes_to_bools",
    "bools_to_bloom_bytes",
    "BitSliceMatrix",
    "transpose_blooms",
]
