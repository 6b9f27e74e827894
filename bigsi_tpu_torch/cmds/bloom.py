"""``bloom`` command: k-mer stream -> .bloom file
(reference: ``bigsi/cmds/bloom.py``)."""

from __future__ import annotations

import os

from bigsi_tpu_torch.graph import BIGSI
from bigsi_tpu_torch.matrix.packing import bools_to_bloom_bytes


def bloom_file_name(f: str) -> str:
    return f


def bloom(config: dict, outfile: str, kmers) -> None:
    outfile = os.path.realpath(outfile)
    bits = BIGSI.bloom(config, kmers)
    directory = os.path.dirname(outfile)
    if directory and not os.path.exists(directory):
        os.makedirs(directory)
    with open(outfile, "wb") as of:
        of.write(bools_to_bloom_bytes(bits))
