"""``build`` command: .bloom files -> index, with memory-capped chunking.

Reference: ``bigsi/cmds/build.py``.  The reference's chunked path is
broken (passes ``h`` as the bloom size at ``build.py:50`` and
references undefined variables at ``build.py:79-85``); this version
implements the intended behavior: if loading all blooms would exceed
``max_memory``, build the index in chunks and merge.
"""

from __future__ import annotations

import copy
import logging
import math

import numpy as np

from bigsi_tpu_torch.bloom import load_bloom_file
from bigsi_tpu_torch.bloom.bloomfilter import LazyBloomFile
from bigsi_tpu_torch.graph import BIGSI
from bigsi_tpu_torch.utils import chunks

logger = logging.getLogger(__name__)


def load_bloomfilter(f: str, m: int | None = None):
    """mmap-backed lazy bloom: the chunked transpose reads row slices on
    demand, so peak build memory is bounded by the transpose block, not
    N dense blooms (see LazyBloomFile)."""
    logger.debug("Loading %s", f)
    return LazyBloomFile(f, m)


def get_required_bytes_per_bloomfilter(m: int) -> float:
    # bloom bool array (m bytes as numpy bool) + packed row share (m/8)
    return m * 9 / 8


def get_required_chunk_size(N: int, m: int, max_memory: int):
    bytes_per_bloomfilter = get_required_bytes_per_bloomfilter(m)
    required_bytes = bytes_per_bloomfilter * N
    num_chunks = math.ceil(required_bytes / max_memory)
    chunk_size = math.floor(N / num_chunks)
    return chunk_size, num_chunks


def _tmp_config(config: dict, i: int) -> dict:
    tmpconfig = copy.deepcopy(config)
    sc = dict(tmpconfig.get("storage-config", {}))
    sc["filename"] = sc.get("filename", "bigsi-tpu-index") + ".tmp%i" % i
    tmpconfig["storage-config"] = sc
    return tmpconfig


def build(config: dict, bloomfilter_filepaths, samples, max_memory=None, device=None) -> dict:
    if config.get("low_mem_build") and len(bloomfilter_filepaths) > SHARD_GROUP:
        # very large N: the fd- and memory-bounded sharded builder
        # subsumes memory-capped chunking (no merge passes needed)
        return build_sharded(config, bloomfilter_filepaths, samples)
    if max_memory is None:
        chunk_size, num_chunks = len(bloomfilter_filepaths), 1
    else:
        chunk_size, num_chunks = get_required_chunk_size(
            N=len(samples), m=config["m"], max_memory=max_memory
        )
    if chunk_size < 1:
        raise ValueError("Max memory must be at least 9/8 * Bloomfilter size in bytes")
    index = None
    pairs = list(zip(bloomfilter_filepaths, samples))
    for i, chunk in enumerate(chunks(pairs, chunk_size)):
        paths = [x[0] for x in chunk]
        names = [x[1] for x in chunk]
        logger.info("Building index: %i/%i", i + 1, num_chunks)
        if i == 0:
            index = build_main(config, paths, names, device)
        else:
            tmp_index = build_main(_tmp_config(config, i), paths, names, device)
            index.merge(tmp_index)
            tmp_index.delete()
    return {"result": "success"}


def build_main(config: dict, bloomfilter_filepaths, samples, device=None) -> BIGSI:
    from bigsi_tpu_torch.index.verify import screen_params_from_config

    # verified (screen:) blooms carry m + screen-m bits — loading only
    # m would silently truncate the screen half
    total = config.get("m")
    screen = screen_params_from_config(config)
    if total is not None and screen is not None:
        total = total + screen["m"]
    bloomfilters = [
        load_bloomfilter(f, total) for f in bloomfilter_filepaths
    ]
    return BIGSI.build(config, bloomfilters, samples, device=device)


# At >= 100k samples, holding every .bloom mmap open exhausts the fd
# limit; the sharded builder processes fd-bounded column groups — the
# same shape a multi-host build takes (SURVEY §7.4: each host transposes
# its bloom subset into a column shard; shards column-concatenate).
SHARD_GROUP = 512  # samples per column shard (multiple of 32)


def _shard_transpose_plane(
    bloom_groups, num_rows: int, out_path: str, phase_name: str
) -> int:
    """Shard+merge one bit plane (classic rows or the screen half).

    ``bloom_groups`` yields lists of bit sequences, one list per column
    group; each group's column shard streams to ``out_path.shard<g>``
    (uint32[num_rows, group/32]) and the shards word-concatenate into
    ``out_path`` a chunk of rows at a time.  Returns the padded word
    count W.  Peak RAM is one transpose block + one merge chunk; open
    fds peak at max(group size, num shards).
    """
    import os

    from bigsi_tpu_torch.matrix.bitmatrix import (
        _padded_words,
        transpose_blooms_to_file,
    )
    from bigsi_tpu_torch.utils.profiling import phase

    shard_paths = []
    n = 0
    with phase(phase_name + ".shards", log_level=logging.INFO):
        for blooms in bloom_groups:
            sp = out_path + ".shard%d" % len(shard_paths)
            transpose_blooms_to_file(blooms, num_rows, sp, lane_words=1)
            shard_paths.append(sp)
            n += len(blooms)
            del blooms  # munmap the group before opening the next

    with phase(phase_name + ".shard_merge", log_level=logging.INFO):
        w_final = _padded_words(n)
        shard_w = [
            os.path.getsize(sp) // (4 * num_rows) for sp in shard_paths
        ]
        maps = [
            np.memmap(sp, dtype=np.uint32, mode="r", shape=(num_rows, w))
            for sp, w in zip(shard_paths, shard_w)
        ]
        chunk = max(1024, (1 << 28) // (4 * w_final))
        with open(out_path + ".tmp", "wb") as f:
            for r0 in range(0, num_rows, chunk):
                r1 = min(r0 + chunk, num_rows)
                block = np.zeros((r1 - r0, w_final), dtype=np.uint32)
                w0 = 0
                for mm, w in zip(maps, shard_w):
                    block[:, w0:w0 + w] = mm[r0:r1]
                    w0 += w
                block.tofile(f)
        del maps
        os.replace(out_path + ".tmp", out_path)
        for sp in shard_paths:
            os.unlink(sp)
    return w_final


def build_sharded(config: dict, bloom_paths, samples) -> dict:
    """Streamed, fd- and memory-bounded build for very large N.

    Pass 1: for each group of SHARD_GROUP blooms, stream-transpose its
    column shard (closing the blooms after the group); pass 2:
    concatenate the shards along the word axis into ``rows.bin``
    (see :func:`_shard_transpose_plane`).  Verified (``screen:``)
    configs shard-build BOTH planes from the concatenated blooms.
    Parameter persistence goes through the same
    ``persist_index_params`` as every other build path, so the index
    reopens with the exact layout/scheme/screen it was hashed with.
    """
    from bigsi_tpu_torch.graph.metadata import SampleMetadata
    from bigsi_tpu_torch.hashing.scheme import default_slot_scheme
    from bigsi_tpu_torch.index.signature import _BitSlice, persist_index_params
    from bigsi_tpu_torch.index.verify import screen_params_from_config
    from bigsi_tpu_torch.storage import get_storage

    if SHARD_GROUP % 32:
        # shard words concatenate along the uint32 word axis — a group
        # size off the 32-sample lane boundary would misalign columns
        raise ValueError("SHARD_GROUP must be a multiple of 32")
    n = len(samples)
    m = config["m"]
    layout = config.get("layout", "classic")
    screen = screen_params_from_config(config)
    total_bits = m + (screen["m"] if screen else 0)
    storage = get_storage(config)
    if not hasattr(storage, "rows_path"):
        raise ValueError("sharded build needs a directory-backed index store")
    # validate + write EVERY ksi:* key up front (a failed build leaves a
    # delete_all-recoverable partial, SURVEY §5.3)
    persist_index_params(
        storage.kv, m, config["h"], layout=layout,
        tile_rows=config.get("tile-rows", 32),
        minimizer_window=config.get("minimizer-window"),
        slot_scheme=default_slot_scheme(layout, config),
        run_len=config.get("run-len"),
        screen=screen,
    )

    def groups(start: int, nbits: int):
        for g0 in range(0, n, SHARD_GROUP):
            g1 = min(g0 + SHARD_GROUP, n)
            yield [
                _BitSlice(load_bloomfilter(p, total_bits), start, nbits)
                for p in bloom_paths[g0:g1]
            ]

    w_final = _shard_transpose_plane(
        groups(0, m), m, storage.rows_path(), "build"
    )
    if screen is not None:
        sw = _shard_transpose_plane(
            groups(m, screen["m"]), screen["m"], storage.screen_path(),
            "build.screen",
        )
        storage.adopt_screen(num_rows=screen["m"], num_words=sw)
    SampleMetadata(storage.kv).add_samples(samples)
    storage.adopt_rows(num_rows=m, num_words=w_final, num_cols=n)
    storage.close()
    return {"result": "success"}
