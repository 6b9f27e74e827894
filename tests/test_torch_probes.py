"""The probes' kernels and entry points of the port against the JAX package.

Kernel F (``gather_rows``: S2, ``scripts/probe_multidma.py``), kernel G
(``tile_xor``: case k1 of S3-S5, ``scripts/bisect_*.py``, and S1's floor,
``scripts/microbench.py``), kernel B's counts-only build (S3 case k2) and
S1's work (kernel C over pre-gathered tiles).  The same inputs, made from
seeded numpy, go through the JAX function (the Pallas kernels in
interpret mode) or a numpy restatement of the Pallas kernel, and through
the port's wrapper on CPU tensors, which runs the kernel's plain PyTorch
version.  Outputs are bit words and integer counts, so every comparison
is exact (tolerance zero).  The scripts that build a full-size matrix at
import (``scripts/bisect_kernel.py``, ``bisect_size.py``) are never
imported; each entry point of the port runs once on the CPU in a process
that must never load jax.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigsi_tpu.ops import lookup as jax_lookup
from bigsi_tpu.ops import pallas_lookup
from bigsi_tpu_torch.ops import fused_lookup
from bigsi_tpu_torch.ops import lookup
from bigsi_tpu_torch.scripts import microbench, timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
grouped_counts_jnp = jax.jit(jax_lookup.grouped_counts, static_argnums=3)
blocked_counts_jnp = jax.jit(jax_lookup.blocked_counts, static_argnums=4)


def as_torch(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def random_words(rng, m, w):
    return rng.integers(0, 2**32, size=(m, w), dtype=np.uint32)


def run_tiles(rng, num_tiles, b, k):
    """Tile ids with runs of repeated tiles, as in tests/test_pallas_lookup.py."""
    tile = rng.integers(0, num_tiles, size=(b, k)).astype(np.int32)
    tile[:, 1::3] = tile[:, 0::3][:, : tile[:, 1::3].shape[1]]
    return tile


# -- kernel F: gather_rows (S2) ----------------------------------------------


@pytest.fixture(scope="module")
def s2():
    """scripts/probe_multidma.py itself, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "probe_multidma_s2", os.path.join(REPO, "scripts", "probe_multidma.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("row_words", [32, 128])
def test_gather_rows_matches_s2_in_interpret_mode(s2, row_words):
    rng = np.random.default_rng(row_words)
    m, n, chunk = 1000, 64, 16
    mat = random_words(rng, m, row_words)
    idx = rng.integers(0, m, size=n).astype(np.int32)
    idx[-1] = m - 1
    want = s2.build(chunk, row_words, interpret=True)(jnp.asarray(idx), jnp.asarray(mat), n=n)
    got = fused_lookup.gather_rows(as_torch(mat), as_torch(idx), chunk)
    assert got.dtype == torch.int32 and got.shape == (n, row_words)
    np.testing.assert_array_equal(u32(got), np.asarray(want))


@pytest.mark.parametrize("row_words,n", [(128, 0), (1, 77), (33, 50), (8192, 3)])
def test_gather_rows_matches_numpy(row_words, n):
    rng = np.random.default_rng(n + row_words)
    m = 40
    mat = random_words(rng, m, row_words)
    idx = rng.integers(0, m, size=n).astype(np.int32)
    got = fused_lookup.gather_rows(as_torch(mat), as_torch(idx), 4)
    assert got.shape == (n, row_words)
    np.testing.assert_array_equal(u32(got), mat[idx])


def test_gather_rows_checks_its_arguments():
    mat = torch.zeros((8, 4), dtype=torch.int32)
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        fused_lookup.gather_rows(mat, idx, 3)  # not a rows-in-flight build
    with pytest.raises(TypeError):
        fused_lookup.gather_rows(mat, idx.long())
    with pytest.raises(ValueError):
        fused_lookup.gather_rows(mat, idx[None])
    with pytest.raises(ValueError):
        fused_lookup.gather_rows(mat.to("meta"), idx.to("meta"))


# -- kernel G: tile_xor (S3-S5 case k1, S1's floor) ---------------------------


def k1_over_chunk_streams(words, tile, smask, tile_rows, chunk):
    """Case k1 of scripts/bisect_kernel.py (:69-107), restated in numpy
    over P1's chunk streams: each chunk copies its distinct tiles into
    their scratch slots, then every k-mer XORs the slot it reads; a
    query's result is the XOR over its chunks."""
    n_unique, utile, uslot, slotidx = pallas_lookup.build_chunk_streams(tile, smask, chunk)
    b, k = tile.shape
    w = words.shape[1]
    tiles = words.reshape(-1, tile_rows, w)
    scratch = np.zeros((2 * chunk, tile_rows, w), dtype=np.uint32)
    out = np.zeros((b, tile_rows, w), dtype=np.uint32)
    for g in range(n_unique.shape[0]):
        for j in range(n_unique[g]):
            scratch[uslot[g * chunk + j]] = tiles[utile[g * chunk + j]]
        acc = np.zeros((tile_rows, w), dtype=np.uint32)
        for c in range(chunk):
            acc ^= scratch[slotidx[g * chunk + c]]
        out[g // (k // chunk)] ^= acc
    return out


@pytest.mark.parametrize("tile_rows,w", [
    (8, 1), (16, 1), (32, 1), (64, 1), (8, 33), (16, 33), (32, 33), (64, 33), (32, 32)])
def test_tile_xor_matches_k1_over_chunk_streams(tile_rows, w):
    """Pad-free streams (k1 consumes every k-mer's slot): the port's
    tile-stream form equals the chunk-stream form."""
    rng = np.random.default_rng(tile_rows * 100 + w)
    num_tiles, b, k, chunk = 29, 3, 48, 16
    words = random_words(rng, num_tiles * tile_rows, w)
    tile = run_tiles(rng, num_tiles, b, k)
    smask = np.full((b, k), 7, dtype=np.uint32)
    got = fused_lookup.tile_xor(as_torch(words), as_torch(tile),
                                torch.ones((b, k), dtype=torch.bool), tile_rows)
    assert got.shape == (b, tile_rows, w)
    np.testing.assert_array_equal(u32(got), k1_over_chunk_streams(words, tile, smask, tile_rows, chunk))


def test_tile_xor_without_kmers_is_zero():
    words = random_words(np.random.default_rng(1), 64, 3)
    tile = np.zeros((2, 0), dtype=np.int32)
    want = k1_over_chunk_streams(words, tile, np.zeros((2, 0), np.uint32), 32, 16)
    got = fused_lookup.tile_xor(as_torch(words), as_torch(tile), torch.zeros((2, 0), dtype=torch.bool), 32)
    assert got.shape == (2, 32, 3) and not got.any()
    np.testing.assert_array_equal(u32(got), want)


@pytest.mark.parametrize("tile_rows,w", [(8, 1), (16, 33), (32, 2), (64, 33)])
def test_tile_xor_skips_padding(tile_rows, w):
    rng = np.random.default_rng(tile_rows + w)
    num_tiles, b, k = 17, 4, 70
    words = random_words(rng, num_tiles * tile_rows, w)
    tile = run_tiles(rng, num_tiles, b, k)
    valid = rng.random((b, k)) >= 0.3
    valid[1] = False  # an all-padding query: zeros
    got = fused_lookup.tile_xor(as_torch(words), as_torch(tile), torch.from_numpy(valid), tile_rows)
    tiles = words.reshape(num_tiles, tile_rows, w)
    want = np.zeros((b, tile_rows, w), dtype=np.uint32)
    for i in range(b):
        for j in np.nonzero(valid[i])[0]:
            want[i] ^= tiles[tile[i, j]]
    np.testing.assert_array_equal(u32(got), want)
    assert not got[1].any()


def small_ctx(b=2, k=48, run=6, seed=0):
    """The port microbench's shape at a CPU size: 2,048 tiles of 32 x 32."""
    return microbench.Ctx(b, k, 3, run, "cpu", m=2048 * microbench.TR, seed=seed)


def test_pallas_floor_matches_kern_floor():
    """S1's floor (scripts/microbench.py:199-204, kern_floor) restated in
    numpy: the XOR over U of the pre-gathered fat [8, 128] tiles."""
    ctx = small_ctx()
    g, ar = ctx.pregathered()
    got = fused_lookup.tile_xor(g, ar, torch.ones(ar.shape, dtype=torch.bool), microbench.TR)
    fat = u32(ctx.words).reshape(ctx.t, 8, 128)[ctx.utile.numpy()]  # [B, U, 8, 128]
    want = np.bitwise_xor.reduce(fat, axis=1)
    np.testing.assert_array_equal(u32(got).reshape(ctx.b, 8, 128), want)


def test_tile_xor_checks_its_arguments():
    words = torch.zeros((64, 2), dtype=torch.int32)
    tile = torch.zeros((1, 4), dtype=torch.int32)
    valid = torch.ones((1, 4), dtype=torch.bool)
    with pytest.raises(ValueError):
        fused_lookup.tile_xor(words, tile, valid, 48)  # 48 does not divide 64
    with pytest.raises(TypeError):
        fused_lookup.tile_xor(words, tile, valid.int(), 32)
    with pytest.raises(ValueError):
        fused_lookup.tile_xor(words, tile, valid[:, :3], 32)


# -- kernel B's counts-only build (S3 case k2) -------------------------------


@pytest.mark.parametrize("seed,b,k", [(0, 2, pallas_lookup.CHUNK), (1, 1, 2 * pallas_lookup.CHUNK)])
def test_tile_counts_only_matches_p1(seed, b, k):
    """Against P1 (query_counts_exact, interpret mode) at its W = 32 and
    tile_rows 32, and against the exact build's counts."""
    rng = np.random.default_rng(seed)
    num_tiles, tr = 37, pallas_lookup.TILE_ROWS
    words = random_words(rng, num_tiles * tr, pallas_lookup.W)
    tile = run_tiles(rng, num_tiles, b, k)
    slots = rng.integers(0, tr, size=(b, k, 3)).astype(np.uint32)
    smask = np.bitwise_or.reduce(np.uint32(1) << slots, axis=2)
    smask[rng.random((b, k)) < 0.15] = 0
    want_counts, _ = pallas_lookup.query_counts_exact(
        np.ascontiguousarray(words.reshape(num_tiles * 8, 128)), tile, smask)
    args = (as_torch(words), as_torch(tile), torch.from_numpy(smask.astype(np.int64)), tr)
    counts, exact = fused_lookup.tile_counts(*args, exact=False)
    assert exact is None
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    assert torch.equal(counts, fused_lookup.tile_counts(*args)[0])


@pytest.mark.parametrize("tile_rows,w", [(8, 1), (16, 33), (32, 32), (64, 3)])
def test_tile_counts_only_matches_blocked_counts(tile_rows, w):
    rng = np.random.default_rng(tile_rows * w)
    num_tiles, b, k = 19, 3, 40
    words = random_words(rng, num_tiles * tile_rows, w)
    tile = run_tiles(rng, num_tiles, b, k)
    slots = rng.integers(0, min(tile_rows, 32), size=(b, k, 3)).astype(np.uint32)
    smask = np.bitwise_or.reduce(np.uint32(1) << slots, axis=2)
    smask[rng.random((b, k)) < 0.2] = 0
    smask[2] = 0  # an all-padding query
    counts, _ = fused_lookup.tile_counts(
        as_torch(words), as_torch(tile), torch.from_numpy(smask.astype(np.int64)), tile_rows,
        exact=False)
    want = blocked_counts_jnp(jnp.asarray(words.reshape(num_tiles, tile_rows * w)),
                              jnp.asarray(tile), jnp.asarray(smask), jnp.asarray(smask != 0),
                              tile_rows)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want))
    assert not counts[2].any()


# -- S1: the microbench's context and kernel C over pre-gathered tiles --------


def test_microbench_streams_match_the_jax_script():
    """The port's Ctx draws the TPU script's tile runs and slot masks
    (scripts/microbench.py:83-94) and groups them as the JAX package does."""
    ctx = small_ctx(b=3, k=100)
    rng = np.random.default_rng(0)
    nt = (3 * 100 + 5) // 6
    base = rng.integers(0, ctx.t, size=nt).astype(np.int32)
    tile_ids = np.repeat(base, 6)[:300].reshape(3, 100)
    slots = rng.integers(0, 32, size=(3, 100, 3)).astype(np.uint32)
    smask = np.bitwise_or.reduce(np.uint32(1) << slots, axis=2)
    np.testing.assert_array_equal(ctx.tile.numpy(), tile_ids)
    np.testing.assert_array_equal(ctx.smask.numpy(), smask.astype(np.int64))
    want_u, want_g = jax_lookup.build_grouped_streams(tile_ids, smask, r=6)
    np.testing.assert_array_equal(ctx.utile.numpy(), want_u)
    np.testing.assert_array_equal(ctx.gmask.numpy(), want_g.astype(np.int64))


def test_pallas_work_matches_jax_grouped_counts():
    """The microbench's grouped full case at B 2, K 48, run 6: kernel C's
    plain version over the pre-gathered buffer with utile = arange equals
    JAX grouped_counts over the original tiles with the real utile (the
    identity S1 rests on), and the port's kernel C over the words."""
    ctx = small_ctx()
    g, ar = ctx.pregathered()
    counts, exact = fused_lookup.grouped_tile_counts(g, ar, ctx.gmask, microbench.TR)
    tiles = jnp.asarray(u32(ctx.words).reshape(ctx.t, -1))
    want = grouped_counts_jnp(tiles, jnp.asarray(ctx.utile.numpy()),
                              jnp.asarray(ctx.gmask.numpy().astype(np.uint32)), microbench.TR)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want))
    real = fused_lookup.grouped_tile_counts(ctx.words, ctx.utile, ctx.gmask, microbench.TR)
    assert torch.equal(counts, real[0]) and torch.equal(exact, real[1])


# -- timing -------------------------------------------------------------------


def test_timing_on_the_cpu_is_labelled_host_clock():
    assert "host clock" in timing.device_label("cpu")
    calls = []
    ms = timing.time_ms(lambda: calls.append(1), 3, "cpu")
    assert ms >= 0 and len(calls) == 4  # a warm-up call, then the timed ones
    t = torch.arange(4)
    assert timing.same(t, t.clone()) and timing.same((t, None), (t, None))
    assert not timing.same((t, None), (t, t)) and not timing.same(t, t + 1)


# -- the entry points, in a process that never loads jax ----------------------

RUNNER = """
import json, runpy, sys
sys.argv = json.loads(sys.argv[1])
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
print(json.dumps({"jax_loaded": "jax" in sys.modules}))
"""

ENTRY_POINTS = {
    "microbench": ["bigsi_tpu_torch.scripts.microbench", "--device", "cpu", "--m", "65536",
                   "--b", "4", "--k", "48", *microbench.CASES],
    "probe_multidma": ["bigsi_tpu_torch.scripts.probe_multidma", "--device", "cpu", "--m", "1000",
                       "--rows", "300", "--plain-baseline", "--reps", "2"],
    "bisect-kernel": ["bigsi_tpu_torch.scripts.bisect", "--device", "cpu", "--tiles", "256",
                      "--reps", "2", "kernel"],
    "bisect-size": ["bigsi_tpu_torch.scripts.bisect", "--device", "cpu", "--tiles", "256",
                    "--reps", "2", "size", "4", "8"],
    "probe_ah": ["bigsi_tpu_torch.scripts.probe_ah", "--device", "cpu", "--m", "100000",
                 "--samples", "40", "--reps", "1"],
    "probe_pack": ["bigsi_tpu_torch.scripts.probe_pack", "--device", "cpu", "--m", "20000",
                   "--samples", "40", "--reps", "1"],
    "probe_ij": ["bigsi_tpu_torch.scripts.probe_ij", "--device", "cpu", "--batch", "2000",
                 "--kmers", "5000", "--m", "100000", "--reps", "1"],
    "probe_presence": ["bigsi_tpu_torch.scripts.probe_presence", "--device", "cpu", "--m",
                       "20000", "--reps", "1"],
}


def run_entry_point(argv, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", RUNNER, json.dumps(argv)], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_the_cpu_without_jax(name, tmp_path):
    proc = run_entry_point(ENTRY_POINTS[name], tmp_path)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"jax_loaded": False}
    assert any("host clock" in line for line in lines)


def test_probe_ij_split_refuses_the_cpu(tmp_path):
    proc = run_entry_point(["bigsi_tpu_torch.scripts.probe_ij_split", "--reps", "1"], tmp_path)
    assert proc.returncode != 0 and "needs a CUDA device" in proc.stderr


def test_probe_ij_split_cuts_apply_to_the_source():
    """Each cut of probe_ij_split matches kernels I's and J's source
    exactly once (a stale cut would time another kernel than it names)."""
    from bigsi_tpu_torch.scripts import probe_ij_split

    text = probe_ij_split.SOURCE.read_text()
    for name in probe_ij_split.CUTS:
        assert (probe_ij_split.cut_source(name, text) == text) == (name == "full")
    with pytest.raises(RuntimeError, match="matches 0 times"):
        probe_ij_split.cut_source("one_word", "no such source")


def test_bisect_compile_refuses_the_cpu(tmp_path):
    proc = run_entry_point(["bigsi_tpu_torch.scripts.bisect", "--device", "cpu", "--tiles", "64",
                            "compile", "4"], tmp_path)
    assert proc.returncode != 0 and "needs a CUDA device" in proc.stderr


PTXAS_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z8kernel_aPj' for 'sm_90a'
ptxas info    : Function properties for _Z8kernel_aPj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z8kernel_bPj' for 'sm_90a'
ptxas info    : Function properties for _Z8kernel_bPj
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, 4228 bytes smem, 384 bytes cmem[0]
"""


def test_bisect_parses_the_ptxas_report():
    from bigsi_tpu_torch.scripts import bisect

    assert bisect.parse_ptxas(PTXAS_REPORT) == {
        "_Z8kernel_aPj": "Used 40 registers, 384 bytes cmem[0]; "
                         "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "_Z8kernel_bPj": "Used 255 registers, 4228 bytes smem, 384 bytes cmem[0]; "
                         "8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
    }
