"""The port's sharded mesh engine against bigsi_tpu's.

Each case of ``tests/test_sharding.py`` runs here twice on the same
inputs, drawn from a seeded numpy generator: the port's step or
``MeshEngine`` on an 8-position mesh of ``"cpu"`` (the kernels' plain
versions), and the JAX step or ``MeshEngine`` on the 8 virtual CPU
devices of ``tests/conftest.py``.  Counts, exact words and result dicts
are integers, so every comparison is exact.  Where the JAX mesh engine
carries its tile_rows-64 slot-mask fault (uint32 masks drop rows 32-63),
the port is held to ``HostEngine`` instead.

Beyond those: the hazards of a straight translation (an empty k-slice's
exact AND, phantom samples at N = 700 on s = 4, the batch padded to d·k
on a k mesh, tile_rows 64, an engine rebuilt after a mutation), the
placement (one tensor per distinct device and sample shard), ``engine:
mesh`` through the config and the facade, and ``dryrun_multichip``
against the JAX dry run's steps.
"""

import gc
import random
import weakref

import jax
import numpy as np
import pytest
import torch

import bigsi_tpu
from bigsi_tpu import storage as ref_storage
from bigsi_tpu.matrix.bitmatrix import BitSliceMatrix as RefMatrix
from bigsi_tpu.ops import lookup as ref_lookup
from bigsi_tpu.parallel import sharding as ref
import bigsi_tpu_torch
from bigsi_tpu_torch import storage
from bigsi_tpu_torch.config import validate_config
from bigsi_tpu_torch.entry import dryrun_multichip
from bigsi_tpu_torch.index.host_engine import HostEngine
from bigsi_tpu_torch.kmers import seq_to_kmers
from bigsi_tpu_torch.matrix.bitmatrix import BitSliceMatrix
from bigsi_tpu_torch.ops import lookup as plain
from bigsi_tpu_torch.parallel import sharding as sh

CPU8 = ["cpu"] * 8


def cpu_mesh(axes):
    return sh.make_mesh(8, axes, devices=CPU8)


def matrices(rng, m, n):
    """The same random blooms as the port's and bigsi_tpu's matrix."""
    blooms = [rng.random(m) < 0.3 for _ in range(n)]
    return BitSliceMatrix.create(blooms, m, n), RefMatrix.create(blooms, m, n)


def u32(t):
    return t.cpu().numpy().view(np.uint32)


def test_factor_devices():
    for n in range(1, 17):
        assert sh.factor_devices(n) == ref.factor_devices(n)
    d, k, s = sh.factor_devices(8)
    assert d * k * s == 8 and s >= d >= k and s == 8


@pytest.mark.parametrize("axes", [(1, 1, 8), (2, 1, 4), (2, 2, 2), (8, 1, 1), (1, 8, 1)])
def test_sharded_step_parity(axes):
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    rng = np.random.default_rng(7)
    m, n, h = 500, 1000, 3
    mat, ref_mat = matrices(rng, m, n)
    B, K = 8, 96
    idx = rng.integers(0, m, size=(B, K, h)).astype(np.int32)
    mask = rng.random((B, K)) < 0.9
    mesh = cpu_mesh(axes)
    counts, exact = sh.make_sharded_query_step(mesh, h)(sh.shard_matrix(mat.words, mesh), idx, mask)
    jmesh = ref.make_mesh(8, axes)
    want_c, want_e = ref.make_sharded_query_step(jmesh, h)(ref.shard_matrix(ref_mat.words, jmesh),
                                                           idx, mask)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(u32(exact), np.asarray(want_e))
    host = HostEngine(mat)
    for b in range(B):
        hp = host.and_rows(idx[b][mask[b]])
        np.testing.assert_array_equal(counts[b, :n].numpy(), host.counts(hp, n))


def test_mesh_engine_matches_host_engine():
    rng = np.random.default_rng(3)
    mat, ref_mat = matrices(rng, 300, 700)
    row_idx = rng.integers(0, 300, size=(37, 3)).astype(np.int32)
    eng = sh.MeshEngine(mat, mesh=cpu_mesh((2, 2, 2)))
    jeng = ref.MeshEngine(ref_mat, mesh=ref.make_mesh(8, (2, 2, 2)), h=3)
    host = HostEngine(mat)
    mp, jp, hp = eng.and_rows(row_idx), jeng.and_rows(row_idx), host.and_rows(row_idx)
    for e, p in ((jeng, jp), (host, hp)):
        np.testing.assert_array_equal(eng.exact_colours(mp), e.exact_colours(p))
        np.testing.assert_array_equal(eng.counts(mp, 700), e.counts(p, 700))
        np.testing.assert_array_equal(eng.presence_matrix(mp, 700), e.presence_matrix(p, 700))


def test_mesh_engine_batch():
    rng = np.random.default_rng(4)
    mat, ref_mat = matrices(rng, 200, 256)
    queries = [rng.integers(0, 200, size=(k, 2)).astype(np.int32) for k in (5, 31, 64, 7, 100)]
    counts, exact = sh.MeshEngine(mat, mesh=cpu_mesh((4, 1, 2))).query_batch(queries)
    want_c, want_e = ref.MeshEngine(ref_mat, mesh=ref.make_mesh(8, (4, 1, 2)), h=2).query_batch(
        queries)
    np.testing.assert_array_equal(counts, want_c)
    np.testing.assert_array_equal(exact, want_e)
    host = HostEngine(mat)
    for i, q in enumerate(queries):
        np.testing.assert_array_equal(counts[i, :256], host.counts(host.and_rows(q), 256))


def test_mesh_engine_counts_batch_parity():
    rng = np.random.default_rng(11)
    m, n, h = 500, 900, 3
    mat, ref_mat = matrices(rng, m, n)
    B, K = 5, 70  # ragged: the engines pad to the mesh's axes
    idx = rng.integers(0, m, size=(B, K, h)).astype(np.int32)
    mask = rng.random((B, K)) < 0.85
    got = sh.MeshEngine(mat, mesh=cpu_mesh((2, 2, 2))).counts_batch(idx, mask, n)
    np.testing.assert_array_equal(
        got, ref.MeshEngine(ref_mat, mesh=ref.make_mesh(8, (2, 2, 2))).counts_batch(idx, mask, n))
    np.testing.assert_array_equal(got, HostEngine(mat).counts_batch(idx, mask, n))


def facades(name, mesh, seqs, k=9, **extra):
    """A memory index of ``seqs`` built by each package from the same
    k-mers: -> (the port on ``engine: mesh`` over ``mesh`` on the CPU,
    the port on ``engine: numpy``, bigsi_tpu on ``engine: mesh``)."""
    cfg = {"storage-engine": "memory", "storage-config": {"filename": name},
           "k": k, "m": 2048, "h": 3, "engine": "mesh", "mesh": list(mesh), **extra}
    storage.get_storage(cfg).delete_all()
    ref_storage.get_storage(cfg).delete_all()
    kmers = [[s[i: i + k] for i in range(len(s) - k + 1)] for s in seqs]
    names = ["s%d" % i for i in range(len(seqs))]
    port_blooms = [bigsi_tpu_torch.BIGSI.bloom(cfg, km) for km in kmers]
    bigsi_tpu_torch.BIGSI.build(dict(cfg, engine="numpy"), port_blooms, names)
    bigsi_tpu.BIGSI.build(cfg, [bigsi_tpu.BIGSI.bloom(cfg, km) for km in kmers], names)
    return (bigsi_tpu_torch.BIGSI(cfg, device="cpu"),
            bigsi_tpu_torch.BIGSI(dict(cfg, engine="numpy")), bigsi_tpu.BIGSI(cfg))


def assert_same_answers(port, others, queries, thresholds):
    """port's search_batch equals its per-query search and every other
    handle's search_batch."""
    for t in thresholds:
        got = port.search_batch(queries, t)
        assert got == [port.search(q, t) for q in queries], t
        for other in others:
            assert got == other.search_batch(queries, t), t


def test_search_batch_on_mesh_engine():
    """engine=mesh end-to-end: search_batch == per-query search."""
    rng = random.Random(13)
    seqs = ["".join(rng.choice("ACGT") for _ in range(50)) for _ in range(3)]
    port, host, jax_mesh = facades("mesh-sb", (2, 2, 2), seqs)
    assert isinstance(port.engine, sh.MeshEngine)
    assert_same_answers(port, (host, jax_mesh), [seqs[0], seqs[1][:30], seqs[2]], (0.5,))


def test_sharded_grouped_step_matches_blocked():
    """Grouped tile-dedup over a (d, 1, s) mesh == single-device blocked."""
    rng = np.random.default_rng(17)
    T, W, B, K = 19, 8, 4, 30
    tr = ref_lookup.TILE_ROWS
    tiles = rng.integers(0, 2 ** 32, size=(T, tr * W), dtype=np.uint32)
    tile = rng.integers(0, T, size=(B, K)).astype(np.int32)
    tile[:, 1:9] = tile[:, 0:1]  # minimizer-style runs
    slots = rng.integers(0, tr, size=(B, K, 3)).astype(np.uint32)
    smask = np.bitwise_or.reduce(np.uint32(1) << slots, axis=2)
    smask[rng.random((B, K)) < 0.2] = 0
    utile, gmask = ref_lookup.build_grouped_streams(tile, smask)
    mesh = cpu_mesh((2, 1, 4))
    got, _ = sh.make_sharded_grouped_step(mesh)(sh.shard_tiles(tiles, mesh), utile, gmask)
    jmesh = ref.make_mesh(8, (2, 1, 4))
    want = ref.make_sharded_grouped_step(jmesh)(ref.shard_tiles(tiles, jmesh), utile, gmask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    blocked, _ = plain.blocked_counts(torch.from_numpy(tiles.reshape(T * tr, W).view(np.int32)),
                                      torch.from_numpy(tile),
                                      torch.from_numpy(smask.astype(np.int64)), tr)
    np.testing.assert_array_equal(got.numpy(), blocked.numpy())


def test_search_batch_on_mesh_engine_minimizer():
    """engine=mesh + minimizer layout routes through the cols step."""
    rng = random.Random(23)
    seqs = ["".join(rng.choice("ACGT") for _ in range(45)) for _ in range(3)]
    port, host, jax_mesh = facades("mesh-min-sb", (2, 1, 4), seqs, layout="minimizer")
    assert port.engine.cols is not None and port.engine.words is None
    assert_same_answers(port, (host, jax_mesh), [seqs[0], seqs[1], seqs[2][:25]], (0.5, 1.0))


def test_mesh_minimizer_odd_batch_on_k_mesh():
    """Minimizer counts on a (2, 2, 2) mesh pad the batch to the grouped
    mesh's batch axis (d·k = 4), not the base mesh's d = 2."""
    rng = random.Random(29)
    seqs = ["".join(rng.choice("ACGT") for _ in range(40)) for _ in range(3)]
    port, host, jax_mesh = facades("mesh-min-odd", (2, 2, 2), seqs, layout="minimizer")
    assert port.engine.step_mesh.shape == {"d": 4, "k": 1, "s": 2}
    assert_same_answers(port, (host, jax_mesh), (seqs * 2)[:5], (0.5,))


@pytest.mark.parametrize("axes", [(2, 2, 2), (1, 4, 2), (1, 8, 1)])
def test_rowsharded_grouped_step_matches_blocked(axes):
    """ROW-sharded grouped step (tile axis over ``r``) == the JAX step
    and single-device blocked counts."""
    rng = np.random.default_rng(23)
    tr, T, W, B, K = 16, 19, 8, 4, 30  # T not a multiple of r: the pad path
    tiles = rng.integers(0, 2 ** 32, size=(T, tr * W), dtype=np.uint32)
    tile = rng.integers(0, T, size=(B, K)).astype(np.int32)
    tile[:, 1:9] = tile[:, 0:1]  # minimizer-style runs
    slots = rng.integers(0, tr, size=(B, K, 3)).astype(np.uint32)
    smask = np.bitwise_or.reduce(np.uint32(1) << slots, axis=2)
    smask[rng.random((B, K)) < 0.2] = 0
    utile, gmask = ref_lookup.build_grouped_streams(tile, smask)
    mesh = sh.make_row_mesh(axes, devices=CPU8)
    slabs = sh.shard_tiles_rows(tiles, mesh, tr)
    assert len(slabs) == axes[1] * axes[2]  # one tensor per (slab, sample shard) on one device
    got, _ = sh.make_rowsharded_grouped_step(mesh, tr)(slabs, utile, gmask)
    jmesh = ref.make_row_mesh(axes)
    want = ref.make_rowsharded_grouped_step(jmesh, tr)(ref.shard_tiles_rows(tiles, jmesh, tr),
                                                       utile, gmask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    blocked, _ = plain.blocked_counts(torch.from_numpy(tiles.reshape(T * tr, W).view(np.int32)),
                                      torch.from_numpy(tile),
                                      torch.from_numpy(smask.astype(np.int64)), tr)
    np.testing.assert_array_equal(got.numpy(), blocked.numpy())


def test_mesh_engine_row_sharded_counts_batch():
    """MeshEngine with row_shards > 1 returns the JAX mesh engine's and
    the host oracle's counts for a minimizer index."""
    from bigsi_tpu_torch.hashing.scheme import row_indices
    from bigsi_tpu_torch.kmers import seq_to_ascii

    rng = np.random.default_rng(31)
    m, n, h, tr = 2048, 40, 3, 16
    words = rng.integers(0, 2 ** 32, size=(m, 2), dtype=np.uint32)
    matrix = BitSliceMatrix(words, num_cols=n)
    eng = sh.MeshEngine(matrix, mesh=cpu_mesh((2, 1, 2)), layout="minimizer", tile_rows=tr,
                        row_shards=2, devices=CPU8)
    assert eng.step_mesh.shape == {"d": 2, "r": 2, "s": 2} and eng.cols is None
    kmers = ["ATCGGATTACA", "TCGGATTACAT", "CGGATTACATG", "GGCCGGCCGGC"]
    idx = row_indices(np.stack([seq_to_ascii(k) for k in kmers]), h, m, "minimizer",
                      tile_rows=tr)
    row_idx = np.stack([idx, idx[::-1]]).astype(np.int64)
    mask = np.ones((2, len(kmers)), dtype=bool)
    mask[1, -1] = False
    got = eng.counts_batch(row_idx, mask, n)
    jeng = ref.MeshEngine(RefMatrix(words, num_cols=n), mesh=ref.make_mesh(8, (2, 1, 2)),
                          layout="minimizer", tile_rows=tr, row_shards=2)
    np.testing.assert_array_equal(got, jeng.counts_batch(row_idx, mask, n))
    host = HostEngine(matrix)
    np.testing.assert_array_equal(got, np.stack([
        host.counts(host.and_rows(row_idx[b][mask[b]]), n) for b in range(2)]))
    for b in range(2):  # single queries and presence rows through the slabs
        rows = row_idx[b][mask[b]]
        mp, hp = eng.and_rows(rows), host.and_rows(rows)
        np.testing.assert_array_equal(eng.counts(mp, n), host.counts(hp, n))
        exact = host.exact_colours(hp)  # the random words set bits past colour n too
        np.testing.assert_array_equal(eng.exact_colours(mp), exact[exact < n])
        np.testing.assert_array_equal(eng.presence_matrix(mp, n), host.presence_matrix(hp, n))


def test_row_shards_rejects_classic():
    matrix = BitSliceMatrix(np.zeros((64, 1), dtype=np.uint32), num_cols=8)
    with pytest.raises(ValueError, match="row sharding"):
        sh.MeshEngine(matrix, mesh=cpu_mesh((1, 1, 2)), row_shards=2)
    with pytest.raises(ValueError):
        ref.MeshEngine(RefMatrix(np.zeros((64, 1), dtype=np.uint32), num_cols=8),
                       mesh=ref.make_mesh(8, (1, 1, 2)), row_shards=2)


def test_sharded_seq_step_matches_single_device():
    """Bytes to counts over the mesh (kernel H per batch shard, E per
    sample shard) == the JAX mesh step, and ok reports an overflow."""
    from bigsi_tpu.hashing.scheme import MINIMIZER_SEED

    rng = np.random.default_rng(23)
    k, h, tr, window = 31, 3, 16, 19
    T, N, B = 512, 128, 4
    L = 96 + k - 1
    seqs = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, size=(B, L))]
    lens = np.full(B, L, dtype=np.int32)
    lens[1] = k + 9
    words = rng.integers(0, 1 << 32, size=(T * tr, N // 32), dtype=np.uint32)
    cols = plain.pack_tile_cols(torch.from_numpy(words.view(np.int32)), tr).numpy()
    kw = dict(k=k, s=k - window + 1, num_tiles=T, h=h, tile_rows=tr, r=window + 1,
              u_cap=96, seed=MINIMIZER_SEED)
    mesh = cpu_mesh((2, 1, 4))
    shards = sh.place_cols(words, mesh, tr)
    assert all(t.shape == (T, 32) and t.is_contiguous() for t in shards.values())
    counts, n_valid, ok = sh.make_sharded_seq_step(mesh, **kw)(shards, seqs, lens)
    assert tuple(ok.shape) == (2,) and bool(ok.all())
    jmesh = ref.make_mesh(8, (2, 1, 4))
    jcols = ref.shard_cols(cols.view(np.uint16), jmesh)
    want_c, want_n, want_ok = ref.make_sharded_seq_step(jmesh, **kw)(jcols, seqs, lens)
    assert np.asarray(want_ok).all()
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(n_valid.numpy(), np.asarray(want_n))
    _, _, ok2 = sh.make_sharded_seq_step(mesh, **{**kw, "u_cap": 2})(shards, seqs, lens)
    assert not bool(ok2.all())
    assert not np.asarray(ref.make_sharded_seq_step(jmesh, **{**kw, "u_cap": 2})(
        jcols, seqs, lens)[2]).all()


def test_search_batch_on_mesh_engine_seq_path(tmp_path, monkeypatch):
    """engine=mesh + minimizer/v3 routes search_batch through the bytes-
    to-counts sharded step, with results equal to the host path's and
    to bigsi_tpu's mesh engine's."""
    rng = np.random.default_rng(31)
    genomes = ["".join("ACGT"[c] for c in rng.integers(0, 4, 400)) for _ in range(5)]
    cfg = {"storage-engine": "bigsi-tpu", "storage-config": {"filename": str(tmp_path / "idx")},
           "k": 31, "m": 1 << 17, "h": 3, "engine": "mesh", "mesh": [2, 1, 4],
           "layout": "minimizer", "tile-rows": 16, "minimizer-window": 19}
    kmers = [list(seq_to_kmers(g, 31)) for g in genomes]
    names = ["s%d" % i for i in range(5)]
    idx = bigsi_tpu_torch.BIGSI.build(cfg, [bigsi_tpu_torch.BIGSI.bloom(cfg, k) for k in kmers],
                                      names, device="cpu")
    assert idx.engine.supports_seq_batch()
    calls = {"n": 0}
    orig = idx.engine.counts_batch_seqs

    def spy(*a, **kw):
        calls["n"] += 1
        out = orig(*a, **kw)
        assert out is not None, "device seq path fell back (overflow?)"
        return out

    monkeypatch.setattr(idx.engine, "counts_batch_seqs", spy)
    queries = [g[13:213] for g in genomes] + ["".join("ACGT"[c] for c in rng.integers(0, 4, 150))]
    got = idx.search_batch(queries, threshold=0.7)
    assert calls["n"] == 1, "mesh seq path did not engage"
    monkeypatch.setattr(idx.engine, "supports_seq_batch", lambda: False, raising=False)
    assert got == idx.search_batch(queries, threshold=0.7)
    assert {r[0]["sample_name"] for r in got[:5]} == set(names)
    ref_cfg = dict(cfg, **{"storage-config": {"filename": str(tmp_path / "ref")}})
    jidx = bigsi_tpu.BIGSI.build(ref_cfg, [bigsi_tpu.BIGSI.bloom(ref_cfg, k) for k in kmers], names)
    assert got == jidx.search_batch(queries, threshold=0.7)


# -- the hazards of a straight translation ------------------------------------


def test_empty_k_slice_exact_is_all_ones():
    """A k-shard whose slice of a query holds no valid k-mer adds nothing
    to the counts and all ones to the exact AND, as JAX's ``where(mask,
    packed, ones)``; an all-padding query's exact is all ones."""
    rng = np.random.default_rng(5)
    m, n, h = 256, 96, 3
    mat, ref_mat = matrices(rng, m, n)
    B, K = 2, 16
    idx = rng.integers(0, m, size=(B, K, h)).astype(np.int32)
    mask = np.zeros((B, K), dtype=bool)
    mask[0, :4] = True  # k-shards 1-3 of query 0 hold no valid k-mer
    mesh = cpu_mesh((1, 4, 2))
    counts, exact = sh.make_sharded_query_step(mesh, h)(sh.shard_matrix(mat.words, mesh), idx, mask)
    jmesh = ref.make_mesh(8, (1, 4, 2))
    want_c, want_e = ref.make_sharded_query_step(jmesh, h)(ref.shard_matrix(ref_mat.words, jmesh),
                                                           idx, mask)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(u32(exact), np.asarray(want_e))
    host = HostEngine(mat)
    hp = host.and_rows(idx[0][mask[0]])
    bits = np.unpackbits(u32(exact)[0].view(np.uint8), bitorder="little")
    np.testing.assert_array_equal(np.flatnonzero(bits[:n]), host.exact_colours(hp))
    assert (u32(exact)[1] == 0xFFFFFFFF).all() and (counts[1] == 0).all()


@pytest.mark.parametrize("layout", ["classic", "minimizer"])
def test_phantom_samples_n700_on_s4(layout):
    """N = 700 (W = 22) on s = 4: words, not samples, pad to 24, so each
    shard holds 6 words (a cols shard 192 columns, a tensor of its own);
    the phantom samples never hit and the counts are cut to N."""
    rng = np.random.default_rng(9)
    m, n, h, tr = 1024, 700, 3, 16
    mat, _ = matrices(rng, m, n)
    eng = sh.MeshEngine(mat, mesh=cpu_mesh((2, 1, 4)), layout=layout, tile_rows=tr,
                        minimizer_window=None)
    shards = eng.words if layout == "classic" else eng.cols
    assert len(shards) == 4
    width = 6 if layout == "classic" else 6 * 32
    ptrs = {t.data_ptr() for t in shards.values()}
    assert len(ptrs) == 4 and all(t.shape[1] == width and t.is_contiguous()
                                  and t.data_ptr() % 16 == 0 for t in shards.values())
    idx = rng.integers(0, m, size=(5, 40, h))
    if layout == "minimizer":  # a tile's rows, as the minimizer layout makes them
        idx = idx[..., :1] // tr * tr + rng.integers(0, tr, size=(5, 40, h))
    mask = rng.random((5, 40)) < 0.9
    host = HostEngine(mat)
    np.testing.assert_array_equal(eng.counts_batch(idx, mask, n), host.counts_batch(idx, mask, n))
    counts, exact = eng.query_batch([idx[0][mask[0]]])
    assert counts.shape == (1, 24 * 32) and exact.shape == (1, 24)
    assert not counts[0, n:].any() and not np.unpackbits(exact[0].view(np.uint8))[n:].any()


def test_tile_rows_64_mesh_matches_host_engine():
    """tile_rows 64: the port's 64-bit slot masks keep rows 32-63 on the
    grouped and row-sharded steps (bigsi_tpu's mesh engine drops them,
    so the host engine is the oracle)."""
    rng = np.random.default_rng(21)
    m, n, h, tr = 64 * 40, 70, 3, 64
    mat, _ = matrices(rng, m, n)
    idx = rng.integers(0, m // tr, size=(5, 30, 1)) * tr + rng.integers(32, tr, size=(5, 30, h))
    mask = rng.random((5, 30)) < 0.9
    want = HostEngine(mat).counts_batch(idx, mask, n)
    for mesh, rows in (((2, 1, 2), 1), ((2, 1, 2), 2), ((1, 2, 2), 2)):
        eng = sh.MeshEngine(mat, mesh=cpu_mesh(mesh), layout="minimizer", tile_rows=tr,
                            row_shards=rows, devices=CPU8)
        assert eng.cols is None and eng.tiles is not None
        np.testing.assert_array_equal(eng.counts_batch(idx, mask, n), want)


def test_mesh_engine_drops_its_shards_after_a_mutation():
    """An interior insert rebuilds the engines: the old mesh engine's
    shards are freed (nothing keeps them alive), and the answers follow
    the new matrix."""
    rng = random.Random(37)
    seqs = ["".join(rng.choice("ACGT") for _ in range(60)) for _ in range(3)]
    port, _, _ = facades("mesh-mut", (2, 2, 2), seqs)
    old = [weakref.ref(t) for t in port.engine.words.values()]
    new_bloom = bigsi_tpu_torch.BIGSI.bloom(port.config, [seqs[0][i: i + 9] for i in range(52)])
    port.insert_bloom(new_bloom, 1)
    gc.collect()
    assert all(r() is None for r in old)
    assert isinstance(port.engine, sh.MeshEngine)
    host = bigsi_tpu_torch.BIGSI(dict(port.config, engine="numpy"))
    assert host.search(seqs[0], 1.0)[-1]["sample_name"] == "s1"  # the insert landed
    for t in (1.0, 0.5):
        assert port.search(seqs[0], t) == host.search(seqs[0], t)
        assert port.search_batch(seqs, t) == host.search_batch(seqs, t)


# -- placement, config and facade ---------------------------------------------


def test_placement_holds_one_tensor_per_device_and_sample_shard():
    rng = np.random.default_rng(2)
    mat, _ = matrices(rng, 128, 100)
    mesh = cpu_mesh((2, 2, 2))
    words = sh.shard_matrix(mat.words, mesh)
    assert sorted(j for _, j in words) == [0, 1]
    padded = np.zeros((mat.words.shape[0], 2 * sh.shard_words(mat.words.shape[1], 2)),
                      dtype=np.uint32)
    padded[:, : mat.words.shape[1]] = mat.words  # W padded with zero words, not samples
    np.testing.assert_array_equal(
        np.concatenate([u32(words[(torch.device("cpu"), j)]) for j in (0, 1)], axis=1), padded)
    with pytest.raises(ValueError, match="need 8 devices but only 4"):
        sh.make_mesh(8, (2, 2, 2), devices=["cpu"] * 4)


@pytest.mark.parametrize("tile_rows", [8, 16])
def test_place_cols_packs_each_column_slice(tile_rows, monkeypatch):
    """Each cols shard is kernel D's output over its own column slice,
    packed chunk by chunk (W 22 padded to 24 words on s = 4, m not a
    whole number of tiles): together, the JAX package's cols of the
    zero-padded matrix."""
    from bigsi_tpu_torch.index import device_engine

    monkeypatch.setattr(device_engine, "LOAD_CHUNK_ROWS", 4 * tile_rows)
    rng = np.random.default_rng(43)
    m, w, s = 1000, 22, 4
    words = rng.integers(0, 1 << 32, size=(m, w), dtype=np.uint32)
    shards = sh.place_cols(words, cpu_mesh((2, 1, s)), tile_rows)
    assert sorted(j for _, j in shards) == list(range(s))
    assert all(t.is_contiguous() and t.shape[1] == 6 * 32 for t in shards.values())
    padded = np.zeros((-(-m // tile_rows) * tile_rows, 24), dtype=np.uint32)
    padded[:m, :w] = words
    want = ref_lookup.pack_tile_cols_host(padded, tile_rows)
    got = np.concatenate([shards[(torch.device("cpu"), j)].numpy() for j in range(s)], axis=1)
    np.testing.assert_array_equal(got.view(want.dtype), want)


def test_engine_mesh_through_config_and_facade(monkeypatch):
    """``engine: mesh`` validates, serves search, search_batch and scored
    search with the host engine's result dicts, and places every
    position on the given device; with no device it draws them from the
    CUDA devices and raises when there are too few."""
    rng = random.Random(41)
    seqs = ["".join(rng.choice("ACGT") for _ in range(70)) for _ in range(4)]
    port, host, _ = facades("mesh-cfg", (2, 2, 2), seqs)
    assert validate_config(dict(port.config)) is not None
    assert set(port.engine.mesh.devices.flat) == {torch.device("cpu")}
    assert len(port.engine.words) == 2  # the matrix once: one tensor per sample shard
    queries = [seqs[0], seqs[1][:40], seqs[2], seqs[3][10:60]]
    for t in (1.0, 0.6):
        assert [port.search(q, t) for q in queries] == [host.search(q, t) for q in queries]
        assert port.search_batch(queries, t) == host.search_batch(queries, t)
        assert port.search(queries[0], t, score=True) == host.search(queries[0], t, score=True)
        assert (port.search_batch(queries, t, score=True)
                == host.search_batch(queries, t, score=True))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="need 8 devices but only 4"):
        bigsi_tpu_torch.BIGSI(port.config)
    with pytest.raises(ValueError, match="initialize"):  # no process group in this process
        bigsi_tpu_torch.BIGSI(dict(port.config, engine="distributed"), device="cpu")
    with pytest.raises(ValueError, match="three positive sizes"):
        bigsi_tpu_torch.BIGSI(dict(port.config, mesh=[2]), device="cpu")


# -- the dry run ---------------------------------------------------------------


STEP_FACTORIES = ("make_sharded_query_step", "make_sharded_grouped_step",
                  "make_sharded_cols_step", "make_rowsharded_grouped_step",
                  "make_sharded_seq_step")


@pytest.fixture
def jax_dryrun(tmp_path, monkeypatch):
    """bigsi_tpu's dry run on the 8 virtual devices, each step's inputs
    and outputs recorded: -> {factory name: (args, outputs)}."""
    import importlib

    saved = {key: getattr(jax.config, key) for key in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_entry_size_bytes",
        "jax_persistent_cache_min_compile_time_secs")}
    monkeypatch.setenv("BIGSI_TPU_JAX_CACHE", str(tmp_path / "jax_cache"))
    seen = {}

    def recording(name, make):
        def factory(*a, **kw):
            step = make(*a, **kw)

            def run(*args):
                out = step(*args)
                seen[name] = (args, out)
                return out

            return run

        return factory

    for name in STEP_FACTORIES:
        monkeypatch.setattr(ref, name, recording(name, getattr(ref, name)))
    try:
        importlib.import_module("__graft_entry__").dryrun_multichip(8)
        yield seen
    finally:
        for key, value in saved.items():
            jax.config.update(key, value)


def test_dryrun_multichip_matches_jax_steps(jax_dryrun):
    got = dryrun_multichip(8, device="cpu")
    ins, outs = got["inputs"], got["outputs"]
    assert ins["mesh"] == (2, 2, 2) and ins["row_mesh"] == (2, 2, 2)
    args, (counts, exact) = jax_dryrun["make_sharded_query_step"]
    np.testing.assert_array_equal(np.asarray(args[0])[:, :ins["words"].shape[1]], ins["words"])
    np.testing.assert_array_equal(np.asarray(args[1]), ins["row_idx"])
    np.testing.assert_array_equal(np.asarray(args[2]), ins["mask"])
    np.testing.assert_array_equal(outs["counts"], np.asarray(counts))
    np.testing.assert_array_equal(outs["exact"], np.asarray(exact))
    args, grouped = jax_dryrun["make_sharded_grouped_step"]
    np.testing.assert_array_equal(np.asarray(args[1]), ins["utile"])
    np.testing.assert_array_equal(np.asarray(args[2]), ins["gmask"])
    np.testing.assert_array_equal(outs["grouped"], np.asarray(grouped))
    args, cols = jax_dryrun["make_sharded_cols_step"]
    np.testing.assert_array_equal(np.asarray(args[3]), ins["n_valid"])
    np.testing.assert_array_equal(outs["cols"], np.asarray(cols))
    np.testing.assert_array_equal(outs["rowsharded"],
                                  np.asarray(jax_dryrun["make_rowsharded_grouped_step"][1]))
    args, (scounts, nvalid, ok) = jax_dryrun["make_sharded_seq_step"]
    np.testing.assert_array_equal(np.asarray(args[1]), ins["seqs"])
    np.testing.assert_array_equal(outs["seq"], np.asarray(scounts))
    np.testing.assert_array_equal(outs["seq_n_valid"], np.asarray(nvalid))
    assert outs["seq_ok"].all() and np.asarray(ok).all()
