"""Verified (screened) indexes in bigsi_tpu_torch, held to bigsi_tpu.

Each case of ``tests/test_verified_search.py`` runs here on the port:
``bigsi_tpu_torch.BIGSI`` on its CUDA engine's plain versions
(``device="cpu"``: the screen through kernels D and E's plain versions,
the batched verify through ``DeviceVerifier`` over kernel A's) and on
``engine: numpy`` (the mesh case on ``engine: mesh``), against
``bigsi_tpu.BIGSI`` on ``engine: numpy`` and on ``engine: tpu`` (JAX on
the CPU; the mesh case on ``engine: mesh``), and against a classic index of
the same samples.  Each package blooms the same k-mers (the blooms must
be equal) and builds its own index directory.  Tolerance: none, counts
and result dicts are equal.

Beyond those: ``DeviceVerifier`` against bigsi_tpu's ``DeviceVerifier``
and ``verify_queries`` at random shapes; every verify runs on the
staged verifier; concurrent first batches stage it once; the auto rule
stages it where it fits the device; a compact with staged columns and a
merge drop the staged verifier before the new engines are built; the
memory-capped build of a screened index.
"""

import functools
import importlib
import json
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import bigsi_tpu
import bigsi_tpu_torch
from bigsi_tpu.index import device_engine as ref_device_engine
from bigsi_tpu.index import verify as ref_verify
from bigsi_tpu.kmers import seq_to_kmers
from bigsi_tpu.matrix.bitmatrix import BitSliceMatrix as RefMatrix
from bigsi_tpu_torch.index import verify
from bigsi_tpu_torch.index.device_engine import DeviceEngine, DeviceVerifier
from bigsi_tpu_torch.index.host_engine import HostEngine
from bigsi_tpu_torch.matrix.bitmatrix import BitSliceMatrix

K = 31
BASES = "ACGT"


def dataset(rng, n=6, length=400):
    """Indexed genomes + 1-SNP mutants of each (near-miss-heavy)."""
    genomes = ["".join(BASES[i] for i in rng.integers(0, 4, length)) for _ in range(n)]
    muts = []
    for g in genomes:
        p = int(rng.integers(50, length - 50))
        muts.append(g[:p] + BASES[(BASES.index(g[p]) + 1) % 4] + g[p + 1:])
    return genomes + muts


def config(tmp_path, who, m, **extra):
    return {"storage-engine": "bigsi-tpu", "storage-config": {"filename": str(tmp_path / who)},
            "k": K, "m": m, "h": 3, **extra}


def blooms(cfg, seqs):
    """Each package's blooms of the same k-mers; -> (port's, reference's),
    which must be equal."""
    kmers = [list(seq_to_kmers(s, K)) for s in seqs]
    port = [bigsi_tpu_torch.BIGSI.bloom(cfg, k) for k in kmers]
    ref = [bigsi_tpu.BIGSI.bloom(cfg, k) for k in kmers]
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p, r)
    return port, ref


def build_both(tmp_path, seqs, names, m=200000, **extra):
    """A classic bigsi_tpu index and a verified index built by each
    package from the same blooms; -> (classic oracle, bigsi_tpu's
    verified config, the port's verified config)."""
    classic = config(tmp_path, "classic", m)
    cl = bigsi_tpu.BIGSI.build(classic, blooms(classic, seqs)[1], names)
    ref_cfg = config(tmp_path, "ref", m, screen="minimizer", **extra)
    port_cfg = config(tmp_path, "port", m, screen="minimizer", **extra)
    port_blooms, ref_blooms = blooms(ref_cfg, seqs)
    bigsi_tpu.BIGSI.build(ref_cfg, ref_blooms, names)
    port = bigsi_tpu_torch.BIGSI.build(port_cfg, port_blooms, names, device="cpu")
    assert isinstance(port, bigsi_tpu_torch.BIGSI) and port.screen is not None
    return cl, ref_cfg, port_cfg, classic


def handles(ref_cfg, port_cfg, **extra):
    """The verified index opened by each package on each engine."""
    return {
        "bigsi_tpu numpy": bigsi_tpu.BIGSI(dict(ref_cfg, **extra)),
        "bigsi_tpu tpu": bigsi_tpu.BIGSI(dict(ref_cfg, engine="tpu", **extra)),
        "port": bigsi_tpu_torch.BIGSI(dict(port_cfg, **extra), device="cpu"),
        "port numpy": bigsi_tpu_torch.BIGSI(dict(port_cfg, engine="numpy", **extra)),
    }


def assert_all_answer_as(oracle, indexes, queries, thresholds):
    """search and search_batch of every index equal the oracle's."""
    for t in thresholds:
        single = [oracle.search(q, t) for q in queries]
        batch = oracle.search_batch(queries, threshold=t)
        assert any(batch), "the queries hit"
        for name, idx in indexes.items():
            assert [idx.search(q, t) for q in queries] == single, (name, t)
            assert idx.search_batch(queries, threshold=t) == batch, (name, t)


def test_verified_identical_to_classic_all_engines(tmp_path):
    rng = np.random.default_rng(42)
    seqs = dataset(rng)
    names = ["g%d" % i for i in range(6)] + ["m%d" % i for i in range(6)]
    cl, ref_cfg, port_cfg, _ = build_both(tmp_path, seqs, names)
    idx = handles(ref_cfg, port_cfg)
    port = idx["port"]
    assert port.screen == idx["bigsi_tpu numpy"].screen == {
        "m": 200000, "tile_rows": 16, "window": 19, "slot_scheme": 3, "run_len": 20,
    }
    assert isinstance(port.screen_engine, DeviceEngine)
    assert port.screen_engine.supports_kmer_batch()  # the screen's k-mer serving path
    assert isinstance(port.screen_engine.cols, torch.Tensor) and port.screen_engine.words is None
    assert isinstance(idx["port numpy"].screen_engine, HostEngine)
    queries = [s[40:260] for s in seqs[:6]] + [s[100:300] for s in seqs[6:]]
    assert_all_answer_as(cl, idx, queries, (1.0, 0.7, 0.5))


def test_verified_identical_through_mesh_engine(tmp_path):
    """The screen on the port's mesh engine (``engine: mesh``, a 2 x 1 x 4
    mesh of positions on the CPU: kernel E's plain version per sample
    shard) and on bigsi_tpu's (8 virtual CPU devices): result dicts equal
    the classic oracle's."""
    from bigsi_tpu_torch.parallel.sharding import MeshEngine

    rng = np.random.default_rng(77)
    seqs = dataset(rng, n=4)
    names = ["g%d" % i for i in range(4)] + ["m%d" % i for i in range(4)]
    cl, ref_cfg, port_cfg, _ = build_both(tmp_path, seqs, names)
    vm = bigsi_tpu_torch.BIGSI(dict(port_cfg, engine="mesh", mesh=[2, 1, 4]), device="cpu")
    assert isinstance(vm.screen_engine, MeshEngine) and vm.screen_engine.cols is not None
    jm = bigsi_tpu.BIGSI(dict(ref_cfg, engine="mesh"))
    assert type(jm.screen_engine).__name__ == "MeshEngine"
    queries = [s[40:260] for s in seqs]
    assert_all_answer_as(cl, {"port mesh": vm, "bigsi_tpu mesh": jm}, queries, (1.0, 0.7))


def test_verified_score_path_identical(tmp_path):
    rng = np.random.default_rng(7)
    seqs = dataset(rng, n=3)
    names = ["s%d" % i for i in range(len(seqs))]
    cl, ref_cfg, port_cfg, _ = build_both(tmp_path, seqs, names)
    q = seqs[0][40:260]
    pair = [q, seqs[1][30:200]]
    for name, idx in handles(ref_cfg, port_cfg).items():
        assert idx.search(q, 0.7, score=True) == cl.search(q, 0.7, score=True), name
        assert idx.search_batch(pair, 0.7, score=True) == cl.search_batch(pair, 0.7, score=True)


def test_verified_reopen_insert_compact(tmp_path):
    rng = np.random.default_rng(13)
    seqs = dataset(rng, n=3)
    names = ["s%d" % i for i in range(len(seqs))]
    cl, ref_cfg, port_cfg, classic = build_both(tmp_path, seqs, names)
    # fresh handles read the persisted screen params + screen.bin
    port = bigsi_tpu_torch.BIGSI(port_cfg, device="cpu")
    ref = bigsi_tpu.BIGSI(ref_cfg)
    assert port.screen == ref.screen and port.screen_matrix is not None
    newbie = "".join(BASES[i] for i in rng.integers(0, 4, 200))
    port_bloom, ref_bloom = blooms(ref_cfg, [newbie])
    port.insert(port_bloom[0], "newbie")
    ref.insert(ref_bloom[0], "newbie")
    cl.insert(blooms(classic, [newbie])[1][0], "newbie")
    assert port.side is not None
    q = newbie[30:150]
    queries = [q, seqs[0][40:200]]
    assert_all_answer_as(cl, {"port": port, **handles(ref_cfg, port_cfg)}, queries, (0.7,))
    port.compact()
    ref.compact()
    cl.compact()
    # after compact the screen holds the new colour: a compacted-in
    # colour with no screen bits would silently vanish
    assert port.side is None
    assert_all_answer_as(cl, {"port": port, **handles(ref_cfg, port_cfg)}, queries, (1.0, 0.7))
    assert any(r["sample_name"] == "newbie" for r in port.search(q, 0.7))


def test_verified_merge(tmp_path):
    rng = np.random.default_rng(21)
    seqs = dataset(rng, n=2)
    built = {}
    for who, pkg in (("port", bigsi_tpu_torch), ("ref", bigsi_tpu)):
        cfgs = [config(tmp_path, who + name, 100000, screen="minimizer") for name in "ab"]
        kw = {"device": "cpu"} if pkg is bigsi_tpu_torch else {}
        b1 = pkg.BIGSI.build(cfgs[0], [pkg.BIGSI.bloom(cfgs[0], seq_to_kmers(seqs[0], K))],
                             ["a0"], **kw)
        b2 = pkg.BIGSI.build(cfgs[1], [pkg.BIGSI.bloom(cfgs[1], seq_to_kmers(seqs[1], K))],
                             ["b0"], **kw)
        b1.merge(b2)
        built[who] = (b1, cfgs[0])
    port, port_cfg = built["port"]
    ref_cfg = built["ref"][1]
    q1, q2 = seqs[0][40:200], seqs[1][40:200]
    indexes = {"port (merged in process)": port, **handles(ref_cfg, port_cfg)}
    for q, want in ((q1, {"a0"}), (q2, {"b0"})):
        for name, idx in indexes.items():
            assert {r["sample_name"] for r in idx.search(q, 1.0)} == want, name
    assert_all_answer_as(bigsi_tpu.BIGSI(ref_cfg), indexes, [q1, q2, seqs[2][40:200]], (1.0, 0.5))
    # screened/unscreened mixes refuse to merge
    c3 = config(tmp_path, "c", 100000)
    b3 = bigsi_tpu_torch.BIGSI.build(
        c3, [bigsi_tpu_torch.BIGSI.bloom(c3, seq_to_kmers(seqs[0], K))], ["c0"], device="cpu")
    with pytest.raises(ValueError, match="verified"):
        port.merge(b3)


def test_classic_counts_for_colours_native_matches_numpy(monkeypatch):
    rng = np.random.default_rng(5)
    m, w, k, h = 4096, 7, 200, 3
    words = rng.integers(0, 2 ** 32, size=(m, w), dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(0, m, size=(k, h), dtype=np.int64)
    colours = np.unique(rng.integers(0, w * 32, size=40)).astype(np.int64)
    got = verify.classic_counts_for_colours(words, idx, colours)
    np.testing.assert_array_equal(got, ref_verify.classic_counts_for_colours(words, idx, colours))
    with monkeypatch.context() as mp:
        mp.setenv("BIGSI_TPU_NO_NATIVE", "1")
        np.testing.assert_array_equal(verify.classic_counts_for_colours(words, idx, colours), got)
    # full-width cross-check against the host engine
    eng = HostEngine(BitSliceMatrix(words, num_cols=w * 32))
    full = eng.counts(eng.and_rows(idx), w * 32)
    np.testing.assert_array_equal(got, full[colours])
    # batched threaded verify agrees per query, as bigsi_tpu's does
    idx2 = rng.integers(0, m, size=(150, h), dtype=np.int64)
    col2 = np.unique(rng.integers(0, w * 32, size=10)).astype(np.int64)
    got_b = verify.verify_queries(words, [idx, None, idx2], [colours, None, col2])
    want_b = ref_verify.verify_queries(words, [idx, None, idx2], [colours, None, col2])
    np.testing.assert_array_equal(got_b[0], got)
    assert got_b[1].size == 0 and want_b[1].size == 0
    np.testing.assert_array_equal(got_b[2], eng.counts(eng.and_rows(idx2), w * 32)[col2])
    np.testing.assert_array_equal(got_b[2], want_b[2])


def test_screen_margin_policy():
    assert verify.screen_margin(512) == 41  # ceil(0.08 * 512)
    assert verify.screen_margin(10) == 8  # absolute floor
    assert verify.screen_margin(512, 0) == 0  # config override
    assert verify.screen_margin(512, 100) == 100
    for n in (0, 1, 99, 100, 101, 512, 4096, 70000):
        for override in (None, 0, 7):
            assert verify.screen_margin(n, override) == ref_verify.screen_margin(n, override)


def test_screen_config_validation():
    from bigsi_tpu.config import validate_config as ref_validate
    from bigsi_tpu_torch.config import validate_config

    base = {"k": 31, "m": 1000, "h": 3}
    good = [dict(base, screen="minimizer"),
            dict(base, screen="minimizer", **{"screen-m": 500, "screen-tile-rows": 16,
                                              "screen-window": 15, "verify-margin": 0})]
    for cfg in good:
        validate_config(cfg)
        ref_validate(cfg)
        assert verify.screen_params_from_config(cfg) == ref_verify.screen_params_from_config(cfg)
    bad = [(dict(base, screen="blocked"), "screen"),
           (dict(base, screen="minimizer", layout="minimizer"), "layout=classic"),
           (dict(base, screen="minimizer", **{"screen-m": -1}), "screen-m"),
           (dict(base, **{"screen-window": 15}), "needs 'screen"),
           (dict(base, screen="minimizer", **{"verify-margin": -2}), "verify-margin")]
    for cfg, match in bad:
        for fn in (validate_config, ref_validate):
            with pytest.raises(ValueError, match=match):
                fn(cfg)


def test_verified_small_screen_m(tmp_path):
    """The screen may be SMALLER than m: its FPR only inflates the
    candidate set (verify work), never the results."""
    rng = np.random.default_rng(31)
    seqs = dataset(rng, n=4)
    names = ["s%d" % i for i in range(len(seqs))]
    cl, ref_cfg, port_cfg, _ = build_both(tmp_path, seqs, names, **{"screen-m": 50000})
    idx = handles(ref_cfg, port_cfg)
    assert idx["port"].screen["m"] == 50000
    assert idx["port"].screen_matrix.num_rows == 50000
    assert_all_answer_as(cl, idx, [s[40:260] for s in seqs], (1.0, 0.7))


def http_json(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def test_verified_index_over_http(tmp_path):
    """HTTP serving of a verified index: /search returns the classic
    result dicts (screen + verify behind the batcher), a GET, a POST and
    a burst of 8 concurrent GETs that the batcher coalesces."""
    from bigsi_tpu_torch.http.server import make_server

    rng = np.random.default_rng(4)
    genomes = ["".join("ACGT"[c] for c in rng.integers(0, 4, 500)) for _ in range(4)]
    names = ["s%d" % i for i in range(4)]
    cl, ref_cfg, port_cfg, _ = build_both(tmp_path, genomes, names, m=1 << 18)
    ref = handles(ref_cfg, port_cfg)
    server = make_server(dict(port_cfg, serve_batch_wait_ms=30), host="127.0.0.1", port=0,
                         device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = "http://127.0.0.1:%d/search" % server.server_address[1]
        q = genomes[2][40:300]
        got = http_json(base + "?seq=%s&threshold=0.7" % q)["results"]
        assert got == cl.search(q, threshold=0.7)
        assert all(got == idx.search(q, 0.7) for idx in ref.values())
        q = genomes[1][100:400]
        assert http_json(base, {"seq": q, "threshold": 1.0})["results"] == cl.search(q, 1.0)
        burst = [g[i * 40:i * 40 + 200] for i in range(2) for g in genomes]
        with ThreadPoolExecutor(max_workers=len(burst)) as pool:
            outs = list(pool.map(lambda s: http_json(base + "?seq=%s&threshold=0.7" % s), burst))
        for s, out in zip(burst, outs):
            assert out["results"] == cl.search(s, 0.7)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    assert not thread.is_alive()


def test_device_verifier_engaged_and_identical(tmp_path, monkeypatch):
    """With the port's CUDA engine (here its plain versions on the CPU)
    the batched verify runs through DeviceVerifier, and the result dicts
    stay those of a classic index."""
    rng = np.random.default_rng(91)
    seqs = dataset(rng)
    names = ["g%d" % i for i in range(6)] + ["m%d" % i for i in range(6)]
    cl, ref_cfg, port_cfg, _ = build_both(tmp_path, seqs, names)
    port = bigsi_tpu_torch.BIGSI(port_cfg, device="cpu")
    assert port._verifier is None, "staging is lazy"
    assert isinstance(port.verifier, DeviceVerifier), "auto verify-device did not engage"
    assert port.verifier.device.type == "cpu"
    calls = {"n": 0}
    orig = port.verifier.counts_async

    def spy(idx_list, cand_list):
        calls["n"] += 1
        return orig(idx_list, cand_list)

    monkeypatch.setattr(port.verifier, "counts_async", spy)
    ref_tpu = bigsi_tpu.BIGSI(dict(ref_cfg, engine="tpu"))
    assert ref_tpu.verifier is not None
    queries = [s[40:260] for s in seqs]
    assert_all_answer_as(cl, {"port": port, "bigsi_tpu tpu": ref_tpu}, queries, (1.0, 0.7, 0.5))
    assert calls["n"] > 0, "device verifier never used"
    # explicit opt-out: the host pass alone; engine numpy: no verifier
    for cfg in (dict(port_cfg, **{"verify-device": False}), dict(port_cfg, engine="numpy")):
        off = bigsi_tpu_torch.BIGSI(cfg, device="cpu")
        assert off.verifier is None
        assert off.search_batch(queries, threshold=0.7) == cl.search_batch(queries, threshold=0.7)
    # a matrix past verify-device-max-bytes stays on the host; true forces it
    big = bigsi_tpu_torch.BIGSI(dict(port_cfg, **{"verify-device-max-bytes": 1024}), device="cpu")
    assert big.verifier is None
    forced = bigsi_tpu_torch.BIGSI(
        dict(port_cfg, engine="numpy", **{"verify-device": True}), device="cpu")
    assert isinstance(forced.verifier, DeviceVerifier)
    assert forced.search_batch(queries, threshold=0.7) == cl.search_batch(queries, threshold=0.7)


def test_device_verifier_refreshes_on_compact(tmp_path):
    """Insert + compact swaps the classic matrix; a stale device copy
    would silently drop the new colour from verification."""
    rng = np.random.default_rng(17)
    seqs = dataset(rng, n=3)
    names = ["s%d" % i for i in range(len(seqs))]
    cl, ref_cfg, port_cfg, classic = build_both(tmp_path, seqs, names)
    vd = bigsi_tpu_torch.BIGSI(port_cfg, device="cpu")
    ref = bigsi_tpu.BIGSI(dict(ref_cfg, engine="tpu"))
    old_matrix = vd.verifier.matrix
    newbie = "".join(BASES[i] for i in rng.integers(0, 4, 200))
    port_bloom, ref_bloom = blooms(ref_cfg, [newbie])
    vd.insert(port_bloom[0], "newbie")
    ref.insert(ref_bloom[0], "newbie")
    cl.insert(blooms(classic, [newbie])[1][0], "newbie")
    q = newbie[30:150]
    assert vd.search(q, 0.7) == cl.search(q, 0.7) == ref.search(q, 0.7)  # side-shard path
    vd.compact()
    ref.compact()
    cl.compact()
    assert vd._verifier is None, "compact dropped the staged matrix"
    assert vd.verifier.matrix is not old_matrix and vd.verifier.matrix is vd.bitmatrix
    res = vd.search(q, 0.7)
    assert res == cl.search(q, 0.7) == ref.search(q, 0.7)
    assert any(r["sample_name"] == "newbie" for r in res)
    queries = [q] + [s[20:220] for s in seqs]
    assert vd.search_batch(queries, 0.7) == cl.search_batch(queries, 0.7) == \
        ref.search_batch(queries, 0.7)


def test_every_verify_runs_on_the_staged_verifier(tmp_path, monkeypatch):
    """Once rows.bin is staged every verify runs on DeviceVerifier: a
    batch of two live queries, and a single search after it; before
    staging a single search verifies on the host and stages nothing, and
    with verify-device false every verify is the host pass."""
    rng = np.random.default_rng(5)
    seqs = dataset(rng, n=3)
    names = ["s%d" % i for i in range(len(seqs))]
    cl, _, port_cfg, _ = build_both(tmp_path, seqs, names)
    seen = []
    for name in ("verify_queries", "classic_counts_for_colours"):
        real = getattr(verify, name)
        monkeypatch.setattr(verify, name, functools.partial(
            lambda real, name, *a, **kw: seen.append(name) or real(*a, **kw), real, name))
    real_async = DeviceVerifier.counts_async
    monkeypatch.setattr(DeviceVerifier, "counts_async", lambda self, *a: (
        seen.append("device") or real_async(self, *a)))
    port = bigsi_tpu_torch.BIGSI(port_cfg, device="cpu")
    q = seqs[0][40:260]
    assert port.search(q, 0.7) == cl.search(q, 0.7)
    assert seen == ["classic_counts_for_colours"] and port._verifier is None
    seen.clear()
    pair = [seqs[1][20:240], seqs[2][30:250]]
    assert port.search_batch(pair, 0.7) == cl.search_batch(pair, 0.7)
    assert seen == ["device"] and isinstance(port._verifier, DeviceVerifier)
    seen.clear()
    assert port.search(q, 1.0) == cl.search(q, 1.0)
    assert seen == ["device"]
    off = bigsi_tpu_torch.BIGSI(dict(port_cfg, **{"verify-device": False}), device="cpu")
    seen.clear()
    assert off.search_batch(pair, 0.7) == cl.search_batch(pair, 0.7)
    assert off.search(q, 0.7) == cl.search(q, 0.7)
    assert seen == ["verify_queries", "classic_counts_for_colours"]


def test_verifier_staged_once_under_concurrent_batches(tmp_path, monkeypatch):
    """Two threads' first batches on a fresh verified index stage rows.bin
    once: the second waits for the first's verifier."""
    rng = np.random.default_rng(23)
    seqs = dataset(rng, n=3)
    names = ["s%d" % i for i in range(len(seqs))]
    cl, _, port_cfg, _ = build_both(tmp_path, seqs, names)
    port = bigsi_tpu_torch.BIGSI(port_cfg, device="cpu")
    staged = []
    real = DeviceVerifier.__init__

    def slow_init(self, *args, **kwargs):
        staged.append(self)
        time.sleep(0.3)  # a staging long enough for the other thread to arrive
        real(self, *args, **kwargs)

    monkeypatch.setattr(DeviceVerifier, "__init__", slow_init)
    queries = [s[30:250] for s in seqs]
    barrier = threading.Barrier(2)

    def first_batch(_):
        barrier.wait()
        return port.search_batch(queries, 0.7)

    with ThreadPoolExecutor(max_workers=2) as pool:
        outs = list(pool.map(first_batch, range(2)))
    assert len(staged) == 1 and port._verifier is staged[0]
    want = cl.search_batch(queries, 0.7)
    assert outs == [want, want]


def test_verifier_fits_the_device_free_memory(tmp_path, monkeypatch, caplog):
    """The auto rule stages rows.bin where it fits the card's free memory
    (plus torch's cached blocks) with VERIFY_HEADROOM to spare; where it
    does not, the host pass verifies and a warning says so;
    verify-device-max-bytes overrides the card."""
    from bigsi_tpu_torch.graph import bigsi as facade
    from bigsi_tpu_torch.index import device_engine

    gib = 1 << 30
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (10 * gib, 80 * gib))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev: 3 * gib)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 2 * gib)
    cuda = torch.device("cuda", 0)
    room = 11 * gib - device_engine.VERIFY_HEADROOM
    assert device_engine.device_fits(room, cuda)
    assert not device_engine.device_fits(room + 1, cuda)
    assert device_engine.device_fits(1 << 40, torch.device("cpu"))

    rng = np.random.default_rng(29)
    seqs = dataset(rng, n=3)
    names = ["s%d" % i for i in range(len(seqs))]
    cl, _, port_cfg, _ = build_both(tmp_path, seqs, names)
    asked = []
    monkeypatch.setattr(facade, "device_fits", lambda n, dev: asked.append((n, dev)) or False)
    with caplog.at_level("WARNING", logger=facade.__name__):
        full = bigsi_tpu_torch.BIGSI(port_cfg, device="cpu")
    assert full.verifier is None and "does not fit the device" in caplog.text
    assert asked == [(full.bitmatrix.words.nbytes, torch.device("cpu"))]
    queries = [s[30:250] for s in seqs]
    assert full.search_batch(queries, 0.7) == cl.search_batch(queries, 0.7)
    # the config's limit is asked instead of the device
    capped = bigsi_tpu_torch.BIGSI(
        dict(port_cfg, **{"verify-device-max-bytes": full.bitmatrix.words.nbytes}), device="cpu")
    assert isinstance(capped.verifier, DeviceVerifier) and len(asked) == 1


def random_verify_batch(rng, m, w, h, b):
    """Per-query rows and candidates: a None entry, an empty candidate
    list, a query with no k-mers, and candidates unsorted with repeats,
    the last word's last colour among them."""
    idx_list, cand_list = [], []
    for i in range(b):
        k = int(rng.integers(1, 300))
        rows = rng.integers(0, m, size=(k, h)).astype(np.int64)
        nc = int(rng.integers(1, 12))
        cand = rng.integers(0, w * 32, size=nc).astype(np.int64)
        if i == 2:
            rows, cand = None, None
        elif i == 3:
            cand = np.empty(0, dtype=np.int64)
        elif i == 4:
            rows = np.empty((0, h), dtype=np.int64)
        elif i % 2:
            cand = np.concatenate([cand, cand[:2], [w * 32 - 1]])
        idx_list.append(rows)
        cand_list.append(cand)
    return idx_list, cand_list


def test_device_verifier_unit_parity_random_shapes():
    """DeviceVerifier.counts (device="cpu": kernel A's plain version and
    the same gather) equals bigsi_tpu's DeviceVerifier.counts and both
    packages' verify_queries, at h 1, 3 and 8 and W 1, 5 and 33."""
    rng = np.random.default_rng(8)
    for h in (1, 3, 8):
        for w in (1, 5, 33):
            m = int(rng.integers(2000, 20000))
            words = rng.integers(0, 1 << 32, size=(m, w), dtype=np.uint32)
            idx_list, cand_list = random_verify_batch(rng, m, w, h, 9)
            ver = DeviceVerifier(BitSliceMatrix(words, w * 32), device="cpu")
            got = ver.counts(idx_list, cand_list)
            wants = (ref_device_engine.DeviceVerifier(RefMatrix(words, w * 32)).counts(
                         idx_list, cand_list),
                     ref_verify.verify_queries(words, idx_list, cand_list),
                     verify.verify_queries(words, idx_list, cand_list))
            for want in wants:
                assert len(got) == len(want)
                for g, x in zip(got, want):
                    assert g.dtype == np.int64
                    np.testing.assert_array_equal(g, x, err_msg="h=%d W=%d" % (h, w))


def test_device_verifier_sends_back_only_the_candidates():
    """The staged batch holds the live queries alone, padding rows at id
    0; the dispatched counts are the Σ|cand| candidates' only; ids out of
    range raise."""
    rng = np.random.default_rng(12)
    m, w, h = 5000, 5, 3
    words = rng.integers(0, 1 << 32, size=(m, w), dtype=np.uint32)
    ver = DeviceVerifier(BitSliceMatrix(words, w * 32), device="cpu")
    idx_list, cand_list = random_verify_batch(rng, m, w, h, 8)
    live = verify.live_queries(idx_list, cand_list)
    staged_live, sizes, idx, mask, flat = ver._stage(idx_list, cand_list)
    kmax = max(idx_list[i].shape[0] for i in live)
    assert staged_live == live and tuple(idx.shape) == (len(live), kmax, h)
    assert int(mask.sum()) == sum(idx_list[i].shape[0] for i in live)
    assert int(idx[~mask].abs().sum()) == 0
    assert flat.numel() == int(sizes.sum())
    pending = ver.counts_async(idx_list, cand_list)
    assert pending.done() and pending.host.numel() == sum(len(cand_list[i]) for i in live)
    got = pending()
    want = verify.verify_queries(words, idx_list, cand_list)
    assert all(np.array_equal(g, x) for g, x in zip(got, want))
    assert ver._stage([None, idx_list[0]], [None, np.empty(0, np.int64)]) is None
    assert [a.size for a in ver.counts([idx_list[0]], [np.empty(0, np.int64)])] == [0]
    with pytest.raises(IndexError):
        ver.counts([idx_list[0]], [np.array([w * 32])])
    with pytest.raises(IndexError):
        ver.counts([idx_list[0] + m], [np.array([0])])


def test_compact_and_merge_drop_the_verifier_before_new_engines(tmp_path, monkeypatch):
    """A compact that folds staged columns and a merge rebuild the
    engines; the staged verifier is dropped before the new screen engine
    is built (two device copies of a matrix never live at once), and the
    next batched verify stages the new matrix and sees the new colours."""
    rng = np.random.default_rng(33)
    seqs = dataset(rng, n=4)
    names = ["s%d" % i for i in range(len(seqs))]
    cl, ref_cfg, port_cfg, classic = build_both(tmp_path, seqs, names)
    port = bigsi_tpu_torch.BIGSI(port_cfg, device="cpu")
    ref = bigsi_tpu.BIGSI(ref_cfg)
    queries = [s[30:250] for s in seqs]
    assert port.search_batch(queries, 0.7) == cl.search_batch(queries, 0.7)
    assert port._verifier is not None
    held = []
    real = DeviceEngine.__init__

    @functools.wraps(real)
    def init(self, *args, **kwargs):
        held.append((port._verifier, port.screen_engine))
        real(self, *args, **kwargs)

    monkeypatch.setattr(DeviceEngine, "__init__", init)
    newbie = "".join(BASES[i] for i in rng.integers(0, 4, 300))
    port_bloom, ref_bloom = blooms(ref_cfg, [newbie])
    port.insert(port_bloom[0], "newbie")
    ref.insert(ref_bloom[0], "newbie")
    cl.insert(blooms(classic, [newbie])[1][0], "newbie")
    assert held == []  # a staged insert builds no engine
    port.compact()
    ref.compact()
    cl.compact()
    assert held == [(None, None)]
    queries.append(newbie[50:250])
    got = port.search_batch(queries, 0.7)
    assert got == cl.search_batch(queries, 0.7) == ref.search_batch(queries, 0.7)
    assert any(r["sample_name"] == "newbie" for r in got[-1])
    assert port._verifier.matrix is port.bitmatrix

    other_seq = "".join(BASES[i] for i in rng.integers(0, 4, 300))
    others = {}
    for who, pkg in (("port", bigsi_tpu_torch), ("ref", bigsi_tpu)):
        cfg = config(tmp_path, who + "-other", 200000, screen="minimizer")
        kw = {"device": "cpu"} if pkg is bigsi_tpu_torch else {}
        others[who] = pkg.BIGSI.build(
            cfg, [pkg.BIGSI.bloom(cfg, seq_to_kmers(other_seq, K))], ["other"], **kw)
    ccfg = config(tmp_path, "classic-other", 200000)
    cl.merge(bigsi_tpu.BIGSI.build(ccfg, blooms(ccfg, [other_seq])[1], ["other"]))
    held.clear()
    port.merge(others["port"])
    ref.merge(others["ref"])
    assert held == [(None, None)], "one engine built, after the verifier was dropped"
    queries.append(other_seq[20:260])
    got = port.search_batch(queries, 0.7)
    assert got == cl.search_batch(queries, 0.7) == ref.search_batch(queries, 0.7)
    assert any(r["sample_name"] == "other" for r in got[-1])
    assert port._verifier.matrix is port.bitmatrix and port.num_samples == len(seqs) + 2


def test_memory_capped_screened_build(tmp_path):
    """``max_memory`` forcing two chunks: the port's build merges two
    served screened indexes, as bigsi_tpu's does; the files are byte-equal
    and both packages answer alike."""
    rng = np.random.default_rng(47)
    seqs = dataset(rng, n=2)
    names = ["s%d" % i for i in range(len(seqs))]
    m = 20000
    out = {}
    for who, pkg in (("port", "bigsi_tpu_torch"), ("ref", "bigsi_tpu")):
        build_mod = importlib.import_module(pkg + ".cmds.build")
        bloom_mod = importlib.import_module(pkg + ".cmds.bloom")
        cfg = config(tmp_path, who, m, screen="minimizer")
        paths = []
        for i, s in enumerate(seqs):
            p = str(tmp_path / ("%s%d.bloom" % (who, i)))
            bloom_mod.bloom(cfg, p, seq_to_kmers(s, K))
            paths.append(p)
        per_bloom = build_mod.get_required_bytes_per_bloomfilter(m)
        max_memory = int(per_bloom * len(seqs) / 2) + 1
        assert build_mod.get_required_chunk_size(len(seqs), m, max_memory)[1] == 2
        kw = {"device": "cpu"} if who == "port" else {}
        assert build_mod.build(cfg, paths, names, max_memory=max_memory, **kw) == {
            "result": "success"}
        out[who] = cfg
    for name in ("rows.bin", "screen.bin"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()
    assert not list(tmp_path.glob("port.tmp*"))
    classic = config(tmp_path, "classic", m)
    cl = bigsi_tpu.BIGSI.build(classic, blooms(classic, seqs)[1], names)
    idx = handles(out["ref"], out["port"])
    assert idx["port"].num_samples == len(seqs)
    assert_all_answer_as(cl, idx, [s[40:300] for s in seqs], (1.0, 0.7))
