"""The port's multi-process serving against bigsi_tpu's and numpy oracles.

Ports ``tests/test_distributed.py``: fleets of 2 ranks, each a fresh
process joined over gloo through ``bigsi_tpu_torch.parallel.distributed``
with 2 mesh positions on ``"cpu"`` (the kernels' plain versions), as the
JAX tests run 2 processes of 2 virtual devices.  Rank 0's results are
held to a numpy oracle, to JAX's ``prep_streams_device`` with
``grouped_counts_cols`` on the CPU, to ``bigsi_tpu.BIGSI`` on ``engine:
numpy`` over the same index directory, and at tile_rows 64 (where the
JAX engines' uint32 slot masks drop rows 32-63) to the port's
``HostEngine``.

This file is also the rank script: ``python tests/test_torch_distributed.py
MODE RANK WORLD PORT [ARGS...]`` runs one rank of a fleet (it imports
neither jax nor bigsi_tpu).  Every rank process is waited on with its
own timeout and killed when it runs over.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
RANK_TIMEOUT = 120  # seconds, each rank process
M, N_SAMPLES, H = 4096, 96, 3
TR = 16  # tile_rows of the service cases
K_SEQ = 31
REF = "ACGTAGCATCGGATCGTAGCATCGAGCTACGATCGATCGATCGGATTAGCTACGACTAGCTAGCATCGAT"


# -- the inputs: the JAX worker's seeds, shared by the ranks and the tests


def service_words(m: int = M, n: int = N_SAMPLES) -> np.ndarray:
    w = -(-n // 32)
    words = np.random.default_rng(42).integers(0, 2 ** 32, size=(m, w), dtype=np.uint64)
    words = words.astype(np.uint32)
    if n % 32:  # phantom samples of the last word are zero
        words[:, -1] &= np.uint32((1 << (n % 32)) - 1)
    return words


def query_batches(m: int = M):
    qrng = np.random.default_rng(7)
    out = []
    for b, k in ((4, 32), (2, 48)):
        idx = qrng.integers(0, m, size=(b, k, H)).astype(np.int32)
        out.append((idx, qrng.random((b, k)) < 0.9))
    return out


def grouped_queries(m: int = M):
    """Tile-coherent row ids: runs of 3 k-mers share a tile."""
    grng = np.random.default_rng(11)
    gb, gk = 3, 36
    tile = np.repeat(grng.integers(0, m // TR, size=(gb, gk // 3)), 3, axis=1)[:, :gk]
    slots = grng.integers(0, TR, size=(gb, gk, H))
    return (tile[:, :, None] * TR + slots).astype(np.int32), grng.random((gb, gk)) < 0.9


def seq_batch():
    srng = np.random.default_rng(5)
    sb, sl = 4, 80 + K_SEQ - 1
    seqs = np.frombuffer(b"ACGT", dtype=np.uint8)[srng.integers(0, 4, size=(sb, sl))]
    return np.ascontiguousarray(seqs), np.full(sb, sl, dtype=np.int32)


def tr64_queries(m: int, rng):
    """Row ids of a tile_rows-64 layout, many in rows 32-63."""
    b, k = 5, 40
    tile = np.repeat(rng.integers(0, m // 64, size=(b, k // 2)), 2, axis=1)
    slots = rng.integers(16, 64, size=(b, k, H))
    return (tile[:, :, None] * 64 + slots).astype(np.int32), rng.random((b, k)) < 0.85


# -- the rank script


def _rank_setup(argv):
    rank, world, port = int(argv[0]), int(argv[1]), argv[2]
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    from bigsi_tpu_torch.parallel import distributed

    distributed.initialize("127.0.0.1:%s" % port, world, rank)
    return rank, world, distributed


def _lists(**arrays) -> dict:
    return {k: np.asarray(v).tolist() for k, v in arrays.items()}


def _rank_service(argv):
    """Rank 0 dispatches every op of the service and prints the results;
    the other ranks run the worker loop."""
    rank, world, distributed = _rank_setup(argv)
    row_shards, case = int(argv[3]), argv[4]
    from bigsi_tpu_torch.index.device_engine import tile_streams
    from bigsi_tpu_torch.ops import lookup as plain

    import torch

    if case == "classic700":
        m, n, axes, layout = 1024, 700, (1, 1, 4), "classic"
    else:
        m, n, axes, layout = M, N_SAMPLES, ((2, 1, 2) if row_shards == 1 else (1, 1, 2)), "minimizer"
    words = service_words(m, n)
    mesh = distributed.make_global_mesh(axes, device="cpu")
    service = distributed.DistributedQueryService(
        words, mesh, m=m, layout=layout, tile_rows=TR,
        row_shards=row_shards, slot_scheme=3, device="cpu")
    if rank:
        service.run_worker_loop()
        print("PROC_OK %d" % rank, flush=True)
        return
    out = {"queries": []}
    for idx, mask in query_batches(m):
        counts, exact = service.query(idx, mask)
        out["queries"].append(_lists(counts=counts, exact=exact))
    out["presence"] = service.presence(grouped_queries(m)[0][0]).tolist()
    if layout == "minimizer":
        gidx, gvalid = grouped_queries(m)
        tile, smask = tile_streams(torch.from_numpy(gidx), torch.from_numpy(gvalid), TR)
        utile, gmask = plain.build_grouped_streams(tile, smask)
        out["grouped"] = service.query_grouped(utile.numpy(), gmask.numpy()).tolist()
    if layout == "minimizer" and row_shards == 1:
        assert service.supports_seq_batch()
        seqs, lens = seq_batch()
        got = service.query_seqs(seqs, lens, K_SEQ, H)
        assert got is not None, "seq step entry budget overflow"
        out["seqs"] = _lists(counts=got[0], n_valid=got[1])
    idx, mask = query_batches(m)[0]
    service.query(idx, mask)
    t0 = time.perf_counter()
    for _ in range(10):
        service.query(idx, mask)
    out["dispatch_ms"] = (time.perf_counter() - t0) / 10 * 1e3
    service.stop()
    service.stop()  # a second stop is a no-op
    print("RESULT " + json.dumps(out), flush=True)
    print("PROC_OK 0", flush=True)


def _rank_lockstep(argv):
    """A part that raises (rank 1's, then rank 0's) and a seq overflow:
    rank 0 raises or gets None, and every rank stays in step."""
    rank, world, distributed = _rank_setup(argv)
    from bigsi_tpu_torch.index.device_engine import DeviceEngine

    words = service_words()
    service = distributed.DistributedQueryService(
        words, distributed.make_global_mesh((2, 1, 2), device="cpu"), m=M, layout="minimizer",
        tile_rows=TR, slot_scheme=3, device="cpu")
    real_part, real_cap = service._part, DeviceEngine._seq_u_cap
    fail = {distributed.OP_QUERY: 1, distributed.OP_PRESENCE: 0}  # op -> the rank whose part raises

    def part(op, arrays, k, h):
        if fail.get(op) == rank:
            del fail[op]
            raise ValueError("a planted failure of rank %d" % rank)
        return real_part(op, arrays, k, h)

    service._part = part
    # a one-entry budget at this batch's length: every query overflows
    DeviceEngine._seq_u_cap = staticmethod(lambda nk, w: 1 if nk == 80 else real_cap(nk, w))
    if rank:
        service.run_worker_loop()
        print("PROC_OK %d" % rank, flush=True)
        return
    out = {"errors": []}
    idx, mask = query_batches()[0]
    for call in (lambda: service.query(idx, mask), lambda: service.presence(idx[0])):
        try:
            call()
            out["errors"].append(None)
        except RuntimeError as e:
            out["errors"].append(str(e))
    seqs, lens = seq_batch()
    out["overflow"] = service.query_seqs(seqs, lens, K_SEQ, H) is None
    counts, exact = service.query(idx, mask)
    out["after"] = _lists(counts=counts, exact=exact, presence=service.presence(idx[0]))
    service.stop()
    print("RESULT " + json.dumps(out), flush=True)
    print("PROC_OK 0", flush=True)


def _rank_tr64(argv):
    """DistributedEngine on a minimizer index at tile_rows 64: the grouped
    step on a [2, 1, 2] mesh, then on [1, 1, 2] with 2 row shards."""
    rank, world, distributed = _rank_setup(argv)
    from bigsi_tpu_torch.matrix.bitmatrix import BitSliceMatrix

    rng = np.random.default_rng(64)
    m, n = 64 * 40, 70
    matrix = BitSliceMatrix.create([rng.random(m) < 0.3 for _ in range(n)], m, n)
    engines = [distributed.DistributedEngine(matrix, axis_sizes=axes, layout="minimizer",
                                             tile_rows=64, row_shards=rs, device="cpu")
               for axes, rs in (((2, 1, 2), 1), ((1, 1, 2), 2))]
    if rank:
        for engine in engines:
            engine.run_worker_loop()
        print("PROC_OK %d" % rank, flush=True)
        return
    idx, mask = tr64_queries(m, np.random.default_rng(65))
    out = []
    for engine in engines:
        packed = engine.and_rows(idx[0])
        out.append(_lists(counts=engine.counts_batch(idx, mask, n),
                          presence=engine.presence_matrix(packed, n),
                          one=engine.counts(packed, n), exact=engine.exact_colours(packed)))
        engine.stop()
    print("RESULT " + json.dumps(out), flush=True)
    print("PROC_OK 0", flush=True)


def _rank_serve(argv):
    """The real entry point on every rank, rank 0 included."""
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    from bigsi_tpu_torch.http.server import serve

    serve(json.loads(argv[1]), host="127.0.0.1", port=int(argv[0]), distributed=True,
          device="cpu")
    print("PROC_OK", flush=True)


RANK_MODES = {"service": _rank_service, "lockstep": _rank_lockstep, "tr64": _rank_tr64}


# -- helpers of the tests


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(procs) -> list:
    """(rc, stdout, stderr) of each rank, each waited on for at most
    RANK_TIMEOUT seconds and killed past it."""
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=RANK_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                err += "\n[killed after %d s]" % RANK_TIMEOUT
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _fleet(mode: str, *args, world: int = 2):
    """Runs a fleet of the rank script: -> rank 0's RESULT and every
    rank's (rc, stdout, stderr), each rank checked to exit 0."""
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, __file__, mode, str(r), str(world), str(port),
                               *map(str, args)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = _wait(procs)
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0 and "PROC_OK" in out, "rank %d failed:\n%s\n%s" % (r, out, err[-3000:])
    line = next(x for x in outs[0][1].splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):]), outs


def _oracle(words, idx, mask):
    """counts int64[B, W * 32] and exact words uint32[B, W] from first
    principles (bit n of word j is sample 32 j + n)."""
    m, w = words.shape
    cols = np.unpackbits(words.view(np.uint8), axis=1, bitorder="little")  # [m, W * 32]
    b, k, h = idx.shape
    counts = np.zeros((b, w * 32), dtype=np.int64)
    exact = np.ones((b, w * 32), dtype=bool)
    for i in range(b):
        presence = cols[idx[i, :, 0]]
        for j in range(1, h):
            presence = presence & cols[idx[i, :, j]]
        counts[i] = presence[mask[i]].sum(axis=0)
        exact[i] = presence[mask[i]].all(axis=0)
    return counts, np.packbits(exact, axis=1, bitorder="little").view(np.uint32)


def _and_rows(words, idx):
    out = words[idx[:, 0]]
    for j in range(1, idx.shape[1]):
        out = out & words[idx[:, j]]
    return out


# -- the ported cases


@pytest.mark.parametrize(
    "row_shards,case", [(1, "minimizer"), (2, "minimizer"), (1, "classic700")],
    ids=["ctrl", "ctrl-rowsharded", "classic-n700-s4"])
def test_two_process_distributed_query(row_shards, case):
    got, _ = _fleet("service", row_shards, case)
    m, n = (1024, 700) if case == "classic700" else (M, N_SAMPLES)
    words = service_words(m, n)
    w = words.shape[1]
    for rec, (idx, mask) in zip(got["queries"], query_batches(m)):
        counts, exact = _oracle(words, idx, mask)
        got_c, got_e = np.array(rec["counts"]), np.array(rec["exact"], dtype=np.uint32)
        # the padded words hold phantom samples: zero counts
        if case == "classic700":
            assert got_c.shape[1] == 24 * 32 and not got_c[:, w * 32:].any()  # W 22 -> 24
        np.testing.assert_array_equal(got_c[:, : w * 32], counts)
        np.testing.assert_array_equal(got_e[:, :w], exact)
    presence = np.array(got["presence"], dtype=np.uint32)
    np.testing.assert_array_equal(presence[:, :w], _and_rows(words, grouped_queries(m)[0][0]))
    assert not presence[:, w:].any()
    if case != "classic700":
        gidx, gmask = grouped_queries(m)
        np.testing.assert_array_equal(np.array(got["grouped"])[:, : w * 32],
                                      _oracle(words, gidx, gmask)[0])
    if row_shards == 1 and case == "minimizer":
        import jax.numpy as jnp

        from bigsi_tpu.hashing.scheme import MINIMIZER_SEED, default_minimizer_s
        from bigsi_tpu.index.device_engine import DeviceEngine
        from bigsi_tpu.ops.lookup import grouped_counts_cols, pack_tile_cols_host
        from bigsi_tpu.ops.prep_jax import prep_streams_device

        seqs, lens = seq_batch()
        s_mer = default_minimizer_s(K_SEQ)
        window = K_SEQ - s_mer + 1
        ut, gm, nv, ok = prep_streams_device(
            seqs, lens, k=K_SEQ, s=s_mer, num_tiles=M // TR, h=H, tile_rows=TR, r=window + 1,
            u_cap=DeviceEngine._seq_u_cap(seqs.shape[1] - K_SEQ + 1, window),
            seed=MINIMIZER_SEED)
        assert bool(ok)
        want = np.asarray(grouped_counts_cols(jnp.asarray(pack_tile_cols_host(words, TR)),
                                              ut, gm, nv))
        np.testing.assert_array_equal(np.array(got["seqs"]["counts"])[:, : w * 32], want)
        np.testing.assert_array_equal(got["seqs"]["n_valid"], np.asarray(nv))
    assert got["dispatch_ms"] > 0


def _build_index(config, seqs, names):
    """The index on disk, built by bigsi_tpu on its numpy engine."""
    import bigsi_tpu
    from bigsi_tpu.kmers import seq_to_kmers

    blooms = [bigsi_tpu.BIGSI.bloom(config, seq_to_kmers(s, config["k"])) for s in seqs]
    bigsi_tpu.BIGSI.build(config, blooms, names)


def _samples():
    rng = np.random.default_rng(3)
    alt = REF[:40] + ("C" if REF[40] != "C" else "G") + REF[41:]
    rand = ["".join(rng.choice(list("ACGT"), 200)) for _ in range(2)]
    return [REF, alt, rand[0], REF[:50] + rand[1]], ["a", "b", "c", "d"]


def _http(base: str, path: str, body: bytes | None = None):
    with urllib.request.urlopen(base + path, data=body, timeout=60) as resp:
        return json.loads(resp.read().decode())


def _serve_fleet(config, drive):
    """Both ranks on ``serve(config, distributed=True, device="cpu")``,
    configured through the BIGSI_TPU_* variables; ``drive(base)`` runs
    against rank 0 once it answers, then SIGINT stops rank 0, which stops
    rank 1.  -> what ``drive`` returned; both ranks must exit 0."""
    coord, http_port = _free_port(), _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, BIGSI_TPU_COORDINATOR="127.0.0.1:%d" % coord,
                   BIGSI_TPU_NUM_PROCESSES="2", BIGSI_TPU_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "serve", str(http_port), json.dumps(config)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env))
    base = "http://127.0.0.1:%d" % http_port
    try:
        deadline = time.monotonic() + RANK_TIMEOUT
        while True:
            assert all(p.poll() is None for p in procs), "a rank exited before serving"
            try:
                _http(base, "/")
                break
            except (urllib.error.URLError, ConnectionError):
                assert time.monotonic() < deadline, "rank 0 never answered"
                time.sleep(0.2)
        result = drive(base)
    finally:
        if procs[0].poll() is None:
            procs[0].send_signal(signal.SIGINT)
        outs = _wait(procs)
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0 and "PROC_OK" in out, "rank %d failed:\n%s\n%s" % (r, out, err[-3000:])
    return result


def _drive(fasta, queries):
    def drive(base):
        got = {"search": [_http(base, "/search?seq=%s&threshold=%s" % (q, t))["results"]
                          for q, t in queries],
               "scored": _http(base, "/search?seq=%s&threshold=0.5&score=1" % REF)["results"],
               "bulk": [r["results"] for r in
                        _http(base, "/bulk_search?fasta=%s&threshold=0.5" % fasta)]}
        try:
            _http(base, "/insert?bloomfilter=x&sample=y", body=b"")
            got["insert"] = 200
        except urllib.error.HTTPError as e:
            got["insert"] = e.code
        return got
    return drive


def _fasta(tmp_path, seqs):
    path = tmp_path / "queries.fasta"
    path.write_text("".join(">q%d\n%s\n" % (i, s) for i, s in enumerate(seqs)))
    return str(path)


def test_distributed_serving(tmp_path):
    import bigsi_tpu

    config = {"storage-engine": "bigsi-tpu", "storage-config": {"filename": str(tmp_path / "idx")},
              "k": 31, "m": 20000, "h": 3, "layout": "minimizer", "tile-rows": 16}
    seqs, names = _samples()
    _build_index(config, seqs, names)
    bulk = [REF, REF[5:60], REF[20:]]
    queries = [(REF, 0.5), (REF, 1.0), (seqs[3], 0.3)]
    got = _serve_fleet(dict(config, mesh=[2, 1, 2]), _drive(_fasta(tmp_path, bulk), queries))
    ref = bigsi_tpu.BIGSI(dict(config, engine="numpy"))
    assert got["search"] == [ref.search(q, t) for q, t in queries]
    assert "a" in [r["sample_name"] for r in got["search"][0]]
    assert got["scored"] == ref.search(REF, 0.5, score=True)
    assert got["bulk"] == ref.search_batch(bulk, 0.5)
    assert got["insert"] == 403


def test_distributed_serving_verified(tmp_path):
    import bigsi_tpu

    base = {"storage-engine": "bigsi-tpu", "k": 31, "m": 20000, "h": 3}
    verified = dict(base, **{"storage-config": {"filename": str(tmp_path / "vidx")},
                             "screen": "minimizer"})
    classic = dict(base, **{"storage-config": {"filename": str(tmp_path / "cidx")}})
    seqs, names = _samples()
    for config in (verified, classic):
        _build_index(config, seqs, names)
    bulk = [REF, REF[5:60], seqs[2]]
    queries = [(REF, 0.5), (seqs[3], 0.3)]
    got = _serve_fleet(verified, _drive(_fasta(tmp_path, bulk), queries))
    for config in (verified, classic):
        ref = bigsi_tpu.BIGSI(dict(config, engine="numpy"))
        assert got["search"] == [ref.search(q, t) for q, t in queries]
        assert got["bulk"] == ref.search_batch(bulk, 0.5)
    assert got["insert"] == 403


def test_distribute_words_never_densifies(monkeypatch):
    """A rank reads only its own column shards, chunk by chunk: no torch
    allocation is larger than one column shard, and numpy never holds
    more than a few load chunks (the padded matrix, the rank's column
    block and even one whole column shard never exist as host copies)."""
    import tracemalloc

    import torch

    from bigsi_tpu_torch.index import device_engine
    from bigsi_tpu_torch.parallel import distributed

    chunk_rows = 256
    monkeypatch.setattr(device_engine, "LOAD_CHUNK_ROWS", chunk_rows)
    m, w, s = 4096, 63, 4  # W not a multiple of s: the last shard is padded
    shard_w = -(-w // s)
    words = np.random.default_rng(5).integers(0, 2 ** 32, size=(m, w), dtype=np.uint64)
    words = words.astype(np.uint32)
    mesh = distributed.make_global_mesh((1, 1, s), world=2, device="cpu")
    sizes = []
    for name in ("empty", "zeros"):
        real = getattr(torch, name)

        def spy(*shape, _real=real, **kw):
            out = _real(*shape, **kw)
            sizes.append(out.numel() * out.element_size())
            return out

        monkeypatch.setattr(torch, name, spy)
    limit = 4 * chunk_rows * shard_w * 4  # a shard is 16 chunks
    placed = {}
    tracemalloc.start()
    try:
        for rank in (0, 1):
            placed[rank] = distributed.distribute_words(words, mesh, rank=rank)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    monkeypatch.undo()
    assert sizes and max(sizes) <= m * shard_w * 4, "a torch allocation past one column shard"
    assert peak <= limit, "numpy held %d B on the host (limit %d)" % (peak, limit)
    got = np.concatenate([placed[r][(torch.device("cpu"), j)].numpy().view(np.uint32)
                          for r in (0, 1) for j in (0, 1)], axis=1)
    assert got.shape == (m, shard_w * s) and not got[:, w:].any()
    np.testing.assert_array_equal(got[:, :w], words)


def test_spread_subset_rejects_uneven_split():
    # the port splits a global mesh's positions evenly over the ranks
    # itself (JAX picks from each process's devices), so of JAX's two
    # errors only the uneven split can arise: it must raise, not place a
    # mesh on a few ranks
    from bigsi_tpu_torch.parallel.distributed import make_global_mesh

    with pytest.raises(ValueError, match="cannot split them evenly"):
        make_global_mesh((1, 1, 3), world=2, device="cpu")
    mesh = make_global_mesh((1, 1, 2), world=2, device="cpu")
    assert mesh.owners.reshape(-1).tolist() == [0, 1]
    assert make_global_mesh((1, 1, 2), world=1, device="cpu").owners.reshape(-1).tolist() == [0, 0]


# -- added cases


def test_tile_rows_64_over_two_ranks_matches_host_engine():
    from bigsi_tpu_torch.index.host_engine import HostEngine
    from bigsi_tpu_torch.matrix.bitmatrix import BitSliceMatrix

    got, _ = _fleet("tr64")
    rng = np.random.default_rng(64)
    m, n = 64 * 40, 70
    host = HostEngine(BitSliceMatrix.create([rng.random(m) < 0.3 for _ in range(n)], m, n))
    idx, mask = tr64_queries(m, np.random.default_rng(65))
    packed = host.and_rows(idx[0])
    for rec in got:  # the [2, 1, 2] mesh, then two row shards
        np.testing.assert_array_equal(rec["counts"], host.counts_batch(idx, mask, n))
        np.testing.assert_array_equal(rec["presence"], host.presence_matrix(packed, n))
        np.testing.assert_array_equal(rec["one"], host.counts(packed, n))
        np.testing.assert_array_equal(rec["exact"], host.exact_colours(packed))


def test_failed_part_raises_on_rank_0_and_every_rank_stays_in_step():
    got, outs = _fleet("lockstep")
    assert "[1]" in got["errors"][0] and "[0]" in got["errors"][1]
    assert "a planted failure of rank 1" in outs[1][2]
    assert got["overflow"], "an overflowed seq batch gives None"
    words = service_words()
    idx, mask = query_batches()[0]
    counts, exact = _oracle(words, idx, mask)
    w = words.shape[1]
    np.testing.assert_array_equal(np.array(got["after"]["counts"])[:, : w * 32], counts)
    np.testing.assert_array_equal(np.array(got["after"]["exact"], dtype=np.uint32)[:, :w], exact)
    np.testing.assert_array_equal(np.array(got["after"]["presence"], dtype=np.uint32)[:, :w],
                                  _and_rows(words, idx[0]))


def test_engine_distributed_without_initialize_raises():
    import torch.distributed as dist

    from bigsi_tpu_torch import BIGSI, storage
    from bigsi_tpu_torch.config import validate_config
    from bigsi_tpu_torch.graph.bigsi import engine_factory_for
    from bigsi_tpu_torch.kmers import seq_to_kmers

    assert not dist.is_initialized()
    cfg = {"storage-engine": "memory", "storage-config": {"filename": "torch-dist-noinit"},
           "k": 9, "m": 512, "h": 3, "engine": "distributed", "mesh": [1, 1, 2]}
    assert validate_config(dict(cfg)) == cfg
    with pytest.raises(ValueError, match="initialize"):
        engine_factory_for(cfg, device="cpu")
    storage.get_storage(cfg).delete_all()
    host = dict(cfg, engine="numpy")
    BIGSI.build(host, [BIGSI.bloom(host, seq_to_kmers(REF, 9))], ["a"], device="cpu")
    with pytest.raises(ValueError, match="initialize"):
        BIGSI(cfg, device="cpu")
    storage.get_storage(cfg).delete_all()


def test_serve_distributed_without_a_collective_engine_raises(monkeypatch):
    from bigsi_tpu_torch.http import server
    from bigsi_tpu_torch.index.host_engine import HostEngine
    from bigsi_tpu_torch.parallel import distributed

    class Graph:  # a handle whose engines are not the fleet's
        def __init__(self, config, device=None):
            self.engine, self.screen_engine = HostEngine, None

    monkeypatch.setattr(distributed, "initialize", lambda *a: None)
    monkeypatch.setattr(server, "BIGSI", Graph)
    cfg = {"storage-engine": "bigsi-tpu", "storage-config": {"filename": "/nonexistent/idx"},
           "k": 31, "m": 1000, "h": 3}
    with pytest.raises(ValueError, match="/nonexistent/idx"):
        server.serve(cfg, distributed=True, device="cpu")


if __name__ == "__main__":
    if sys.argv[1] == "serve":
        _rank_serve(sys.argv[2:])
    else:
        RANK_MODES[sys.argv[1]](sys.argv[2:])
    assert "jax" not in sys.modules and "bigsi_tpu" not in sys.modules
