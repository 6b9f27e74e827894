"""The port's engine follows an in-process change of the main matrix.

A device engine copies the matrix once, when it is built, so every change
of the matrix inside one process must rebuild it: ``merge`` and an
interior ``insert_bloom`` (an insert over an existing colour).  Each
sequence runs on the port's engine (``device="cpu"``: the kernels' plain
versions) and, on the same blooms, on ``bigsi_tpu.BIGSI`` with its numpy
host engine in its own memory store, which reads the matrix on every
call; the result dicts of ``search`` and ``search_batch`` must be equal
(tolerance zero).  As a second check they also equal the port's numpy
host engine opened on the port's store afterwards.  Layouts: classic
(kernel A), blocked/32 (kernel B), minimizer/16 (the cols layout, kernels
D, E and the seq arm) and minimizer/64 (kernel C), at k = 3 as in
``tests/test_end_to_end.py::test_merge``.
"""

import functools

import numpy as np
import pytest

import bigsi_tpu
from bigsi_tpu import storage as ref_storage
from bigsi_tpu_torch import BIGSI
from bigsi_tpu_torch.index.device_engine import DeviceEngine
from bigsi_tpu_torch.index.host_engine import HostEngine
from bigsi_tpu_torch.kmers import seq_to_kmers
from bigsi_tpu_torch.storage import get_storage

LAYOUTS = {
    "classic": {"layout": "classic"},
    "blocked32": {"layout": "blocked", "tile-rows": 32},
    "minimizer16": {"layout": "minimizer", "tile-rows": 16, "minimizer-window": 3},
    "minimizer64": {"layout": "minimizer", "tile-rows": 64, "minimizer-window": 3},
}
QUERY = "ATACACAAT"
OTHER = "ATACACAAC"  # shares 5 of QUERY's 6 distinct 3-mers
NEW = "GGTTGTTGG"


def config(name, layout):
    return {"storage-engine": "memory", "storage-config": {"filename": "mut-%s-%s" % (name, layout)},
            "k": 3, "m": 4096, "h": 3, **LAYOUTS[layout]}


def clear(cfgs):
    for c in cfgs:
        get_storage(c).delete_all()
        ref_storage.get_storage(c).delete_all()


@pytest.fixture
def configs(request):
    cfgs = [config(n, request.param) for n in ("t1", "t2")]
    clear(cfgs)
    yield cfgs
    clear(cfgs)


def blooms(cfg, *seqs):
    """The same k-mers bloomed by each package; -> (port's, reference's),
    which must be equal."""
    port = [BIGSI.bloom(cfg, seq_to_kmers(s, cfg["k"])) for s in seqs]
    ref = [bigsi_tpu.BIGSI.bloom(cfg, seq_to_kmers(s, cfg["k"])) for s in seqs]
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p, r)
    return port, ref


def searches(index, queries, threshold):
    """Every query through ``search`` and the batch through
    ``search_batch``."""
    return [index.search(q, threshold) for q in queries], index.search_batch(queries, threshold)


def agree(port, ref, cfg, queries):
    """The port's results equal the reference numpy engine's and the
    port's own host engine's, at an exact and a partial threshold."""
    for threshold in (1.0, 0.5):
        got = searches(port, queries, threshold)
        assert got == searches(ref, queries, threshold)
        assert got == searches(BIGSI(dict(cfg, engine="numpy")), queries, threshold)


@pytest.mark.parametrize("configs", sorted(LAYOUTS), indirect=True)
def test_merge_rebuilds_the_engine(configs):
    cfg1, cfg2 = configs
    (a, b), (ra, rb) = blooms(cfg1, QUERY, OTHER)
    port = BIGSI.build(cfg1, [a], ["a"], device="cpu")
    ref = bigsi_tpu.BIGSI.build(cfg1, [ra], ["a"])
    before = port.engine
    assert isinstance(before, DeviceEngine)
    assert [r["sample_name"] for r in port.search(QUERY, 0.5)] == ["a"]

    port.merge(BIGSI.build(cfg2, [b], ["b"], device="cpu"))
    ref.merge(bigsi_tpu.BIGSI.build(cfg2, [rb], ["b"]))
    assert isinstance(port.engine, DeviceEngine) and port.engine is not before
    assert port.num_samples == ref.num_samples == 2
    agree(port, ref, cfg1, [QUERY, OTHER, "ACACAA"])
    found = {r["sample_name"]: r["percent_kmers_found"] for r in port.search(QUERY, 0.5)}
    assert found == {"a": 100.0, "b": 83.33}


@pytest.mark.parametrize("configs", sorted(LAYOUTS), indirect=True)
def test_interior_insert_rebuilds_the_engine(configs):
    cfg = configs[0]
    (q, new), (rq, rnew) = blooms(cfg, QUERY, NEW)
    port = BIGSI.build(cfg, [q, q], ["a", "b"], device="cpu")
    ref = bigsi_tpu.BIGSI.build(cfg, [rq, rq], ["a", "b"])
    assert {r["sample_name"] for r in port.search(QUERY, 1.0)} == {"a", "b"}
    before = port.engine

    port.insert_bloom(new, 1)  # over colour 1: the main matrix, not the side shard
    ref.insert_bloom(rnew, 1)
    assert port.side is None and port.engine is not before
    agree(port, ref, cfg, [NEW, QUERY, OTHER])
    assert [r["sample_name"] for r in port.search(NEW, 1.0)] == ["b"]
    assert [r["sample_name"] for r in port.search(QUERY, 1.0)] == ["a"]


@pytest.mark.parametrize("configs", sorted(LAYOUTS), indirect=True)
def test_merge_folds_a_side_shard_and_builds_the_engine_once(configs, monkeypatch):
    """A merge into an index with staged (appended) columns folds them
    in and builds the device engine once, after the merge."""
    cfg1, cfg2 = configs
    (a, b, new), (ra, rb, rnew) = blooms(cfg1, QUERY, OTHER, NEW)
    port = BIGSI.build(cfg1, [a], ["a"], device="cpu")
    ref = bigsi_tpu.BIGSI.build(cfg1, [ra], ["a"])
    port.insert(new, "c")
    ref.insert(rnew, "c")
    assert port.side is not None
    other = BIGSI.build(cfg2, [b], ["b"], device="cpu")
    built = []
    real = DeviceEngine.__init__

    @functools.wraps(real)
    def init(self, *args, **kwargs):
        built.append(self)
        real(self, *args, **kwargs)

    monkeypatch.setattr(DeviceEngine, "__init__", init)
    port.merge(other)
    ref.merge(bigsi_tpu.BIGSI.build(cfg2, [rb], ["b"]))
    assert port.side is None and built == [port.engine]
    assert port.num_samples == ref.num_samples == 3
    agree(port, ref, cfg1, [QUERY, OTHER, NEW])


def test_rebuild_drops_the_old_engine_first(monkeypatch):
    """The old device engine is released before the new one is built, so
    two device copies of the index never live at once."""
    cfgs = [config("drop", "blocked32"), config("drop2", "blocked32")]
    clear(cfgs)
    (q, o, new), _ = blooms(cfgs[0], QUERY, OTHER, NEW)
    port = BIGSI.build(cfgs[0], [q, o], ["a", "b"], device="cpu")
    held = []
    real = DeviceEngine.__init__

    @functools.wraps(real)
    def init(self, *args, **kwargs):
        held.append(port.engine)  # what the index still holds while this one is built
        real(self, *args, **kwargs)

    monkeypatch.setattr(DeviceEngine, "__init__", init)
    port.insert_bloom(new, 0)
    port.merge(BIGSI.build(cfgs[1], [o], ["c"], engine_factory=HostEngine))
    assert held == [None, None]
    np.testing.assert_array_equal(
        port.engine.words.numpy().view(np.uint32)[: port.bitmatrix.num_rows], port.bitmatrix.words)
    clear(cfgs)
