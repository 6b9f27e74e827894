"""bigsi_tpu_torch's own profiling: ``phase`` feeds the registry the same
way with the span log on or off, the log's records (parents, call ids,
threads), its ring bound, and ``device_trace``'s Chrome trace holding the
log's spans on the profiler's clock.  CPU only."""

import contextvars
import json
import threading

import pytest
import torch

from bigsi_tpu_torch.utils import profiling
from bigsi_tpu_torch.utils.profiling import Metrics, SpanLog, device_trace, phase, spans


@pytest.fixture
def log(monkeypatch):
    """The process span log, off and empty; its state restored after."""
    monkeypatch.setattr(profiling, "_SPANS_ON", False)
    spans.clear()
    yield spans
    spans.clear()


def observing(reg):
    """reg with its observe calls recorded as (name, seconds)."""
    calls = []
    real = reg.observe

    def observe(name, seconds):
        calls.append((name, seconds))
        real(name, seconds)

    reg.observe = observe
    return calls


def nested(reg):
    with phase("a", reg):
        with phase("b", reg):
            with phase("c", reg):
                pass
        with phase("d", reg):
            pass


@pytest.mark.parametrize("on", [False, True])
def test_phase_observes_once_per_span(log, on):
    if on:
        log.start()
    reg = Metrics()
    calls = observing(reg)
    nested(reg)
    assert [n for n, _ in calls] == ["c", "b", "d", "a"]
    assert all(isinstance(s, float) and s >= 0 for _, s in calls)
    snap = reg.snapshot()
    assert set(snap) == {"counters", "timers"}
    assert {k: v["count"] for k, v in snap["timers"].items()} == dict.fromkeys("abcd", 1)
    assert set(snap["timers"]["a"]) == {"count", "total_s", "max_s"}
    assert len(log.records()) == (4 if on else 0)


def test_the_log_records_nothing_while_off(log):
    nested(Metrics())
    log.start()
    log.stop()
    nested(Metrics())
    assert log.records() == [] and not log.on


def test_parents_and_call_ids(log):
    log.start()
    reg = Metrics()
    other = {}

    def on_thread(name):
        with phase(name, reg):
            other[name] = threading.get_ident()

    with phase("root", reg):
        with phase("child", reg):
            with phase("grandchild", reg):
                pass
        # a thread of its own starts a call of its own; one run in a copy
        # of this context stays in this call
        t = threading.Thread(target=on_thread, args=("alone",))
        t.start()
        t.join(timeout=30)
        ctx = contextvars.copy_context()
        u = threading.Thread(target=ctx.run, args=(on_thread, "carried"))
        u.start()
        u.join(timeout=30)
    assert not t.is_alive() and not u.is_alive()
    with phase("second", reg):
        pass
    recs = {r.name: r for r in log.records()}
    root = recs["root"]
    assert root.parent is None and root.call == root.id
    assert recs["child"].parent == root.id and recs["grandchild"].parent == recs["child"].id
    assert recs["child"].call == recs["grandchild"].call == root.id
    assert recs["carried"].parent == root.id and recs["carried"].call == root.id
    alone = recs["alone"]
    assert alone.parent is None and alone.call == alone.id != root.id
    assert alone.thread == other["alone"] != root.thread
    assert recs["carried"].thread == other["carried"]
    assert recs["second"].parent is None and recs["second"].call not in (root.id, alone.id)
    assert len({r.id for r in recs.values()}) == len(recs)
    for r in recs.values():
        assert r.start_ns <= r.end_ns
    assert root.start_ns <= recs["grandchild"].start_ns <= recs["grandchild"].end_ns <= root.end_ns
    assert profiling.current_span() is None


def test_record_span_observes_and_logs_under_its_parent(log):
    log.start()
    reg = Metrics()
    with phase("dispatch", reg):
        parent = profiling.current_span()
        profiling.record_span("wait", 100, 2_000_100, parent, 7, reg)
    timers = reg.snapshot()["timers"]
    assert timers["wait"]["count"] == 1 and timers["wait"]["total_s"] == pytest.approx(2e-3)
    recs = {r.name: r for r in log.records()}
    assert recs["wait"].parent == recs["dispatch"].id == recs["wait"].call
    assert (recs["wait"].start_ns, recs["wait"].end_ns, recs["wait"].thread) == (100, 2_000_100, 7)


def test_the_ring_is_bounded_and_counts_what_it_drops(log, monkeypatch):
    small = SpanLog(capacity=4)
    monkeypatch.setattr(profiling, "spans", small)
    small.start()
    before = profiling.metrics.snapshot()["counters"].get("trace.spans_dropped", 0)
    reg = Metrics()
    for i in range(7):
        with phase("p%d" % i, reg):
            pass
    assert [r.name for r in small.records()] == ["p3", "p4", "p5", "p6"]
    after = profiling.metrics.snapshot()["counters"]["trace.spans_dropped"]
    assert after - before == 3
    assert reg.snapshot()["timers"]["p0"]["count"] == 1  # the registry keeps every span
    assert profiling.SPAN_LOG_CAPACITY == 1 << 20 and spans.capacity == 1 << 20


def test_device_trace_writes_the_spans_on_the_profilers_clock(log, tmp_path):
    from torch.profiler import record_function

    config = {"trace_dir": str(tmp_path / "traces")}
    with device_trace("probe", config):
        with phase("host.step"):
            with record_function("block"):
                torch.ones(1000).cumsum(0)
    assert log.on  # a configured trace dir turns the log on
    with open(tmp_path / "traces" / "probe.json") as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    block = next(e for e in events if e.get("name") == "block" and e.get("ph") == "X")
    ours = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(ours) == {"probe", "host.step"}
    step = ours["host.step"]
    assert abs(step["ts"] - block["ts"]) < 1000.0  # µs
    assert step["ts"] <= block["ts"] + 1000.0 and step["dur"] >= 0
    assert step["args"]["parent"] == ours["probe"]["args"]["span"]
    assert step["args"]["call"] == ours["probe"]["args"]["call"]
    assert step["pid"] == profiling.SPAN_TRACK_PID != block["pid"]
    names = [e for e in events if e.get("ph") == "M" and e.get("pid") == profiling.SPAN_TRACK_PID]
    assert names and names[0]["args"]["name"] == "bigsi_tpu_torch spans"


def test_device_trace_without_a_trace_dir_is_a_phase(log, monkeypatch):
    monkeypatch.delenv("BIGSI_TPU_TRACE_DIR", raising=False)
    reg_before = profiling.metrics.snapshot()["timers"].get("quiet", {}).get("count", 0)
    with device_trace("quiet", {}):
        pass
    assert profiling.metrics.snapshot()["timers"]["quiet"]["count"] == reg_before + 1
    assert not log.on and log.records() == []


def test_probe_spans_matches_each_kernel_with_its_span():
    from bigsi_tpu_torch.scripts.probe_spans import match

    def span(ts, dur):
        return {"ph": "X", "cat": "program_span", "name": "engine.seq_kernels", "ts": ts,
                "dur": dur}

    def kernel(name, ts, dur):
        return {"ph": "X", "cat": "kernel", "name": name + "(int const*)", "ts": ts, "dur": dur}

    trace = {"traceEvents": [
        span(100.0, 100.0), kernel("seq_streams_kernel", 110.0, 10.0),
        kernel("cols_counts_kernel", 125.0, 60.0),
        span(300.0, 100.0), kernel("seq_streams_kernel", 299.0, 10.0),
        kernel("cols_counts_kernel", 330.0, 90.0),  # ends 20 µs past its span
        {"ph": "X", "cat": "kernel", "name": "slot_counts_kernel", "ts": 500.0, "dur": 5.0},
    ]}
    got = match(trace, 50.0)
    assert got["spans"] == 2 and got["kernels"] == {"H": 2, "E": 2} and got["outside"] == 0
    assert got["max_overhang_ms"] == pytest.approx(0.02)
    assert got["median_span_start_to_h_ms"] == pytest.approx(0.0045)
    assert got["median_e_end_to_span_end_ms"] == pytest.approx((15.0 - 20.0) / 2 / 1e3)
    assert match(trace, 10.0)["outside"] == 1


def test_probe_spans_runs_on_the_cpu(log, tmp_path, capsys):
    from bigsi_tpu_torch.scripts import probe_spans

    out = tmp_path / "spans"
    assert probe_spans.main(["--device", "cpu", "--m", "100000", "--samples", "32",
                             "--calls", "2", "--out", str(out)]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["spans"] == 2 and got["kernels"] == {"H": 0, "E": 0}
    assert got["device"].startswith("cpu")
    assert (out / "probe.spans.json").is_file() and (out / "probe_spans.json").is_file()
