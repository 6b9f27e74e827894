"""The traced run's readings: spans timed through the registry, idle time
labelled by the innermost span, and the metric readers on a run."""

import dataclasses

from benchmark.harness.cell import Run
from benchmark.harness.spec import reader
from benchmark.harness.trace import SpanTimes, Timeline, label_gaps


def test_idle_time_goes_to_the_innermost_span():
    spans = [("outer", 0.0, 10.0), ("a", 1.0, 3.0), ("b", 3.0, 6.0)]
    got = dict(label_gaps([(0.5, 4.0), (7.0, 8.0), (11.0, 11.5)], spans))
    assert abs(got["a"] - 2.0) < 1e-9 and abs(got["b"] - 1.0) < 1e-9
    assert abs(got["outer"] - 1.5) < 1e-9 and abs(got["no span"] - 0.5) < 1e-9


def test_span_times_wrap_and_restore_the_registry():
    from bigsi_tpu_torch.utils.profiling import Metrics, phase

    reg = Metrics()
    with SpanTimes(reg) as spans:
        with phase("x", reg):
            pass
    with phase("y", reg):
        pass
    assert [e[0] for e in spans.events] == ["x"] and spans.events[0][1] <= spans.events[0][2]
    assert reg.snapshot()["timers"]["y"]["count"] == 1 and "observe" not in vars(reg)


def run(**kw):
    base = dict(loop="closed", setup_s=30.0, window_s=10.0, attempted=2560, answered=2560,
                latencies_s=[0.1] * 9 + [0.3], calls=10, load_s=3.0, synth_s=9.0,
                memory_peak_bytes=25_600_000_000,
                timers={"search.batch_results": 0.2, "search.presence": 0.05,
                        "search.score": 0.1, "search.batch_counts": 0.3},
                counts={"search.batch_results": 10, "search.presence": 10,
                        "search.score": 10, "search.batch_counts": 10})
    base.update(kw)
    return Run(**base)


def test_readers():
    r = run()
    assert reader("qps")(r) == 256.0
    assert abs(reader("batch_p95_ms")(r) - 210.0) < 1e-6
    assert abs(reader("facade.results_ms")(r) - 5.0) < 1e-9
    assert abs(reader("engine.counts_ms")(r) - 30.0) < 1e-9
    assert reader("facade.prep_ms")(r) is None  # no span of it ran
    assert reader("kernels.roofline")(r) is None and reader("device.idle_share")(r) is None
    tl = Timeline(busy_s=0.5, kernel_s=0.4, window_s=10.0, device_ops=[], idle_gaps=[])
    r = dataclasses.replace(r, timeline=tl, work_bytes=0.4 * 3.35e12 * 0.5)
    assert abs(reader("kernels.roofline")(r) - 50.0) < 1e-9
    assert abs(reader("device.idle_share")(r) - 95.0) < 1e-9
    h = run(loop="open_http", latencies_s=[0.01] * 96 + [None] * 4)
    assert reader("qps")(h) is None and reader("batch_p95_ms")(h) is None
