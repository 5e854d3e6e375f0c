"""The metric arithmetic on a synthetic Chrome trace: the union of device
intervals, the window of the timed jobs, device time by kernel name, the
idle gaps named by the host, and each per-layer reader; and the roofline
arithmetic against PERF.md's figures."""

from types import SimpleNamespace

import pytest

from portbench import harness, roofline, trace_math

US = 1e-6


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def synthetic():
    """Two jobs: [100, 300) and [300, 700) us. Device work (us): a window
    launch 120-170, a second one 160-200 (overlapping), a row swap
    220-240, a torch kernel 250-260, a copy 320-330, a window launch
    400-500, a set 650-690; one kernel before the window (50-90), which
    never counts. Host: compile 300-390 (the gap 330-400 falls in it)."""
    return [
        ev(trace_math.JOB_SPAN, "user_annotation", 100, 200),
        ev(trace_math.JOB_SPAN, "user_annotation", 300, 400),
        ev("portbench.compile", "user_annotation", 300, 90),
        ev("aten::zeros", "cpu_op", 550, 100),
        ev("void warmup_kernel<1>(P)", "kernel", 50, 40),
        ev("void window_stream_kernel<4, 2>(Params)", "kernel", 120, 50),
        ev("window_sweep_kernel", "kernel", 160, 40),
        ev("row_swap_kernel", "kernel", 220, 20),
        ev("void at::native::vectorized_elementwise_kernel<4>(...)", "kernel", 250, 10),
        ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 320, 10),
        ev("void window_stream_kernel<4, 2>(Params)", "kernel", 400, 100),
        ev("Memset (Device)", "gpu_memset", 650, 40),
        {"ph": "i", "name": "instant", "ts": 10},
    ]


def test_window_union_and_names():
    view = trace_math.view(trace_math.chrome_source({"traceEvents": synthetic()}))
    assert view.window == pytest.approx((100 * US, 700 * US))
    # union: 120-200, 220-240, 250-260, 320-330, 400-500, 650-690
    assert view.busy_s == pytest.approx((80 + 20 + 10 + 10 + 100 + 40) * US)
    by = view.by_name()
    assert by["void window_stream_kernel<4, 2>(Params)"] == pytest.approx(150 * US)
    assert "void warmup_kernel<1>(P)" not in by
    gaps = view.idle_gaps()
    assert gaps["portbench.compile"] == pytest.approx(70 * US)  # 330-400
    assert gaps["aten::zeros"] == pytest.approx(150 * US)  # 500-650
    assert sum(gaps.values()) == pytest.approx(view.window_s - view.busy_s)
    assert trace_math.top(by, k=2)[0][0] == "void window_stream_kernel<4, 2>(Params)"


def test_no_job_span_no_view():
    assert trace_math.view(trace_math.chrome_source({"traceEvents": [ev("k", "kernel", 0, 1)]})) is None


def test_union_of_nested_and_touching():
    assert trace_math.union_s([(0, 2), (1, 1.5), (2, 3), (5, 6)]) == pytest.approx(4)


def _ctx(view, n=28, jobs=2):
    job = SimpleNamespace(spans={"compile": 0.09, "run": 0.2}, latency_s=0.3)
    return SimpleNamespace(trace=view, jobs=[job] * jobs, n=n, root=harness.ROOT,
                           window_s=0.6, setup_s=12.5, peak_bytes=3 << 30)


def _read(name, ctx):
    return harness.metric_reader(name).read(ctx)


def test_per_layer_readers():
    view = trace_math.view(trace_math.chrome_source({"traceEvents": synthetic()}))
    ctx = _ctx(view)
    assert _read("window_ms", ctx) == pytest.approx((50 + 40 + 100) * US * 1e3 / 2)
    assert _read("row_swap_ms", ctx) == pytest.approx(20 * US * 1e3 / 2)
    assert _read("plain_ms", ctx) == pytest.approx((10 + 10 + 40) * US * 1e3 / 2)
    busy = (80 + 20 + 10 + 10 + 100 + 40) * US
    assert _read("idle_share", ctx) == pytest.approx(100 * (1 - busy / (600 * US)))
    share = 100 * 3 * roofline.pass_bound_s(28) / ((50 + 40 + 100) * US)
    assert _read("window_roofline", ctx) == pytest.approx(share)
    assert _read("compile_ms", ctx) == pytest.approx(90)


def test_readers_find_nothing_and_say_so():
    events = [ev(trace_math.JOB_SPAN, "user_annotation", 0, 100),
              ev("void at::native::fill<4>()", "kernel", 10, 10)]
    ctx = _ctx(trace_math.view(trace_math.chrome_source({"traceEvents": events})))
    for name in ("window_ms", "window_roofline", "row_swap_ms"):
        assert _read(name, ctx) is None
    assert _read("plain_ms", ctx) == pytest.approx(10 * US * 1e3 / 2)
    ctx.jobs[0].spans.pop("compile")
    assert _read("compile_ms", ctx) is None
    for name in ("window_ms", "plain_ms", "idle_share"):
        assert _read(name, _ctx(None)) is None


def test_end_to_end_readers():
    ctx = _ctx(None, jobs=0)
    ctx.jobs = [SimpleNamespace(latency_s=s / 1e3, spans={}) for s in range(1, 101)]
    ctx.window_s = 5.0
    assert _read("jobs_per_s", ctx) == pytest.approx(20)
    assert _read("job_ms_p90", ctx) == pytest.approx(90.1)
    assert _read("peak_gib", ctx) == pytest.approx(3)
    assert _read("setup_s", ctx) == pytest.approx(12.5)


def test_plain_ms_takes_every_kernel_no_metric_claims():
    """A kernel of the port that no metric of its own claims (the copy
    kernel, or one a later change adds) is ``plain_ms``'s time."""
    events = [ev(trace_math.JOB_SPAN, "user_annotation", 0, 100),
              ev("void plane_copy_kernel<4>(float4*)", "kernel", 10, 10),
              ev("cross_pair_kernel(Params)", "kernel", 30, 20),
              ev("void window_sweep_kernel<1>(Params)", "kernel", 60, 5),
              ev("row_swap_kernel(Params)", "kernel", 70, 5)]
    ctx = _ctx(trace_math.view(trace_math.chrome_source({"traceEvents": events})), jobs=1)
    assert _read("plain_ms", ctx) == pytest.approx(30 * US * 1e3)
    assert _read("window_ms", ctx) == pytest.approx(5 * US * 1e3)
    assert _read("row_swap_ms", ctx) == pytest.approx(5 * US * 1e3)


def test_split_metric_reads_with_its_quantity():
    """``<metric>.<part>`` is read by ``metrics/<metric>.py``."""
    view = trace_math.view(trace_math.chrome_source({"traceEvents": synthetic()}))
    ctx = _ctx(view)
    assert _read("idle_share.fresh", ctx) == _read("idle_share", ctx)
    assert _read("jobs_per_s.fresh", ctx) == pytest.approx(2 / 0.6)


def test_planned_jobs_per_s_is_the_job_rate():
    """The per-layer rate of a cell whose jobs plan their circuits is
    ``jobs_per_s``'s arithmetic over the same window."""
    ctx = _ctx(None, jobs=0)
    ctx.jobs = [SimpleNamespace(latency_s=0.25, spans={"compile": 0.1}) for _ in range(30)]
    ctx.window_s = 7.5
    assert _read("planned_jobs_per_s", ctx) == pytest.approx(4)
    assert _read("planned_jobs_per_s", ctx) == _read("jobs_per_s", ctx)
    ctx.jobs = []
    assert _read("planned_jobs_per_s", ctx) is None


def test_gc_ms_from_the_collector():
    import gc

    clock = harness.GcClock()
    gc.callbacks.append(clock)
    try:
        gc.collect()
        gc.collect(0)
    finally:
        gc.callbacks.remove(clock)
    assert clock.count[2] >= 1 and clock.count[0] >= 1 and sum(clock.seconds) > 0
    ctx = _ctx(None, jobs=4)
    ctx.gc = clock
    assert _read("gc_ms", ctx) == pytest.approx(sum(clock.seconds) * 1e3 / 4)
    assert _read("gc_ms", _ctx(None)) is None


def test_roofline_reproduces_perf_md():
    assert roofline.pass_bound_s(28) * 1e3 == pytest.approx(1.282, abs=5e-4)
    assert 7 * roofline.pass_bound_s(32) * 1e3 == pytest.approx(143.6, abs=0.05)
    # a whole-state window's bytes bound is the pass bound
    assert roofline.window_bound_s(28, 4, 16, 16) == (roofline.pass_bound_s(28), "bytes")
    # a lone complex low step at n = 28: 3 real products a strip (Karatsuba)
    s, by = roofline.window_bound_s(28, 0, 1, 1, real_products=3)
    assert by == "bytes" and s == pytest.approx(1.282e-3, rel=1e-3)
    s, by = roofline.window_bound_s(28, 2, 4, 4, real_products=4 * 4 * 2)  # a real 4 x 4 rmix
    assert by == "operations" and s * 1e3 == pytest.approx(3.33, abs=0.01)
