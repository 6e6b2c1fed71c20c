"""``benchmark/trace.py``'s summary and ``benchmark/port_trace.py`` on a
synthetic Chrome trace that holds the benchmark's spans, the port's,
runtime launches on two host threads and the device activity they
launched, sharing correlation ids; and the metric files that read the
port's spans and the feed's counters against hand-computed values."""

from __future__ import annotations

import pytest

from benchmark import harness, port_trace, trace
from benchmark.trace import summarise

MAIN, PRODUCER = 1, 2


def span(name, s, e, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": s,
            "dur": e - s, "tid": tid}


def launch(corr, ts, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 2, "tid": tid, "args": {"correlation": corr}}


def device(corr, s, e, cat="kernel", name="k"):
    return {"ph": "X", "cat": cat, "name": name, "ts": s, "dur": e - s,
            "tid": 7, "args": {"correlation": corr}}


def serve_events():
    """One request of two batches (µs). The producer thread's copy is
    launched at 20, inside the first feed wait's time but on another
    thread. Device busy: [30, 90], [150, 460], [800, 900]."""
    return [
        span(trace.REQUEST, 0, 1000),
        span("vcd.feed.wait", 10, 100),
        launch(1, 20, PRODUCER), device(1, 30, 90, "gpu_memcpy"),
        span("vcd.serve.forward", 100, 200),
        launch(2, 110), device(2, 150, 300, name="k_a"),
        launch(3, 120), device(3, 300, 450, name="k_b"),
        launch(4, 130), device(4, 450, 460, "gpu_memcpy"),
        {"ph": "X", "cat": "gpu_user_annotation", "name": "vcd.serve.forward",
         "ts": 150, "dur": 310, "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 111, "dur": 5,
         "tid": MAIN},
        span("vcd.serve.emit", 200, 600),
        span("vcd.serve.result_wait", 210, 455),
        span("vcd.feed.wait", 600, 700),
        span("vcd.serve.forward", 700, 720),
        launch(5, 710), device(5, 800, 900, name="k_a"),
        span("vcd.feed.wait", 880, 990),
    ]


def without_port_spans(events):
    return [e for e in events if not (e.get("cat") == "user_annotation"
                                      and e["name"].startswith("vcd."))]


EXISTING = ("busy_s", "window_s", "kernels", "fills", "spans")


def test_the_existing_readings_ignore_the_port_spans():
    """The port's spans change only the names of the idle gaps."""
    events = serve_events()
    got = summarise(events, 0.002)
    bare = summarise(without_port_spans(events), 0.002)
    assert {k: got[k] for k in EXISTING} == {k: bare[k] for k in EXISTING}
    assert [g[1:] for g in got["gaps"]] == [g[1:] for g in bare["gaps"]]
    assert got["busy_s"] == pytest.approx((60 + 310 + 100) * 1e-6)
    assert got["fills"] == [pytest.approx(30e-6)]
    assert got["spans"] == {trace.REQUEST: 1, trace.FETCH: 0, trace.STEP: 0}
    assert bare["program_spans"] == [] and bare["span_device_s"] == {}


def test_gaps_keep_their_durations_and_take_the_innermost_span():
    events = serve_events()
    gaps = summarise(events, 0.002)["gaps"]
    parent = summarise(without_port_spans(events), 0.002)["gaps"]
    assert [g[2] for g in gaps] == pytest.approx([g[2] for g in parent])
    assert [g[0] for g in parent] == [trace.REQUEST] * 4
    # at 0 only the request is open; at 90 and 900 a wait on the feed; at
    # 460 the emit, whose wait for the card has ended
    assert [(g[0], g[1]) for g in gaps] == [
        (trace.REQUEST, 0), ("vcd.feed.wait", 90), ("vcd.serve.emit", 460),
        ("vcd.feed.wait", 900)]
    assert port_trace.idle_by_span(gaps) == pytest.approx({
        "vcd.serve.emit": 340e-6, "vcd.feed.wait": 160e-6,
        trace.REQUEST: 30e-6})


def test_breakdown_names_the_port_span_the_card_waited_in():
    got = trace.breakdown(summarise(serve_events(), 0.002))
    assert got["idle_gaps"] == [["vcd.serve.emit", pytest.approx(340e-6)],
                                ["vcd.feed.wait", pytest.approx(100e-6)],
                                ["vcd.feed.wait", pytest.approx(60e-6)],
                                [trace.REQUEST, pytest.approx(30e-6)]]
    assert got["device_ops"] == [["k_a", pytest.approx(250e-6)],
                                 ["k_b", pytest.approx(150e-6)]]


def test_idle_time_over_the_spans_it_spans():
    """The gap [460, 800] opens in the emit and runs through the next
    wait, the next forward's issue and the request's own time after it."""
    events = serve_events()
    got = port_trace.idle_over_spans(events, summarise(events, 0.002)["gaps"])
    assert got == pytest.approx({
        trace.REQUEST: (10 + 80 + 10) * 1e-6,
        "vcd.feed.wait": (20 + 10 + 100 + 90) * 1e-6,
        "vcd.serve.forward": (50 + 20) * 1e-6,
        "vcd.serve.emit": 140e-6})


def test_span_device_seconds_follow_the_launch():
    """The forward's four launches, in both of its spans; the producer's
    copy launched during the first wait is not the wait's."""
    got = summarise(serve_events(), 0.002)["span_device_s"]
    assert got == pytest.approx({"vcd.serve.forward": (150 + 150 + 10 + 100)
                                 * 1e-6})
    assert trace.span_device_s(serve_events()) == got


def test_program_spans():
    spans = summarise(serve_events(), 0.002)["program_spans"]
    assert len(spans) == 7 and all(n.startswith("vcd.") for n, _, _ in spans)
    assert ("vcd.serve.result_wait", 210.0, 455.0) in spans


def serve_ctx(events=None):
    return {"kind": "serve", "slice_batches": 2,
            "slice": summarise(serve_events() if events is None else events,
                               0.002)}


def train_events():
    """One step: the preprocess span launches a kernel of 60 µs; one of 20
    µs launched after it is not the preprocess's."""
    return [
        span(trace.STEP, 0, 400),
        span("vcd.feed.wait", 0, 5),
        span("vcd.train.preprocess", 5, 50),
        launch(7, 10), device(7, 20, 80),
        launch(8, 60), device(8, 80, 100),
        span("vcd.train.forward", 55, 70),
        span("vcd.train.backward", 70, 100),
        span("vcd.train.optimizer", 100, 300),
    ]


def train_ctx(events=None):
    return {"kind": "train", "slice_steps": 1,
            "slice": summarise(train_events() if events is None else events,
                               0.0004)}


SPAN_METRICS = {  # metric → (its kind, what it reads on the synthetic slice)
    "feed_wait_ms.serve": ("serve", (90 + 100 + 110) / 2 * 1e-3),
    "forward_issue_ms.serve": ("serve", (100 + 20) / 2 * 1e-3),
    "emit_ms.serve": ("serve", (400 - 245) / 2 * 1e-3),
    "feed_wait_ms.train": ("train", 0.005),
    "preprocess_ms.train": ("train", 0.06),
    "optimizer_host_ms.train": ("train", 0.2),
}


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_metric_files(name):
    """Each metric file that reads the port's spans, on the synthetic slice
    of its kind: its hand-counted value; on the other kind's, and on a
    slice without the port's spans, nothing."""
    kind, want = SPAN_METRICS[name]
    read = harness.reader(name)
    ctx, other = (serve_ctx(), train_ctx()) if kind == "serve" else (
        train_ctx(), serve_ctx())
    assert read(ctx) == pytest.approx(want)
    assert read(other) is None
    bare = (serve_ctx if kind == "serve" else train_ctx)(without_port_spans(
        serve_events() if kind == "serve" else train_events()))
    assert read(bare) is None
    assert read({"kind": kind}) is None  # an untraced run


def test_serving_readings():
    got = port_trace.span_readings(serve_ctx()["slice"], "serve", units=2)
    assert got == pytest.approx({"result_wait_ms.serve": 245 / 2 * 1e-3})


def test_training_readings():
    got = port_trace.span_readings(train_ctx()["slice"], "train", units=1)
    assert got["vcd.train.preprocess_host_ms"] == pytest.approx(0.045)
    assert got["vcd.train.preprocess_device_ms"] == pytest.approx(0.06)
    assert got["vcd.train.forward_device_ms"] == pytest.approx(0.02)
    assert "preprocess_ms.train" not in got  # the metric file's reading


def test_port_record_of_a_serving_slice():
    events = serve_events()
    rec = {"kind": "serve", "slice_batches": 2,
           "slice": summarise(events, 0.002), "window_s": 0.5, "batches": 250,
           "latencies_s": [0.0005, 0.0015],
           "slice_counters": {"device_feed.feeds": 1,
                              "device_feed.batches": 2,
                              "device_feed.next_ns": 3_000_000,
                              "device_feed.stage_ns": 5_000_000,
                              "device_feed.pin_allocs": 2,
                              "device_feed.pinned_bytes": 3 * 2 ** 20,
                              "K4.launches": 16}}
    got = port_trace.port_record(rec, events)
    assert got["traced_batch_ms"] == pytest.approx(1.0)
    assert got["window_batch_ms"] == pytest.approx(2.0)
    assert got["traced_request_mean_ms"] == pytest.approx(1.0)
    assert got["window_request_mean_ms"] == pytest.approx(1.0)
    assert got["idle_s"] == pytest.approx(530e-6)
    assert got["idle_by_start_s"]["vcd.serve.emit"] == pytest.approx(340e-6)
    assert got["idle_share_over_spans"]["vcd.serve.emit"] == pytest.approx(
        140 / 530)
    assert got["feed_slice"] == pytest.approx({
        "feed_stage_ms": 2.5, "feed_next_ms": 1.5, "pin_allocs": 2,
        "batches": 2, "feeds": 1, "feed_pinned_mib": 3.0})


@pytest.fixture
def feed(monkeypatch):
    """The program's feed counters set to known values."""
    from vision_collision_detection_tpu_torch.data import loader

    def set_counters(**values):
        for k in harness.COUNTERS["device_feed"][2]:
            monkeypatch.setattr(loader.device_feed, k, values.get(k, 0))

    return set_counters


def test_feed_metric_files(feed):
    feed(feeds=4, batches=10, stage_ns=25_000_000,
         pinned_bytes=12 * 2 ** 20)
    serve, train = {"kind": "serve"}, {"kind": "train"}
    read = harness.reader
    assert read("feed_stage_ms.serve")(serve) == pytest.approx(2.5)
    assert read("feed_pinned_mib.serve")(serve) == pytest.approx(3.0)
    assert read("feed_stage_ms.train")(train) == pytest.approx(2.5)
    # each reads its own kind of traffic only
    assert read("feed_stage_ms.serve")(train) is None
    assert read("feed_pinned_mib.serve")(train) is None
    assert read("feed_stage_ms.train")(serve) is None


def test_feed_metric_files_read_nothing_before_the_counters(feed, monkeypatch):
    """A program without the feed's counters (the parent of this reading):
    no number, and no error."""
    from vision_collision_detection_tpu_torch.data import loader

    feed(feeds=1, batches=1)
    monkeypatch.delattr(loader.device_feed, "stage_ns")
    assert harness.feed_counters() is None
    for name, kind in (("feed_stage_ms.serve", "serve"),
                       ("feed_pinned_mib.serve", "serve"),
                       ("feed_stage_ms.train", "train")):
        assert harness.reader(name)({"kind": kind}) is None


def test_the_feed_counters_are_counted_over_the_slice(feed):
    """``harness.counters`` holds the feed's counters beside the kernels',
    so the slice's counter deltas carry them."""
    from benchmark.architectures import convnext_gru

    c = {"architecture": "convnext_gru"}
    feed(batches=3, stage_ns=7)
    before = harness.counters(c)
    feed(batches=5, stage_ns=7, feeds=1)
    got = harness.counter_delta(before, harness.counters(c))
    assert got == {"device_feed.batches": 2, "device_feed.feeds": 1}
    assert not getattr(convnext_gru, "COUNTERS", {})
