"""The port's recorder (``genvc_tpu_torch.tracing``): off it records nothing
and each span is still a profiler annotation; on it records nesting, parents,
self time, threads, request ids and counters; and the spans and counters of
the streaming call, the batch loader and ``--profile`` read what the program
did, without changing it."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from genvc_tpu_torch import tracing, utils
from genvc_tpu_torch.data.loader import BatchLoader
from genvc_tpu_torch.decode.engine import SamplerConfig
from genvc_tpu_torch.inference import pipeline as tpipe

CPU = [ProfilerActivity.CPU]


@pytest.fixture
def recorder():
    tracing.reset()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.reset()


def _in_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()


def _sleep_span(name, seconds, req=None):
    with tracing.span(name, req):
        time.sleep(seconds)


def test_torch_tracing_off_records_nothing_and_spans_stay_profiler_events():
    tracing.reset()
    with profile(activities=CPU) as prof:
        with tracing.span("genvc.outer", 3):
            with tracing.span("genvc.inner"):
                torch.ones(8).sum()
            tracing.count("engine.steps", 4)
    assert tracing.snapshot() == {"spans": [], "counters": {}}
    names = [e.name for e in prof.events()]
    assert names.count("genvc.outer") == 1 and names.count("genvc.inner") == 1


def test_torch_tracing_records_nesting_self_time_threads_requests_and_counters(recorder):
    with tracing.span("genvc.outer", 7):
        time.sleep(0.002)
        with tracing.span("genvc.inner"):
            time.sleep(0.003)
        tracing.count("n", 2)
        _in_thread(lambda: (_sleep_span("genvc.worker", 0.001, req=1), tracing.count("n")))
    snap = tracing.snapshot()
    by = {s["name"]: s for s in snap["spans"]}
    outer, inner, worker = by["genvc.outer"], by["genvc.inner"], by["genvc.worker"]
    assert [s["name"] for s in snap["spans"]] == ["genvc.outer", "genvc.inner", "genvc.worker"]
    assert outer["parent"] is None and inner["parent"] == outer["id"]
    assert worker["parent"] is None            # another thread: not a child
    assert (outer["req"], inner["req"], worker["req"]) == (7, None, 1)
    assert outer["thread"] == inner["thread"] == threading.get_native_id() != worker["thread"]
    assert outer["start_ns"] < inner["start_ns"] < inner["end_ns"] < outer["end_ns"]
    assert outer["start_ns"] < worker["start_ns"] < worker["end_ns"] < outer["end_ns"]
    dur = {k: s["end_ns"] - s["start_ns"] for k, s in by.items()}
    assert outer["self_ns"] == dur["genvc.outer"] - dur["genvc.inner"] >= 2_000_000
    assert inner["self_ns"] == dur["genvc.inner"] >= 3_000_000
    assert snap["counters"] == {"n": 3}


def test_torch_tracing_reset_and_snapshot(recorder):
    tracing.count("a")
    with tracing.span("genvc.before"):
        pass
    with tracing.span("genvc.open"):
        first = tracing.snapshot()
        first["counters"]["a"] = 99                  # a copy
        first["spans"][0]["name"] = "changed"
        tracing.reset()
        tracing.count("b", 5)
    second = tracing.snapshot()
    assert [s["name"] for s in first["spans"]] == ["changed"]   # the open span is left out
    assert tracing.snapshot()["counters"] == {"b": 5}
    # a span that opened before the reset is gone with it
    assert second["spans"] == []
    tracing.disable()
    with tracing.span("genvc.after_disable"):
        tracing.count("b")
    assert tracing.snapshot() == second


@pytest.mark.parametrize("was_on", [False, True])
def test_torch_profile_trace_writes_the_recorders_counters(tmp_path, was_on):
    """``utils.profile_trace`` (the CLI's ``--profile DIR``): the spans are
    the trace's annotations, and ``counters.json`` holds what the counters
    gained in the block; the recorder is left as it was, nothing reset."""
    tracing.reset()
    if was_on:
        tracing.enable()
        tracing.count("engine.steps", 2)
        tracing.count("kernels.built.decode_attention")
    try:
        with utils.profile_trace(str(tmp_path)):
            with tracing.span("genvc.before"):
                tracing.count("engine.steps", 3)
            _in_thread(lambda: _sleep_span("genvc.worker", 0.002))
        assert tracing.enabled() == was_on
        with tracing.span("genvc.later"):
            tracing.count("engine.steps")
        snap = tracing.snapshot()
    finally:
        tracing.disable()
        tracing.reset()
    assert json.loads((tmp_path / "counters.json").read_text()) == {"engine.steps": 3}
    assert snap["counters"]["engine.steps"] == (6 if was_on else 3)
    assert [s["name"] for s in snap["spans"]] == (
        ["genvc.before", "genvc.worker", "genvc.later"] if was_on
        else ["genvc.before", "genvc.worker"])
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert "genvc.before" in {e["name"] for e in events if e.get("cat") == "user_annotation"}


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    from synthetic_bundle import write_bundle

    path = str(tmp_path_factory.mktemp("bundle") / "tiny_genvc.pth")
    write_bundle(path)
    p = tpipe.model_init(path, device="cpu")
    p.sampler = SamplerConfig(temperature=1.0, top_k=1, top_p=1.0, repetition_penalty=1.0,
                              do_sample=False)
    p.gen_cap_tokens_per_code = 1.0
    return p


def test_torch_streaming_spans_split_each_decode_and_count_its_steps(pipe):
    rng = np.random.default_rng(5)
    src = (rng.standard_normal((1, 16000 * 2)) * 0.1).astype(np.float32)
    ref = (rng.standard_normal((1, 24000 * 2)) * 0.1).astype(np.float32)
    off, _, _ = pipe.synthesize_streaming(src, ref, verbose=False)
    call = pipe._stream_calls
    tracing.reset()
    tracing.enable()
    try:
        on, _, _ = pipe.synthesize_streaming(src, ref, verbose=False)
    finally:
        tracing.disable()
    snap = tracing.snapshot()
    tracing.reset()
    np.testing.assert_array_equal(on, off)
    spans = snap["spans"]
    decodes = [s for s in spans if s["name"] == "genvc.decode"]
    assert decodes and all(s["req"] == call for s in spans)
    for d in decodes:
        kids = sorted(s["name"] for s in spans if s["parent"] == d["id"])
        assert kids == ["genvc.decode.enqueue", "genvc.decode.readback"]
    assert {s["name"] for s in spans} >= {"genvc.cond_latents", "genvc.prefill", "genvc.vocode"}
    assert snap["counters"] == {"engine.steps": pipe.last_timing["decode_steps"]}
    assert snap["counters"]["engine.steps"] > 0


class _Items:
    """Four items whose batches carry their indices and one draw of the
    batch's crop generator."""

    def __len__(self):
        return 4

    def collate(self, idx, rng):
        time.sleep(0.002)
        return {"idx": np.array(idx), "crop": np.array([rng.random()])}


def _two_epochs(loader):
    return [b for _ in range(2) for b in loader]


def test_torch_loader_spans_each_wait_with_its_batch(recorder):
    on = _two_epochs(BatchLoader(_Items(), batch_size=2, num_workers=2, seed=3))
    snap = tracing.snapshot()
    tracing.disable()
    off = _two_epochs(BatchLoader(_Items(), batch_size=2, num_workers=2, seed=3))
    assert len(on) == len(off) == 4
    for a, b in zip(on, off):
        assert all(np.array_equal(a[k], b[k]) for k in ("idx", "crop"))
    assert snap["counters"] == {}
    assert [s["name"] for s in snap["spans"]] == ["genvc.loader.wait"] * 4
    assert [s["req"] for s in snap["spans"]] == [0, 1, 0, 1]
    assert all(s["thread"] == threading.get_native_id() and s["parent"] is None
               for s in snap["spans"])
