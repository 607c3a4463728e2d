"""The readers of the program's own spans (``genvc_tpu_torch.tracing``, read
as the profiler's copies): each on a hand-made trace with known spans, and
None, without raising, on a program that has no such spans."""

import types

import pytest
import torch

from conftest import ROOT
from perfbench import manifest, trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
NEW = ("engine.enqueue_ms.stream", "engine.readback_ms.stream", "loader.wait_ms.train",
       "device.loader_idle_share.train")


def ev(name, start, end, dev=CUDA):
    return types.SimpleNamespace(name=name, device_type=dev,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def a_trace(events, wall_s=0.01):
    return trace.Trace(types.SimpleNamespace(events=lambda: events), wall_s=wall_s)


def read(name, record):
    return manifest.metric_reader(ROOT, name)(record)


def test_the_new_metrics_are_in_the_manifest_with_their_cells():
    bench = manifest.load(ROOT)
    assert manifest.validate(bench) == []
    cells = {"stream": "genvc-bf16.stream", "train": "genvc-train-f32.gpt-b24"}
    for name in NEW:
        (m,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert m["workloads"] == [cells[name.rsplit(".", 1)[1]]]
        assert m in manifest.per_layer(bench, m["workloads"][0])
    # appended after every metric the benchmark had
    assert [m["name"] for m in bench["per_layer"][-len(NEW):]] == list(NEW)


def stream_record(events):
    return {"trace": a_trace(events), "calls": [{"decode_steps": 3}, {"decode_steps": 5}]}


def test_the_decode_split_per_step():
    # two windows: enqueue 6 + 10 ms, readback 2 + 6 ms, over 8 steps
    rec = stream_record([
        ev("genvc.decode", 0, 9000, CPU), ev("genvc.decode.enqueue", 0, 6000, CPU),
        ev("genvc.decode.readback", 6000, 8000, CPU),
        ev("genvc.decode", 10000, 27000, CPU), ev("genvc.decode.enqueue", 10000, 20000, CPU),
        ev("genvc.decode.readback", 20000, 26000, CPU), ev("k", 100, 200)])
    assert read("engine.enqueue_ms.stream", rec) == pytest.approx(16.0 / 8)
    assert read("engine.readback_ms.stream", rec) == pytest.approx(8.0 / 8)
    assert read("engine.step_ms.stream", rec) == pytest.approx(26.0 / 8)


def train_record(events, steps=2):
    return {"trace": a_trace(events), "steps": [{}] * steps}


def test_the_loader_wait_and_the_idle_it_leaves():
    # region 0-20 ms: waits 0-4 and 10-12 ms; kernels 5-9 and 13-18 (busy 9)
    # idle: 0-5 (4 of it in a wait), 9-13 (2 in a wait), 18-20; 11 ms in all
    rec = train_record([
        ev("genvc.loader.wait", 0, 4000, CPU), ev("genvc.features", 4500, 9000, CPU),
        ev("genvc.loader.wait", 10000, 12000, CPU), ev("genvc.optimizer", 19000, 20000, CPU),
        ev("sgemm", 5000, 8000), ev("sgemm", 7000, 9000), ev("flash", 13000, 18000)])
    assert read("loader.wait_ms.train", rec) == pytest.approx(6.0 / 2)
    assert read("device.loader_idle_share.train", rec) == pytest.approx(100.0 * 6 / 11)


def test_a_program_without_the_spans_reads_none():
    old = [ev("genvc.decode", 0, 9000, CPU), ev("genvc.features", 0, 9000, CPU),
           ev("k", 100, 200)]
    for name in NEW[:2]:
        assert read(name, stream_record(old)) is None
    for name in NEW[2:]:
        assert read(name, train_record(old)) is None
    # no kernel in the region: no idle share to divide
    assert read("device.loader_idle_share.train",
                train_record([ev("genvc.loader.wait", 0, 10, CPU)])) is None
