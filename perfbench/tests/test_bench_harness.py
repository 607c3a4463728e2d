"""The harness is driven by data: a cell, a traffic mix, a configuration and
a per-layer metric added as new files and new entries only are found and
run, with nothing of the harness edited."""

import contextlib
import json
import os
import shutil
import time
import types

import torch

from conftest import ROOT, tiny


@contextlib.contextmanager
def _untraced(out):
    """The traced region without a profiler: a trace with no events."""
    from perfbench import trace

    t0 = time.perf_counter()
    yield
    out.append(trace.Trace(types.SimpleNamespace(events=lambda: []), time.perf_counter() - t0))


def test_a_new_cell_mix_config_and_metric_run_from_files_alone(cpu_harness, monkeypatch,
                                                              tmp_path, capsys):
    from perfbench import manifest, run, trace

    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "results"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    pb = root / "perfbench"
    with open(pb / "configs" / "genvc-bf16.json") as f:
        cfg = tiny(json.load(f))
    cfg["name"] = "genvc-tiny"
    (pb / "configs" / "genvc-tiny.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "stream-short.json").write_text(json.dumps({
        "arrivals": "closed", "requests": 4,
        "src_seconds": {"dist": "uniform", "low": 1.0, "high": 2.0},
        "ref_seconds": {"dist": "fixed", "value": 3.0}}))
    (pb / "cells" / "genvc-tiny.stream-short.json").write_text(json.dumps({
        "driver": "stream", "warm_src_seconds": 1.0, "warm_ref_seconds": 3.0, "warm_calls": 1,
        "passes": 20, "trace_calls": 1, "trace_tries": 1, "check_requests": 2}))
    (pb / "metrics" / "calls.traced.py").write_text(
        '"""Calls in the traced region."""\n\n\ndef read(record):\n'
        '    return len(record["calls"])\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "genvc-tiny", "source": "https://github.com/caizexin/GenVC",
                             "file": "perfbench/configs/genvc-tiny.json", "reduced": [],
                             "why": "a test size"})
    bench["workloads"].append({"name": "genvc-tiny.stream-short", "config": "genvc-tiny",
                               "traffic": "stream-short", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "audio_s_per_s":
            m["workloads"].append("genvc-tiny.stream-short")
    bench["per_layer"].append({"name": "calls.traced", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "inference/pipeline.py",
                               "moves": "audio_s_per_s", "workloads": ["genvc-tiny.stream-short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert manifest.validate(bench) == []

    monkeypatch.chdir(root)
    monkeypatch.setattr(manifest, "DIR", str(pb))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    monkeypatch.setattr(run, "warm_profiler", lambda: None)
    monkeypatch.setattr(trace, "traced", _untraced)   # no profiler on the CPU here
    monkeypatch.setattr(trace.Trace, "whole", lambda self: True)
    for flag, key in ((0, "audio_s_per_s"), (1, "calls.traced")):
        assert run.main(["--workload", "genvc-tiny.stream-short", "--seed", "2147483999",
                         "--seconds", "2", "--trace", str(flag)]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["correct"] and key in out["metrics"]
    assert out["metrics"]["calls.traced"]["value"] == 1
