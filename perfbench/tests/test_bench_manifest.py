"""BENCHMARK.json and the files it names."""

import copy
import json
import os

from conftest import ROOT
from perfbench import manifest


def bench():
    return manifest.load(ROOT)


def test_manifest_is_valid_and_every_file_is_found():
    b = bench()
    assert manifest.validate(b) == []
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("perfbench/")
    for w in b["workloads"]:
        cell = manifest.cell(b, w["name"])
        assert cell["driver"] in ("stream", "serve", "train_gpt")
        for m in manifest.per_layer(b, w["name"]):
            assert callable(manifest.metric_reader(ROOT, m["name"]))


def test_names_and_units_use_the_allowed_characters():
    b = bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert all(manifest.NAME.match(n) for n in names)
    assert all(manifest.UNIT.match(m["unit"]) for m in b["end_to_end"] + b["per_layer"])
    bad = copy.deepcopy(b)
    bad["per_layer"][0]["unit"] = "tokens per second"
    bad["workloads"][0]["name"] = "a,b"
    problems = manifest.validate(bad)
    assert any("unit" in p for p in problems) and any("name" in p for p in problems)


def test_each_moves_names_an_end_to_end_metric_every_listed_cell_reports():
    b = bench()
    for m in b["per_layer"]:
        e2e = next(x for x in b["end_to_end"] if x["name"] == m["moves"])
        for w in m["workloads"]:
            assert manifest.reports(e2e, b, w)
    bad = copy.deepcopy(b)
    k1 = next(m for m in bad["per_layer"] if m["name"] == "kernel.k1_roofline.stream")
    k1["workloads"] = ["genvc-bf16.serve-poisson"]   # serve reports no audio_s_per_s
    assert any("does not report" in p for p in manifest.validate(bad))


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_metric():
    b = bench()
    for w in b["workloads"]:
        names = {m["name"] for m in manifest.end_to_end(b, w["name"])}
        assert "setup_s" in names and len(names) >= 2
        assert manifest.per_layer(b, w["name"])


def test_bounds_and_run_length_fit_the_check():
    b = bench()
    assert 1 <= b["run_seconds"] <= 51
    assert (b["run_seconds"] + 60) * (2 + 14 * 24) + 24 * 180 + 1200 <= 43200
    setup = next(m for m in b["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    assert len(json.dumps(b)) < 64 * 1024
