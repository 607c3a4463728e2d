"""``BENCHMARK.json`` and the files it names, found by name and checked."""

from __future__ import annotations

import importlib.util
import json
import os
import re

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DIR = os.path.dirname(os.path.abspath(__file__))


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    problems = validate(bench)
    if problems:
        raise ValueError("BENCHMARK.json: " + "; ".join(problems))
    return bench


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    """The cell ``name``: its entry, its cell file, configuration and mix."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    out = dict(_json(os.path.join(DIR, "cells", f"{name}.json")))
    out.update(name=name, chips=entry["chips"], config=_json(conf["file"]),
               traffic=_json(os.path.join(DIR, "traffic", f"{entry['traffic']}.json")))
    return out


def reports(metric: dict, bench: dict, workload: str) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    e2e = next(m for m in bench["end_to_end"] if m["name"] == moves)
    return "workloads" not in e2e or workload in e2e["workloads"]


def end_to_end(bench: dict, workload: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if reports(m, bench, workload)]


def per_layer(bench: dict, workload: str) -> list[dict]:
    return [m for m in bench["per_layer"] if reports(m, bench, workload)]


def metric_reader(root: str, name: str):
    """``read(record)`` of ``perfbench/metrics/<name>.py``."""
    path = os.path.join(DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def validate(bench: dict) -> list[str]:
    """Every rule of the manifest that a file can break on its own."""
    p = []
    keys = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    if set(bench) != keys:
        p.append(f"keys {sorted(bench)}")
        return p
    names = ([c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    for n in names + [w["config"] for w in bench["workloads"]] + [w["traffic"] for w in bench["workloads"]]:
        if not NAME.match(n):
            p.append(f"name {n!r}")
    for group in ("configs", "workloads"):
        ns = [x["name"] for x in bench[group]]
        if len(ns) != len(set(ns)):
            p.append(f"duplicate {group} names")
    ms = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    if len(ms) != len(set(ms)):
        p.append("duplicate metric names")
    for text in ([c[k] for c in bench["configs"] for k in ("why", "source")]
                 + [w["why"] for w in bench["workloads"]] + [m["layer"] for m in bench["per_layer"]]
                 + list(bench["command"])):
        if not 1 <= len(text) <= 200 or "\n" in text or "\t" in text:
            p.append(f"text {text[:40]!r}")
    for c in bench["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            p.append(f"config {c['name']} keys")
        for k in c["reduced"]:
            if not NAME.match(k):
                p.append(f"reduced key {k!r}")
    cfgs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            p.append(f"workload {w['name']} keys")
        if w["config"] not in cfgs:
            p.append(f"workload {w['name']}: no config {w['config']!r}")
        if w["chips"] not in (1, 4):
            p.append(f"workload {w['name']}: chips {w['chips']}")
        pair = (w["config"], w["traffic"])
        if pair in pairs:
            p.append(f"workload {w['name']}: pair repeated")
        pairs.add(pair)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    if "setup_s" not in e2e:
        p.append("no setup_s")
    wl = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not UNIT.match(m["unit"]):
            p.append(f"unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            p.append(f"{m['name']}: better")
        for w in m.get("workloads", []):
            if w not in wl:
                p.append(f"{m['name']}: no workload {w!r}")
    for m in bench["end_to_end"]:
        extra = set(m) - {"name", "unit", "better", "bound", "source", "workloads"}
        if extra or m["source"] not in ("host_clock", "device_trace"):
            p.append(f"{m['name']}: keys or source")
        if not 0.01 <= m["bound"] <= 0.25:
            p.append(f"{m['name']}: bound {m['bound']}")
    for m in bench["per_layer"]:
        extra = set(m) - {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if extra or m["source"] not in ("device_trace", "program_span", "program_counter",
                                        "host_clock"):
            p.append(f"{m['name']}: keys or source")
        if m["moves"] not in e2e:
            p.append(f"{m['name']}: moves {m['moves']!r}")
            continue
        for w in m.get("workloads", sorted(wl)):
            if not reports(e2e[m["moves"]], bench, w):
                p.append(f"{m['name']}: {w} does not report {m['moves']}")
    for w in wl:
        if not any(reports(m, bench, w) for m in bench["per_layer"]):
            p.append(f"{w}: no per-layer metric")
        if len(end_to_end(bench, w)) < 2:
            p.append(f"{w}: no end-to-end metric besides setup_s")
    return p
