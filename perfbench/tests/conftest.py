"""The benchmark's own tests, on the CPU at a tiny size: no JAX, no card
(the ``cuda``-marked ones skip inside the test without one)."""

import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


def tiny(cfg: dict) -> dict:
    """The configuration at a size the CPU runs in seconds: every family's
    structure kept, its widths and depths cut."""
    cfg = copy.deepcopy(cfg)
    cfg["gpt"].update(layers=2, model_dim=64, head_dim=16)
    cfg["contentvec"]["layers"] = 2
    cfg["content_dvae"].update(num_tokens=64, codebook_dim=32, hidden_dim=32, num_resnet_blocks=1)
    cfg["hifigan"].update(input_feat_dim=64, upsample_initial_channel=32)
    if "server" in cfg:
        cfg["server"]["slots"] = 4
    return cfg


@pytest.fixture
def flagship():
    with open(os.path.join(ROOT, "perfbench", "configs", "genvc-bf16.json")) as f:
        return json.load(f)


@pytest.fixture
def cpu_harness(monkeypatch):
    """The drivers on the CPU: the card's calls stubbed, the device 'cpu'."""
    import torch

    from perfbench.drivers import common

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    monkeypatch.setattr(common, "DEVICE", "cpu")
    monkeypatch.setattr(common, "ROOT", ROOT)
    return common


# Cells whose files the benchmark keeps for a later PR, though
# BENCHMARK.json does not list them (PERF.md, Open questions).
KEPT = [{"name": "genvc-bf16.serve-poisson", "config": "genvc-bf16", "traffic": "serve-poisson",
         "chips": 1, "why": "kept for a later benchmark PR"}]


def run_cell(name: str, seconds: float, seed: int = 2 ** 31 + 77, root: str = ROOT,
             **cell_updates) -> dict:
    """The cell's driver at the tiny size on the CPU (``cpu_harness`` on)."""
    import argparse
    import importlib

    from perfbench import manifest

    bench = manifest.load(root)
    bench["workloads"] += [w for w in KEPT if w["name"] == name]
    cell = manifest.cell(bench, name)
    cell["config"] = tiny(cell["config"])
    cell.update(cell_updates)
    drv = importlib.import_module(f"perfbench.drivers.{cell['driver']}")
    args = argparse.Namespace(seed=seed, seconds=seconds, trace=0)
    return drv.run(cell, args, 0.0)
