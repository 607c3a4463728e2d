"""What the voice-conversion drivers share: inputs, weights, the check."""

from __future__ import annotations

import os
import statistics
import sys
import time

import numpy as np
import torch

from perfbench import audio, codebooks, traffic, weights
from perfbench.reference import check

ROOT = os.getcwd()
DEVICE = "cuda"


def inputs(req: traffic.Request) -> tuple[np.ndarray, np.ndarray]:
    """(16 kHz source (1, n), 24 kHz reference (1, n)) of a request."""
    return (audio.clip(ROOT, 16000, req.src_seconds, req.src_which, req.src_offset),
            audio.clip(ROOT, 24000, req.ref_seconds, req.ref_which, req.ref_offset))


# The stop token's bias in the audio head: random weights would emit it on
# some seeds and not others, so the work of a run would depend on the seed;
# with it every stream generates to the cap, the trained length.
NO_STOP_BIAS = -8192.0


def draw_tree(cfg: dict, seed: int) -> dict:
    """The inference weights of ``seed``, codebooks placed."""
    tree = codebooks.fill(weights.draw(weights.inference_spec(cfg), seed, DEVICE), cfg, seed, ROOT)
    tree["gpt"]["mel_head"]["b"][cfg["gpt"]["stop_audio_token"]] = NO_STOP_BIAS
    return tree


def draw_training(cfg: dict, seed: int) -> dict:
    """The GPT stage's trees of ``seed``, codebooks placed."""
    return codebooks.fill(weights.draw(weights.training_spec(cfg), seed, DEVICE), cfg, seed, ROOT)


def mel_norms(cfg: dict) -> torch.Tensor:
    return torch.as_tensor(np.load(os.path.join(ROOT, cfg["style_mel"]["norms_file"])),
                           dtype=torch.float32, device=DEVICE)


def sample(done: list, k: int, seed: int) -> list:
    """``k`` of ``done`` (items with ``src_s``) drawn from the seed, the
    longest always among them."""
    if len(done) <= k:
        return list(done)
    longest = max(range(len(done)), key=lambda i: done[i]["src_s"])
    rest = [i for i in range(len(done)) if i != longest]
    pick = traffic.rng(seed, 7).choice(len(rest), size=k - 1, replace=False)
    return [done[longest]] + [done[rest[i]] for i in sorted(pick)]


def judge(cfg: dict, seed: int, picked: list, control: bool = False) -> dict:
    """The compared numbers over ``picked`` requests (each with ``src``,
    ``ref``, ``served`` and ``audio``), from a fresh draw of the weights.
    With ``control`` also the control's numbers."""
    tree = draw_tree(cfg, seed)
    norms = mel_norms(cfg)
    r_ref = check.Reference(tree, cfg, norms)
    r_ctl = check.Reference(tree, cfg, norms, control=True) if control else None
    prog, ctl = [], []
    for p in picked:
        r = r_ref.request(p["src"], p["ref"], p["served"])
        prog.append(check.program_numbers(r, p["served"], p["audio"]))
        if r_ctl is not None:
            ctl.append(check.control_numbers(r, r_ctl.request(p["src"], p["ref"], p["served"])))
    del tree
    out = {"program": check.summarise(prog)}
    if ctl:
        out["control"] = check.summarise(ctl)
    return out


def quantile(values: list[float], q: int) -> float:
    """The q-th percentile (10 <= q < 100 in steps of 10 or 5), inclusive."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def note(msg: str):
    print(msg, file=sys.stderr, flush=True)


def now() -> float:
    return time.perf_counter()
