"""The comparison that decides ``correct`` for the GPT training cell.

The reference follows the program's first steps from the seed's weights on
the same batches (the loader's raw waveforms) and compares:

* ``grad_gap``: over the GPT's leaves, the largest gap between the norms of
  the first gradient as the optimizer took it, over the larger of the
  reference leaf's norm and the median leaf's;
* ``change_gap``: the same for the parameters' change after the last
  checked step. Leaves whose reference gradient is under a thousandth of
  the median leaf's (moved by weight decay and round-off alone, such as the
  Perceiver under ``fix_condition_embeddings``) are left out of it;
* ``latent_err``: the largest relative L2 distance between a checked
  batch's pre-quantization values of either dVAE (the acoustic one over the
  mel, the content one over ContentVec) as the program computed them and
  the reference's.

The reference reads its own nearest codes, or the program's where they lie
within a tie of them (:func:`ref.judged_codes`), so float32 round-off on a
near tie does not move its loss. The largest relative gap between the
steps' losses (``loss_gap``), the share of the program's codes that are not
the codes the reference read (``code_mismatch``) and the fewest distinct
codes of a checked batch (``distinct_audio_codes``, ``distinct_text_codes``)
are reported beside the compared numbers.

The control is the reference one precision lower in each family: TF32 for
float32 work (with TF32 off in the configuration), float8 e4m3 products
below a bf16 GPT; it reads its own codes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.drivers import common
from perfbench.reference import model as ref
from perfbench.reference import train as rt

# Set from perfbench/control.py on the H100 (12 seeds, the f32 cell with its
# codebooks placed, perfbench/results/control_readings.jsonl): grad_gap,
# sound runs at most 1.32e-7, the TF32 control at least 3.66e-3, half of
# each batch left out 0.116; change_gap 2.26e-6, 9.03e-3 and 0.0516;
# latent_err 1.85e-6 and 8.92e-4.
LIMITS = {"grad_gap": 2e-6, "change_gap": 6e-5, "latent_err": 3e-5}


def _norms(vals: dict) -> dict:
    return {n: float(v.double().norm()) for n, v in vals.items()}


def _leaf_gaps(prog: dict, refn: dict, names) -> dict:
    med = float(np.median([refn[n] for n in names]))
    return {n: abs(prog[n] - refn[n]) / max(refn[n], med, 1e-30) for n in names}


def _leaf_gap(prog: dict, refn: dict, names) -> float:
    gaps = _leaf_gaps(prog, refn, names)
    worst = sorted(gaps, key=gaps.get, reverse=True)[:3]
    common.note("worst leaves: " + ", ".join(
        f"{n} {gaps[n]:.4g} (norms {prog[n]:.4g} vs {refn[n]:.4g})" for n in worst))
    return max(gaps.values())


def follow(cfg: dict, seed: int, batches: list, rows: int, control: bool = False,
           half: bool = False, codes: list | None = None) -> dict:
    """The reference (or the control) through the checked steps, reading
    ``codes`` (the program's, per step) where they lie within a tie; ``half``
    plants a fault in it: half of each batch left out, the mean taken over
    the rest."""
    trees = common.draw_training(cfg, seed)
    norms = common.mel_norms(cfg)
    init = dict(rt.leaves(trees["gpt"]))
    init = {n: t.detach().clone() for n, t in init.items()}
    # the control: e4m3 products below a bf16 GPT, TF32 below float32
    mm = ref.e4m3_mm if control and cfg["gpt"]["dtype"] == "bfloat16" else ref.f32_mm
    trainer = rt.Trainer(trees["gpt"], cfg, mm, rows)
    losses, read, latents, grad1 = [], [], [], None
    for i, batch in enumerate(batches):
        with ref.full_precision(control):
            with torch.no_grad():
                feats = rt.tokenize(trees, cfg, norms, batch,
                                    None if codes is None else codes[i])
            latents.append({"audio": feats.pop("audio_z").cpu(),
                            "text": feats.pop("text_z").cpu()})
            if half:
                n = feats["text_lengths"].shape[0] // 2
                feats = {k: v[:n] for k, v in feats.items()}
            loss, grads = trainer.loss_and_grads(feats)
        clipped = trainer.update(grads)
        losses.append(loss)
        read.append({"audio": feats["audio_codes"].cpu(), "text": feats["text_inputs"].cpu()})
        if i == 0:
            grad1 = _norms(clipped)
            grad1_raw = _norms(grads)
    change = _norms({n: t.detach() - init[n] for n, t in trainer.named})
    del trainer, trees
    return {"losses": losses, "codes": read, "latents": latents, "grad1": grad1,
            "grad1_raw": grad1_raw, "change": change, "init": init}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        return math.inf
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def numbers(got: dict, r: dict) -> dict:
    """``got``: losses, codes, pre-quantization values, the first
    gradient's and the change's norms by leaf; ``r`` the reference's."""
    miss = tot = 0
    for a, b in zip(got["codes"], r["codes"]):
        for k in ("audio", "text"):
            rows, n = min(a[k].shape[0], b[k].shape[0]), min(a[k].shape[1], b[k].shape[1])
            miss += int((a[k][:rows, :n] != b[k][:rows, :n]).sum()) + (b[k].shape[0] - rows) * n
            tot += b[k].shape[0] * n
    zerr = max(_rel(a[k], b[k]) for a, b in zip(got["latents"], r["latents"])
               for k in ("audio", "text"))
    names = list(r["grad1"])
    med = float(np.median([r["grad1_raw"][n] for n in names]))
    moved = [n for n in names if r["grad1_raw"][n] >= 1e-3 * med]
    return {"code_mismatch": miss / max(tot, 1),
            "distinct_audio_codes": min(int(c["audio"].unique().numel()) for c in r["codes"]),
            "distinct_text_codes": min(int(c["text"].unique().numel()) for c in r["codes"]),
            "latent_err": zerr,
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], r["losses"])),
            "grad_gap": _leaf_gap(got["grad1"], r["grad1"], names),
            "change_gap": _leaf_gap(got["change"], r["change"], moved)}


def judge(cfg: dict, seed: int, batches: list, prog: dict, rows: int,
          control: bool = False) -> dict:
    """The program's numbers; with ``control`` also the control's and those
    of the reference with half of each batch left out."""
    r = follow(cfg, seed, batches, rows, codes=prog["codes"])
    init = {n: t.cpu() for n, t in r.pop("init").items()}
    sizes = prog["sizes"]
    g1 = dict(zip(prog["names"], torch.split(prog["grad1"], sizes)))
    after = dict(zip(prog["names"], torch.split(prog["flat_after"], sizes)))
    got = {"losses": prog["losses"], "codes": prog["codes"], "latents": prog["latents"],
           "grad1": _norms(g1),
           "change": _norms({n: after[n] - init[n].reshape(-1) for n in after})}
    out = {"program": numbers(got, r)}
    if control:
        c = follow(cfg, seed, batches, rows, control=True)
        c.pop("init")
        out["control"] = numbers(c, r)
        h = follow(cfg, seed, batches, rows, half=True, codes=prog["codes"])
        h.pop("init")
        out["half_batch"] = numbers(h, r)
    return out


def verdict(nums: dict, limits: dict = LIMITS) -> bool:
    return all(math.isfinite(nums[k]) and nums[k] <= limits[k] for k in limits)
