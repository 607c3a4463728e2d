"""The comparison that decides ``correct`` for the DeepSeek-V3 cell, PR 14's
method (:mod:`perfbench.reference.check`) with the backbone of
:mod:`perfbench.reference.moonlight`.

For each sampled row (one caller's request) the reference recomputes, from
the seed's weights and the request's audio, every segment's content codes,
the speaker latents, the backbone's logits, latents and routing along the
tokens the program served (teacher forced), and the audio of the same
windows joined by the same crossfade. Compared, each against its limit:

* ``logit_gap``, ``audio_err``, ``latent_err``: as in ``check``;
* ``route_agree``: the share of (row, audio position, mixture layer) at
  which the program's six experts are the reference's, or differ only by a
  near tie: each expert the program chose scores within ``ROUTE_TIE`` of
  the reference's 6th best selection score (so its 6th and 7th lie within
  it too), a tie that bf16 round-off may break either way. ``route_ties``
  counts those, reported beside it.

The program's routing is what it chose at every position of each segment
(the prefill's valid columns, then each decode step), recorded by the
driver. As with the dVAE codes (``judged_codes``), the reference reads the
program's experts where they are such a near tie and its own elsewhere, so
a tie broken the other way does not move every later layer; a choice
outside the tie moves the reference off the program, and the logits and
audio show it. The control is the reference with its routed experts'
weights rounded to float8 e4m3 (a scale per output neuron), routing on its
own: its numbers read the tokens it puts first, the audio of its own
latents, and its routing against a reference that reads it the same way.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import check
from perfbench.reference import model as ref
from perfbench.reference import moonlight

# A near tie of the selection scores (sigmoid, in (0, 1) plus the bias):
# the program's bf16 hidden states drift a few % from float32 by the last
# layers, which moves a score by up to about 0.02. Readings of 12 seeds a
# tie (PERF.md, PR 18): at 0.01, 3 % of the last layer's sound choices fell
# outside and moved the logits (a sound logit_gap of 0.388 against the
# control's 0.465); at 0.02 a sound run's differing sets lay at most 0.0214
# under the 6th and at most one in 10^4 fell outside, the e4m3 control's up
# to 0.10; at 0.03 the control's routing agreed to 0.9994 and no limit kept
# room on both sides.
ROUTE_TIE = 0.02
# Set from the readings at ROUTE_TIE (perfbench/control.py on the H100, 12
# seeds at 8 s, perfbench/results/control_readings_moonlight.jsonl, and six
# runs of the cell): logit_gap, sound at most 0.062, the control at least
# 0.119; route_agree at least 0.9999 and at most 0.9912. audio_err does not
# separate them (0.0404 and 0.0443): its limit catches faults (leaving the
# selection bias out reads 0.52 to 0.65). latent_err is check.LIMITS's: the
# control leaves the float32 content path as it is.
LIMITS = {"logit_gap": 0.085, "audio_err": 0.085, "latent_err": check.LIMITS["latent_err"],
          "route_agree": 0.997}
HIGHER = ("route_agree",)


class Reference:
    """The reference over one seed's weights (the GPT family in any float
    type, upcast a block at a time) on one device."""

    def __init__(self, tree: dict, cfg: dict, g: dict, norms: torch.Tensor,
                 control: bool = False):
        self.p, self.cfg, self.g, self.norms = tree, cfg, g, norms
        self.expert_mm = moonlight.e4m3_rows if control else moonlight.f32_mm
        self.perceiver = moonlight.f32_tree(tree["gpt"]["perceiver"])

    @torch.no_grad()
    def request(self, src16k: np.ndarray, ref24k: np.ndarray, served: list[dict],
                judge_routes: bool = True) -> dict:
        """``served``: per segment the program's ``tokens``, ``codes`` and
        ``routes`` (per mixture layer, the experts at every position); with
        ``judge_routes`` the reference reads those routes at near ties.
        Returns per segment the codes, pre-quantization values, penalised
        logits, first tokens, emitted count, routing at the audio positions
        and every position's experts used, and the audio."""
        cfg, g, s = self.cfg, self.g, self.cfg["stream"]
        dev = self.norms.device
        out = {"codes": [], "z": [], "logits": [], "first": [], "n": [], "routing": [],
               "routes": []}
        chunks = []
        with ref.full_precision():
            cond = ref.speaker_latents({"perceiver": self.perceiver},
                                       torch.as_tensor(ref24k.reshape(-1), device=dev),
                                       cfg, self.norms)
            for r, ((seg, t_real), sv) in enumerate(zip(check.segments(src16k, cfg), served)):
                n = ref.n_codes(t_real, cfg["content_dvae"]["num_layers"])
                feats = ref.contentvec(self.p["contentvec"], torch.as_tensor(seg, device=dev),
                                       t_real, cfg["contentvec"]["heads"])
                z = ref.dvae_encode(self.p["content_dvae"], feats, ref.n_codes(t_real, 0))
                codes = ref.judged_codes(ref.dvae_dist(self.p["content_dvae"], z), z,
                                         sv["codes"])[:n]
                toks = np.asarray(sv["tokens"], np.int64)
                m = check.n_valid(toks, check.max_new(cfg, n), g["stop_audio_token"])
                if toks.size < m:
                    raise ValueError(f"segment {r}: {toks.size} tokens served, {m} emitted")
                lat, logits, routing = moonlight.gpt_forward(
                    self.p["gpt"], g, cond, codes, torch.as_tensor(toks[: m - 1], device=dev),
                    self.expert_mm, sv["routes"] if judge_routes else None, ROUTE_TIE)
                pen = ref.penalised(logits, torch.as_tensor(toks[:m], device=dev), g,
                                    cfg["sampler"]["repetition_penalty"])
                first = s["first_chunk_tokens"] if r == 0 else s["chunk_tokens"]
                for a, b in check.windows(m, first, s["chunk_tokens"]):
                    chunks.append(ref.vocode(self.p["hifigan"], cfg["hifigan"], lat[a:b])
                                  .float().cpu().numpy())
                out["codes"].append(codes.cpu().numpy())
                out["z"].append(z[:n].cpu().numpy())
                out["logits"].append(pen)
                out["first"].append(torch.argmax(pen, dim=-1).cpu().numpy())
                out["n"].append(m)
                out["routing"].append([(taken[-m:].cpu().numpy(), same[-m:].cpu().numpy(),
                                        below[-m:].cpu().numpy())
                                       for _, _, taken, same, below in routing])
                out["routes"].append([idx.cpu().numpy() for idx, *_ in routing])
        out["audio"] = ref.crossfade(chunks, s["crossfade"])
        return out


def route_counts(r: dict) -> dict:
    """The reference's judgement of the judged side's routes, over the audio
    positions of every segment of ``r``: taken (the same set or a near
    tie), near ties alone, positions x mixture layers; and taken per
    layer."""
    hits = ties = total = 0
    by_layer, below = None, []
    for layers in r["routing"]:
        taken = np.stack([t for t, _, _ in layers])            # (layers, positions)
        same = np.stack([s for _, s, _ in layers])
        hits += int(taken.sum())
        ties += int((taken & ~same).sum())
        total += taken.size
        by_layer = taken.sum(1) if by_layer is None else by_layer + taken.sum(1)
        below += [b[~s] for _, s, b in layers]
    return {"route_hits": hits, "route_ties": ties, "route_total": total,
            "route_hits_by_layer": by_layer, "route_below": np.concatenate(below)}


def program_numbers(r: dict, served: list[dict], audio: np.ndarray) -> dict:
    """One row's numbers for the program against the reference's ``r``
    (which read the program's routes)."""
    return {**check.program_numbers(r, served, audio), **route_counts(r)}


def control_numbers(r: dict, c: dict) -> dict:
    """The control's numbers: its codes, values, first tokens and audio
    ``c`` against the reference's ``r`` (which read the control's routes)."""
    return {**check.control_numbers(r, c), **route_counts(r)}


def served_as(c: dict, served: list[dict]) -> list[dict]:
    """``served`` with the routes the control ``c`` took."""
    return [{**sv, "routes": routes} for sv, routes in zip(served, c["routes"])]


def summarise(per_row: list[dict]) -> dict:
    out = check.summarise(per_row)
    total = sum(x.get("route_total", 0) for x in per_row)
    out["route_agree"] = (sum(x["route_hits"] for x in per_row) / total if total else -math.inf)
    out["route_ties"] = sum(x.get("route_ties", 0) for x in per_row)
    if total:
        layers = sum(x["route_hits_by_layer"] for x in per_row)
        out["route_agree_by_layer"] = [round(float(v), 4)
                                       for v in layers / (total / layers.size)]
        below = np.concatenate([x["route_below"] for x in per_row])
        out["route_below_q"] = ([round(float(q), 4) for q in
                                 np.quantile(below, [0.5, 0.9, 0.99, 1.0])] if below.size else [])
    return out


def verdict(numbers: dict, limits: dict = LIMITS) -> bool:
    def ok(k):
        v = numbers[k]
        return math.isfinite(v) and (v >= limits[k] if k in HIGHER else v <= limits[k])

    return all(ok(k) for k in limits)
