"""The comparison that decides ``correct`` for the voice-conversion cells.

For each sampled request the reference recomputes, from the seed's weights
and the request's audio, every segment's content codes, the speaker latents,
the GPT's logits and latents along the tokens the program served (teacher
forced), and the audio of the same windows joined by the same crossfade.
Two numbers are compared, each against its limit:

* ``logit_gap``: the widest gap by which a served token's penalised logit
  lies below the reference's best at that position;
* ``audio_err``: the largest relative L2 distance between a request's
  served audio and the reference's;
* ``latent_err``: the largest relative L2 distance between a segment's
  content-dVAE pre-quantization values (ContentVec, then the dVAE encoder)
  as the program computed them and the reference's.

The codes the reference reads are its own nearest ones, or the program's
where they lie within a tie of them (:func:`ref.judged_codes`), so float32
round-off on a near tie does not change the prompt. Beside the compared
numbers it reports the share of the program's codes that are not the codes
it read (``code_mismatch``: a wrong code changes the GPT's prompt, which the
logit gap reads) and how many distinct codes the sampled requests hold
(``distinct_codes``).

The control (:func:`control_numbers`) is the reference computed one
precision lower in each family: TF32 for the float32 ones, float8 e4m3
products for the bf16 GPT and Perceiver. Its numbers read the tokens it puts
first and the audio of its own latents.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import model as ref

# Set from the readings of perfbench/control.py on the H100 (12 seeds of the
# stream cell with its codebook placed, perfbench/results/control_readings.jsonl):
# logit_gap, sound runs at most 0.0231, the control at least 0.194;
# audio_err 0.0168 and 0.0598; latent_err 1.78e-6 and 9.00e-4.
LIMITS = {"logit_gap": 0.08, "audio_err": 0.035, "latent_err": 3e-5}


def max_new(cfg: dict, n: int) -> int:
    g, s = cfg["gpt"], cfg["stream"]
    cap = max(8, int(n * s["gen_cap_tokens_per_code"]))
    return min(g["max_mel_tokens"] - 3, int(math.ceil(cap / 16) * 16))


def segments(src16k: np.ndarray, cfg: dict):
    """(padded segment, true length) of each 6 s piece of the source; the
    last counts as at least 0.32 s."""
    seg = int(cfg["stream"]["segment_seconds"] * 16000)
    x = src16k.reshape(-1)
    for i in range(0, x.size, seg):
        piece = x[i: i + seg]
        yield np.pad(piece, (0, seg - piece.size)), max(piece.size, int(0.32 * 16000))


def n_valid(tokens: np.ndarray, cap: int, stop: int) -> int:
    """Latents a segment emits: up to the first stop token, at most ``cap``."""
    hit = np.flatnonzero(tokens[:cap] == stop)
    return int(hit[0]) + 1 if hit.size else cap


def windows(n: int, first: int, step: int):
    """[start, end) of each vocoder window of a segment of ``n`` latents."""
    out, start, w = [], 0, first
    while start < n:
        out.append((start, min(start + w, n)))
        start, w = start + w, step
    return out


class Reference:
    """The reference over one seed's weights on one device."""

    def __init__(self, tree: dict, cfg: dict, norms: torch.Tensor, control: bool = False):
        self.p, self.cfg, self.norms = tree, cfg, norms
        self.mm = ref.e4m3_mm if control else ref.f32_mm
        self.tf32 = control

    @torch.no_grad()
    def request(self, src16k: np.ndarray, ref24k: np.ndarray, served: list[dict]) -> dict:
        """``served``: per segment the program's ``tokens`` (at least as many
        as it emitted) and ``codes``. Returns per segment the codes, the
        penalised logits, the tokens read (served, or the control's first),
        and the joined audio."""
        cfg, g, s = self.cfg, self.cfg["gpt"], self.cfg["stream"]
        dev = self.norms.device
        out = {"codes": [], "z": [], "logits": [], "first": [], "n": []}
        chunks = []
        with ref.full_precision(self.tf32):
            cond = ref.speaker_latents(self.p["gpt"], torch.as_tensor(ref24k.reshape(-1),
                                                                      device=dev),
                                       cfg, self.norms, self.mm)
            for r, ((seg, t_real), sv) in enumerate(zip(segments(src16k, cfg), served)):
                n = ref.n_codes(t_real, cfg["content_dvae"]["num_layers"])
                feats = ref.contentvec(self.p["contentvec"], torch.as_tensor(seg, device=dev),
                                       t_real, cfg["contentvec"]["heads"])
                frames = ref.n_codes(t_real, 0)
                z = ref.dvae_encode(self.p["content_dvae"], feats, frames)
                codes = ref.judged_codes(ref.dvae_dist(self.p["content_dvae"], z), z,
                                         None if self.tf32 else sv["codes"])[:n]
                toks = np.asarray(sv["tokens"], np.int64)
                m = n_valid(toks, max_new(cfg, n), g["stop_audio_token"])
                if toks.size < m:
                    raise ValueError(f"segment {r}: {toks.size} tokens served, {m} emitted")
                audio_in = torch.as_tensor(toks[: m - 1], device=dev)
                lat, logits = ref.gpt_forward(self.p["gpt"], g, cond, codes, audio_in, self.mm)
                pen = ref.penalised(logits, torch.as_tensor(toks[:m], device=dev), g,
                                    cfg["sampler"]["repetition_penalty"])
                first = s["first_chunk_tokens"] if r == 0 else s["chunk_tokens"]
                for a, b in windows(m, first, s["chunk_tokens"]):
                    chunks.append(ref.vocode(self.p["hifigan"], cfg["hifigan"], lat[a:b])
                                  .float().cpu().numpy())
                out["codes"].append(codes.cpu().numpy())
                out["z"].append(z[:n].cpu().numpy())
                out["logits"].append(pen)
                out["first"].append(torch.argmax(pen, dim=-1).cpu().numpy())
                out["n"].append(m)
        out["audio"] = ref.crossfade(chunks, s["crossfade"])
        return out


def gap(pen: torch.Tensor, tokens: np.ndarray) -> float:
    """Widest gap of ``tokens`` below the best of the penalised logits."""
    t = torch.as_tensor(tokens[: pen.shape[0]], device=pen.device)
    return float((pen.max(dim=-1).values - pen.gather(1, t[:, None])[:, 0]).max())


def rel_err(a: np.ndarray, b: np.ndarray) -> float:
    if a.shape != b.shape:
        return math.inf
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _codes(r: dict, codes: list) -> dict:
    """The code counts of one request: ``codes`` (per segment) against the
    codes the reference read."""
    miss = tot = 0
    for want, got in zip(r["codes"], codes):
        got = np.asarray(got).reshape(-1)[: want.size]
        miss += int((got != want).sum()) + want.size - got.size
        tot += want.size
    return {"code_miss": miss, "code_total": tot,
            "code_set": set(np.concatenate(r["codes"]).tolist())}


def program_numbers(r: dict, served: list[dict], audio: np.ndarray) -> dict:
    """One request's numbers for the program: its codes, pre-quantization
    values, tokens and audio against the reference's ``r``."""
    g = max(gap(pen, np.asarray(sv["tokens"])[:m])
            for pen, sv, m in zip(r["logits"], served, r["n"]))
    zerr = max(rel_err(np.asarray(sv["z"], np.float32).reshape(-1, z.shape[-1])[: z.shape[0]], z)
               for z, sv in zip(r["z"], served))
    return {**_codes(r, [sv["codes"] for sv in served]), "logit_gap": g, "latent_err": zerr,
            "audio_err": rel_err(np.asarray(audio, np.float32), r["audio"])}


def control_numbers(r: dict, c: dict) -> dict:
    """The control's numbers: its codes, pre-quantization values, first
    tokens and audio ``c`` read against the reference's ``r``."""
    g = max(gap(pen, first) for pen, first in zip(r["logits"], c["first"]))
    zerr = max(rel_err(a, b) for a, b in zip(c["z"], r["z"]))
    return {**_codes(r, c["codes"]), "logit_gap": g, "latent_err": zerr,
            "audio_err": rel_err(c["audio"], r["audio"])}


def summarise(per_request: list[dict]) -> dict:
    """The cell's numbers over its sampled requests (none judged: every
    compared number infinite, so not correct)."""
    if not per_request:
        return {"code_mismatch": math.inf, "distinct_codes": 0, "logit_gap": math.inf,
                "audio_err": math.inf, "latent_err": math.inf}
    tot = sum(x["code_total"] for x in per_request)
    return {"code_mismatch": sum(x["code_miss"] for x in per_request) / max(tot, 1),
            "distinct_codes": len(set().union(*(x["code_set"] for x in per_request))),
            "logit_gap": max(x["logit_gap"] for x in per_request),
            "audio_err": max(x["audio_err"] for x in per_request),
            "latent_err": max(x["latent_err"] for x in per_request)}


def verdict(numbers: dict, limits: dict = LIMITS) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
