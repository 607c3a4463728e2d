"""Accounting that the per-layer readers share: the work a traced region
did, from the driver's records and the configuration's shapes."""

from __future__ import annotations

import numpy as np

from perfbench import flops
from perfbench.reference import check


def _tokens(seg: dict) -> int:
    return sum(int(p.numel()) for p in seg["parts"]) if "parts" in seg else seg["tokens"].size


def _host_tokens(seg: dict) -> np.ndarray:
    if "tokens" in seg:
        return seg["tokens"]
    return np.concatenate([p.reshape(-1).cpu().numpy() for p in seg["parts"]])


def prefix_keys(cfg: dict, n: int) -> int:
    """Valid keys of a segment's prefix: speaker latents, start, codes, stop."""
    return cfg["perceiver"]["latents"] + n + 2


def stream_decode_steps(record: dict) -> int:
    return sum(c["decode_steps"] for c in record["calls"])


def stream_k1_bound_s(record: dict) -> float:
    """Least time of every K1 call the traced calls made: per decode step,
    one call per layer over the keys written so far."""
    cfg = record["cfg"]
    layers = cfg["gpt"]["layers"]
    total = 0.0
    for c in record["calls"]:
        for seg in c["served"]:
            keys = prefix_keys(cfg, seg["n"])
            for j in range(1, _tokens(seg)):
                total += layers * flops.decode_attention_bound_s(cfg, [keys + 1 + j])
    return total


def stream_peak_seconds(record: dict) -> float:
    """The traced calls' model FLOPs at the card's peaks, in seconds."""
    cfg = record["cfg"]
    s = cfg["stream"]
    body = f32 = 0.0
    for c in record["calls"]:
        f32 += flops.speaker_flops(cfg, c["ref_samples"])
        for r, ((_, t_real), seg) in enumerate(zip(check.segments(c["src"], cfg), c["served"])):
            f32 += flops.content_flops(cfg, t_real)
            m = check.n_valid(_host_tokens(seg), check.max_new(cfg, seg["n"]),
                              cfg["gpt"]["stop_audio_token"])
            b, h = flops.gpt_segment_flops(cfg, prefix_keys(cfg, seg["n"]), m)
            body, f32 = body + b, f32 + h
            first = s["first_chunk_tokens"] if r == 0 else s["chunk_tokens"]
            for a, e in check.windows(m, first, s["chunk_tokens"]):
                f32 += flops.vocoder_flops(cfg, e - a)
    return flops.seconds_at_peak(cfg, flops._by_type({cfg["gpt"]["dtype"]: body},
                                                    {"float32": f32}))


def serve_k3_bound_s(record: dict) -> float:
    """Least time of every K3 call dispatched in the traced region: each
    tick's steps over the pool (occupied rows at their depths, idle rows
    moving their query and output only), and each admission's first-window
    steps over its rows."""
    cfg = record["cfg"]
    layers, slots = cfg["gpt"]["layers"], cfg["server"]["slots"]
    step = cfg["stream"]["chunk_tokens"]
    total = 0.0
    for _, rows in record["dispatches"]:
        for j in range(1, step + 1):
            keys = [k + d + j for k, d in rows] + [0] * (slots - len(rows))
            total += layers * flops.decode_attention_bound_s(cfg, keys, write=True)
    for _, rows, fast in record["admissions"]:
        for j in range(1, fast + 1):
            keys = [k + 1 + j for _, _, k in rows]
            total += layers * flops.decode_attention_bound_s(cfg, keys, write=True)
    return total


def serve_peak_seconds(record: dict) -> float:
    """Model FLOPs of the traced region at the card's peaks, in seconds: the
    speaker latents of each submission, each admission's content codes,
    prefill and first window, and each tick's decode steps and windows over
    its occupied rows."""
    cfg = record["cfg"]
    step = cfg["stream"]["chunk_tokens"]
    body = f32 = 0.0
    for _, ref_samples in record["submits"]:
        f32 += flops.speaker_flops(cfg, ref_samples)
    for _, rows, fast in record["admissions"]:
        for t_real, _, keys in rows:
            f32 += flops.content_flops(cfg, t_real)
            b, h = flops.gpt_segment_flops(cfg, keys, 1 + fast)
            body, f32 = body + b, f32 + h
            if fast:
                f32 += flops.vocoder_flops(cfg, fast)
    for _, rows in record["dispatches"]:
        for keys, depth in rows:
            for j in range(1, step + 1):
                b, h = flops.gpt_token_flops(cfg, keys + depth + j)
                body, f32 = body + b, f32 + h
            f32 += flops.vocoder_flops(cfg, step)
    return flops.seconds_at_peak(cfg, flops._by_type({cfg["gpt"]["dtype"]: body},
                                                    {"float32": f32}))


def idle_within(record: dict) -> float:
    """Host seconds the serving loop slept, inside the traced region."""
    a, b = record["start"], record["end"]
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in record["idle"])


def train_peak_seconds(record: dict) -> float:
    """The traced steps' model FLOPs at the card's peaks, in seconds."""
    cfg = record["cfg"]
    return sum(flops.seconds_at_peak(cfg, flops.train_step_flops(cfg, f, s["batch"]))
               for f, s in zip(record["feats"], record["steps"]))


def train_flash_bound_s(record: dict) -> float:
    return sum(flops.flash_bound_s(record["cfg"], f) for f in record["feats"])
