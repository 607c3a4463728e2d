"""Logit transforms with HF generation semantics (``genvc_tpu/ops/sampling.py``).

Chain: repetition penalty -> temperature -> top-k -> top-p, then a
multinomial draw from an explicit ``torch.Generator``. The repetition state is
a boolean "seen" vector over the vocab; the fake prefix ids (1) and
start_audio start out seen, as in HF's scan of GenVC's ``input_ids``.
"""

from __future__ import annotations

import torch


def init_seen(vocab_size: int, batch: int, device=None, start_audio_token: int = 1024):
    seen = torch.zeros(batch, vocab_size, dtype=torch.bool, device=device)
    seen[:, 1] = True                  # the fake prefix ids
    seen[:, start_audio_token] = True
    return seen


def apply_repetition_penalty(logits, seen, penalty: float):
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(seen, penalized, logits)


def apply_temperature(logits, temperature: float):
    if temperature == 1.0:
        return logits
    return logits / temperature


def apply_top_k(logits, k: int):
    if k <= 0:
        return logits
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def apply_top_p(logits, p: float):
    """Keep the smallest set of top tokens whose probability exceeds p (the
    token crossing the threshold is kept; the top token always is)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1).values  # ascending
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    sorted_keep = cum > (1.0 - p)
    sorted_keep[..., -1] = True
    cutoff = torch.where(sorted_keep, sorted_logits,
                         torch.full_like(sorted_logits, float("inf")))
    cutoff = cutoff.min(dim=-1, keepdim=True).values
    return logits.masked_fill(logits < cutoff, float("-inf"))


def process_logits(logits, seen, *, repetition_penalty: float = 1.0,
                   temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0):
    logits = logits.float()
    logits = apply_repetition_penalty(logits, seen, repetition_penalty)
    logits = apply_temperature(logits, temperature)
    logits = apply_top_k(logits, top_k)
    return apply_top_p(logits, top_p)


def process_logits_per_row(logits, seen, repetition_penalty, temperature, top_k, top_p):
    """:func:`process_logits` with each row's own parameters, all (B,)
    tensors (the decode config of each stream of a serving pool).
    ``top_k <= 0`` and ``top_p >= 1`` keep every token exactly; penalty 1 and
    temperature 1 are identities by arithmetic. Equals the scalar chain when
    every row holds the same config."""
    logits = logits.float()
    v = logits.shape[-1]
    p = repetition_penalty.float()[:, None]
    penalized = torch.where(logits < 0, logits * p, logits / p)
    logits = torch.where(seen, penalized, logits)
    logits = logits / temperature.float()[:, None]

    # top-k: keep values >= the k-th largest (ties kept, as the scalar rule)
    k = torch.where(top_k <= 0, torch.full_like(top_k, v), top_k).clamp(1, v)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, 1, (k - 1).long()[:, None])
    logits = logits.masked_fill(logits < kth, float("-inf"))

    # top-p: rows with p >= 1 keep everything (not through cum > 0, which
    # float32 softmax underflow could fail far below the row max)
    sorted_asc = torch.sort(logits, dim=-1).values
    cum = torch.cumsum(torch.softmax(sorted_asc, dim=-1), dim=-1)
    p_row = top_p.float()[:, None]
    sorted_keep = (cum > (1.0 - p_row)) | (p_row >= 1.0)
    sorted_keep[..., -1] = True
    cutoff = torch.where(sorted_keep, sorted_asc, torch.full_like(sorted_asc, float("inf")))
    cutoff = cutoff.min(dim=-1, keepdim=True).values
    return logits.masked_fill(logits < cutoff, float("-inf"))


def sample_token(logits, generator: torch.Generator | None = None, uniform=None):
    """Multinomial draw from processed logits; (B, V) -> (B,) int64.

    Inverse-CDF over the softmax with one uniform per row, taken from
    ``generator`` unless ``uniform`` (B,) is given (tests feed both sides the
    same draws)."""
    probs = torch.softmax(logits.float(), dim=-1)
    if uniform is None:
        uniform = torch.rand(probs.shape[0], generator=generator,
                             device=probs.device)
    cdf = torch.cumsum(probs, dim=-1)
    # right=True: the first i with cdf[i] > u, so a zero-probability token
    # is never drawn
    idx = torch.searchsorted(cdf, (uniform * cdf[:, -1])[:, None].contiguous(),
                             right=True)
    return idx[:, 0].clamp_max(probs.shape[-1] - 1)
