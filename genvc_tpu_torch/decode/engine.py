"""Autoregressive decode engine with a preallocated KV cache
(``genvc_tpu/decode/engine.py``, lockstep subset).

* ``prefill`` embeds [cond | text | start_audio], fills the cache with dense
  causal attention and samples the first audio code;
* ``decode_chunk`` runs N single-token steps and returns N (token, latent)
  pairs; ``decode_all`` runs steps until every row has stopped or the cap
  (non-streaming synthesis). The cache is updated IN PLACE (JAX returns new
  arrays); the write position ``cur_index`` is a host integer shared by all
  rows (lockstep).

Semantics kept from the reference decode path: the t-th AR input sits at mel
position t; the latent paired with token t is ``final_norm`` of the post-ln_f
hidden at the position that generated t; finished rows emit the stop token.

Cached attention (``_attend_cached``): a bf16 or fp8 cache is read by the
hand-written CUDA kernel of ``ops.decode_attention`` (its plain PyTorch
version on CPU tensors). An f32 cache takes the plain ``nn.attention`` path,
because the kernel computes in bf16 and would change f32 decode numerics —
the same gate the JAX engine applies; a numerics choice, not a fallback.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from genvc_tpu_torch.models import gpt as gpt_model
from genvc_tpu_torch.ops import decode_attention as da
from genvc_tpu_torch.ops import nn as tnn
from genvc_tpu_torch.ops import sampling

DONE_CHECK_EVERY = 4  # decode_all steps between reads of "every row finished"


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.85
    top_k: int = 15
    top_p: float = 0.85
    repetition_penalty: float = 2.0
    do_sample: bool = True


@dataclasses.dataclass
class DecodeState:
    cache_k: torch.Tensor      # (L, B, H, T, hd)
    cache_v: torch.Tensor      # (L, B, H, T, hd)
    key_valid: torch.Tensor    # (B, T) bool — filled and unmasked slots
    cur_index: int             # next cache slot to write (all rows)
    n_generated: int           # audio tokens sampled so far
    last_token: torch.Tensor   # (B,) int64
    seen: torch.Tensor         # (B, V) bool — repetition-penalty state
    finished: torch.Tensor     # (B,) bool
    generator: torch.Generator | None


def cache_size(cfg: gpt_model.GPTConfig, prefix_width: int,
               gen_tokens: int | None = None) -> int:
    """Static KV-cache length: prefix + start_audio + generation capacity,
    rounded up to a multiple of 128 (the JAX package's geometry)."""
    gen = cfg.max_gen_mel_tokens if gen_tokens is None else gen_tokens
    return int(np.ceil((prefix_width + 1 + gen) / 128) * 128)


def init_state(cfg: gpt_model.GPTConfig, prefix_width: int, batch: int,
               device, cache_dtype=torch.float32, generator=None,
               gen_tokens: int | None = None) -> DecodeState:
    t = cache_size(cfg, prefix_width, gen_tokens)
    hd = cfg.model_dim // cfg.heads
    shape = (cfg.layers, batch, cfg.heads, t, hd)
    return DecodeState(
        cache_k=torch.zeros(shape, dtype=cache_dtype, device=device),
        cache_v=torch.zeros(shape, dtype=cache_dtype, device=device),
        key_valid=torch.zeros(batch, t, dtype=torch.bool, device=device),
        cur_index=0, n_generated=0,
        last_token=torch.full((batch,), cfg.start_audio_token, dtype=torch.long,
                              device=device),
        seen=sampling.init_seen(cfg.num_audio_tokens, batch, device=device,
                                start_audio_token=cfg.start_audio_token),
        finished=torch.zeros(batch, dtype=torch.bool, device=device),
        generator=generator)


def _attend_cached(block: gpt_model.Block, h, state: DecodeState, layer_idx: int,
                   bias2, heads: int):
    """One block forward for a single token: write its K/V at
    ``state.cur_index`` of layer ``layer_idx`` (in place), attend, MLP."""
    x = block.ln_1(h)
    q, k, v = block.attn.c_attn(x).chunk(3, dim=-1)
    b = h.shape[0]
    hd = h.shape[-1] // heads
    q = q.reshape(b, heads, hd)
    ci = state.cur_index
    state.cache_k[layer_idx, :, :, ci] = k.reshape(b, heads, hd).to(state.cache_k.dtype)
    state.cache_v[layer_idx, :, :, ci] = v.reshape(b, heads, hd).to(state.cache_v.dtype)
    if state.cache_k.dtype != torch.float32:
        out = da.decode_attention_layer(q, state.cache_k, state.cache_v, bias2,
                                        layer_idx)
    else:
        ck = state.cache_k[layer_idx].to(q.dtype)
        cv = state.cache_v[layer_idx].to(q.dtype)
        out = tnn.attention(q[:, :, None], ck, cv,
                            bias=tnn.key_padding_bias(state.key_valid))[:, :, 0]
    h = h + block.attn.c_proj(out.reshape(b, 1, heads * hd))
    return block.mlp_forward(h)


def _decode_forward(model: gpt_model.GPT, state: DecodeState):
    """One AR forward (no sampling) for ``state.last_token``; marks the
    written slot valid. Returns (latent (B, D) f32, logits (B, V) f32)."""
    cfg = model.cfg
    if state.cur_index >= state.cache_k.shape[3]:
        raise RuntimeError(f"KV cache of {state.cache_k.shape[3]} slots is full")
    tok_emb = model.mel_embedding[state.last_token]
    pos_emb = model.mel_pos[state.n_generated]
    h = (tok_emb + pos_emb)[:, None, :].to(model.compute_dtype)
    state.key_valid[:, state.cur_index] = True
    bias2 = torch.where(state.key_valid, 0.0, tnn.NEG_INF).float()
    for i, block in enumerate(model.core.blocks):
        h = _attend_cached(block, h, state, i, bias2, cfg.heads)
    h = model.core.ln_f(h)
    latent = model.final_norm(h[:, 0]).float()
    return latent, model.mel_head(latent)


def _select_token(logits, seen, sampler: SamplerConfig, generator):
    processed = sampling.process_logits(
        logits, seen, repetition_penalty=sampler.repetition_penalty,
        temperature=sampler.temperature, top_k=sampler.top_k, top_p=sampler.top_p)
    if sampler.do_sample:
        return sampling.sample_token(processed, generator)
    return torch.argmax(processed, dim=-1)


def _decode_one(model, state: DecodeState, sampler: SamplerConfig):
    """One AR step: forward, sample, advance the state in place."""
    latent, logits = _decode_forward(model, state)
    stop = model.cfg.stop_audio_token
    tok = _select_token(logits, state.seen, sampler, state.generator)
    tok = torch.where(state.finished, torch.full_like(tok, stop), tok)
    state.finished = state.finished | (tok == stop)
    state.seen[torch.arange(tok.shape[0], device=tok.device), tok] = True
    state.cur_index += 1
    state.n_generated += 1
    state.last_token = tok
    return tok, latent


def prefill_logits(model: gpt_model.GPT, state: DecodeState, prefix_emb,
                   prefix_valid):
    """Embed [prefix | start_audio], fill the cache (in place); return
    (first latent (B, D) f32, first-position logits (B, V)) without sampling."""
    cfg = model.cfg
    b, p, d = prefix_emb.shape
    heads = cfg.heads
    start_emb = (model.mel_embedding[cfg.start_audio_token] + model.mel_pos[0])
    h = torch.cat([prefix_emb, start_emb[None, None, :].expand(b, 1, d).to(prefix_emb.dtype)],
                  dim=1).to(model.compute_dtype)
    seq_valid = torch.cat([prefix_valid, torch.ones(b, 1, dtype=torch.bool,
                                                    device=h.device)], dim=1)
    bias = tnn.causal_bias(p + 1, device=h.device) + tnn.key_padding_bias(seq_valid)
    for i, block in enumerate(model.core.blocks):
        x = block.ln_1(h)
        q, k, v = block.attn.c_attn(x).chunk(3, dim=-1)
        qh, kh, vh = (tnn.split_heads(t, heads) for t in (q, k, v))
        a = tnn.merge_heads(tnn.attention(qh, kh, vh, bias=bias))
        h = block.mlp_forward(h + block.attn.c_proj(a))
        state.cache_k[i, :, :, : p + 1] = kh.to(state.cache_k.dtype)
        state.cache_v[i, :, :, : p + 1] = vh.to(state.cache_v.dtype)
    state.key_valid[:, : p + 1] = seq_valid
    state.cur_index = p + 1
    state.n_generated = 0
    h = model.core.ln_f(h)
    latent = model.final_norm(h[:, -1]).float()
    return latent, model.mel_head(latent)


def prefill(model: gpt_model.GPT, state: DecodeState, prefix_emb, prefix_valid,
            sampler: SamplerConfig):
    """Fill the cache and sample the first token; returns (first_token (B,),
    first_latent (B, D)). ``state`` is advanced in place."""
    latent, logits = prefill_logits(model, state, prefix_emb, prefix_valid)
    tok = _select_token(logits, state.seen, sampler, state.generator)
    state.finished = tok == model.cfg.stop_audio_token
    state.seen[torch.arange(tok.shape[0], device=tok.device), tok] = True
    state.n_generated = 1
    state.last_token = tok
    return tok, latent


def decode_all(model: gpt_model.GPT, state: DecodeState, sampler: SamplerConfig,
               max_new: int):
    """Generate until every row has finished or ``max_new`` tokens exist
    (the prefill token included, at slot 0). Returns (tokens (B, max_new)
    int64, stop-padded past each row's stop token; n_generated (B,)): the
    index of each row's first stop token + 1, else ``max_new``.

    "Every row finished" is read back every ``DONE_CHECK_EVERY`` steps, not
    every step, to save a device sync; the steps run past it only append stop
    tokens (finished rows emit the stop token), so the output is that of a
    loop that checks every step. ``state.n_generated`` never passes
    ``max_new``, so the cache writes stay inside the cache.
    """
    stop = model.cfg.stop_audio_token
    b = state.last_token.shape[0]
    buf = torch.full((b, max_new), stop, dtype=torch.long,
                     device=state.last_token.device)
    buf[:, 0] = state.last_token
    steps = 0
    while state.n_generated < max_new:
        if steps % DONE_CHECK_EVERY == 0 and bool(state.finished.all()):
            break
        slot = state.n_generated
        tok, _ = _decode_one(model, state, sampler)
        buf[:, slot] = tok
        steps += 1
    is_stop = buf == stop
    first_stop = torch.argmax(is_stop.int(), dim=1)
    n_gen = torch.where(is_stop.any(dim=1), first_stop + 1,
                        torch.full_like(first_stop, max_new))
    return buf, n_gen


def decode_chunk(model: gpt_model.GPT, state: DecodeState, sampler: SamplerConfig,
                 chunk: int = 8):
    """Run ``chunk`` AR steps; returns (tokens (B, chunk), latents
    (B, chunk, D), finished-before-step mask (B, chunk)). The latent at slot i
    is the hidden of the input position that generated tokens[i]."""
    toks, lats, pre_fin = [], [], []
    for _ in range(chunk):
        pre_fin.append(state.finished)
        tok, latent = _decode_one(model, state, sampler)
        toks.append(tok)
        lats.append(latent)
    return torch.stack(toks, 1), torch.stack(lats, 1), torch.stack(pre_fin, 1)
