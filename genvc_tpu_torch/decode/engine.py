"""Autoregressive decode engine with a preallocated KV cache
(``genvc_tpu/decode/engine.py`` without the beam and contrastive modes).

* ``prefill`` embeds [cond | text | start_audio], fills the cache with dense
  causal attention and samples the first audio code;
* ``decode_chunk`` runs N single-token steps and returns N (token, latent)
  pairs; ``decode_all`` runs steps until every row has stopped or the cap
  (non-streaming synthesis). The cache is updated IN PLACE (JAX returns new
  arrays).

Two kinds of state. Lockstep (``init_state``'s default): the write position
``cur_index`` and ``n_generated`` are host integers shared by all rows.
Per-row (``per_row=True``, the slot pool of ``serving.StreamServer``): each
row sits at its own depth, ``cur_index`` and ``n_generated`` are (B,) int64
tensors on the device, and no step reads them back to the host. A pool keeps
ticking idle slots, so a row may run past the cache end: as in JAX, its
writes are then dropped and its position-embedding index is clamped.
``insert_rows`` copies freshly prefilled rows into pool slots (admission).

Semantics kept from the reference decode path: the t-th AR input sits at mel
position t; the latent paired with token t is ``final_norm`` of the post-ln_f
hidden at the position that generated t; finished rows emit the stop token.

Cached attention (``_attend_cached``): a bf16 or fp8 cache is read by a
hand-written CUDA kernel of ``ops.decode_attention`` (its plain PyTorch
version on CPU tensors): ``decode_attention_layer`` after the lockstep
cache write, ``decode_attention_update_layer`` (which writes each row's K/V
itself) per row. An f32 cache takes the plain ``nn.attention`` path, because
the kernels compute in bf16 and would change f32 decode numerics — the same
gate the JAX engine applies; a numerics choice, not a fallback.
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
    cur_index: int | torch.Tensor   # next cache slot to write: a host int
                                    # (lockstep) or (B,) int64 (per row)
    n_generated: int | torch.Tensor  # audio tokens sampled so far, likewise
    last_token: torch.Tensor   # (B,) int64
    seen: torch.Tensor         # (B, V) bool — repetition-penalty state
    finished: torch.Tensor     # (B,) bool
    generator: torch.Generator | None
    steps: int = 0             # decode steps run on this state (host count)

    @property
    def per_row(self) -> bool:
        return isinstance(self.cur_index, torch.Tensor)


def cache_size(cfg: gpt_model.GPTConfig, prefix_width: int,
               gen_tokens: int | None = None) -> int:
    """Static KV-cache length: prefix + start_audio + generation capacity,
    rounded up to a multiple of 128 (the JAX package's geometry)."""
    gen = cfg.max_gen_mel_tokens if gen_tokens is None else gen_tokens
    return int(np.ceil((prefix_width + 1 + gen) / 128) * 128)


def init_state(cfg: gpt_model.GPTConfig, prefix_width: int, batch: int,
               device, cache_dtype=torch.float32, generator=None,
               gen_tokens: int | None = None, per_row: bool = False) -> DecodeState:
    t = cache_size(cfg, prefix_width, gen_tokens)
    hd = cfg.model_dim // cfg.heads
    shape = (cfg.layers, batch, cfg.heads, t, hd)
    idx0 = torch.zeros(batch, dtype=torch.long, device=device) if per_row else 0
    return DecodeState(
        cache_k=torch.zeros(shape, dtype=cache_dtype, device=device),
        cache_v=torch.zeros(shape, dtype=cache_dtype, device=device),
        key_valid=torch.zeros(batch, t, dtype=torch.bool, device=device),
        cur_index=idx0, n_generated=idx0.clone() if per_row else 0,
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
    q, k, v = (a.reshape(b, heads, hd) for a in (q, k, v))
    fused = state.cache_k.dtype != torch.float32
    if state.per_row and fused:  # the kernel writes each row's K/V itself
        out = da.decode_attention_update_layer(q, k, v, state.cache_k, state.cache_v,
                                               bias2, state.cur_index, layer_idx)
    else:
        if state.per_row:
            da.write_rows(state.cache_k[layer_idx], k, state.cur_index)
            da.write_rows(state.cache_v[layer_idx], v, state.cur_index)
        else:
            ci = state.cur_index
            state.cache_k[layer_idx, :, :, ci] = k.to(state.cache_k.dtype)
            state.cache_v[layer_idx, :, :, ci] = v.to(state.cache_v.dtype)
        if fused:
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
    written slot valid. Returns (latent (B, D) f32, logits (B, V) f32).

    Per row, a position past the cache end is no error (an idle pool slot):
    its key_valid write is dropped and the position embedding clamped, as
    JAX drops out-of-range scatters and clamps gathers."""
    cfg = model.cfg
    t = state.cache_k.shape[3]
    tok_emb = model.mel_embedding[state.last_token]
    if state.per_row:
        pos_emb = model.mel_pos[state.n_generated.clamp(max=model.mel_pos.shape[0] - 1)]
        rows = torch.arange(state.key_valid.shape[0], device=tok_emb.device)
        idx = state.cur_index.clamp(max=t - 1)
        state.key_valid[rows, idx] = state.key_valid[rows, idx] | (state.cur_index < t)
    else:
        if state.cur_index >= t:
            raise RuntimeError(f"KV cache of {t} slots is full")
        pos_emb = model.mel_pos[state.n_generated]
        state.key_valid[:, state.cur_index] = True
    h = (tok_emb + pos_emb)[:, None, :].to(model.compute_dtype)
    bias2 = torch.where(state.key_valid, 0.0, tnn.NEG_INF).float()
    for i, block in enumerate(model.core.blocks):
        h = _attend_cached(block, h, state, i, bias2, cfg.heads)
    h = model.core.ln_f(h)
    latent = model.final_norm(h[:, 0]).float()
    return latent, model.mel_head(latent)


def _select_token(logits, seen, sampler: SamplerConfig, generator, row_params=None):
    """The sampling chain and the token choice. ``row_params`` (dict of (B,)
    tensors: temperature, top_k, top_p, repetition_penalty, do_sample)
    overrides ``sampler`` per row — each stream's own config in a pool."""
    if row_params is None:
        processed = sampling.process_logits(
            logits, seen, repetition_penalty=sampler.repetition_penalty,
            temperature=sampler.temperature, top_k=sampler.top_k, top_p=sampler.top_p)
        if sampler.do_sample:
            return sampling.sample_token(processed, generator)
        return torch.argmax(processed, dim=-1)
    processed = sampling.process_logits_per_row(
        logits, seen, repetition_penalty=row_params["repetition_penalty"],
        temperature=row_params["temperature"], top_k=row_params["top_k"],
        top_p=row_params["top_p"])
    sampled = sampling.sample_token(processed, generator)
    return torch.where(row_params["do_sample"], sampled, torch.argmax(processed, dim=-1))


def _decode_one(model, state: DecodeState, sampler: SamplerConfig, row_params=None):
    """One AR step: forward, sample, advance the state in place."""
    latent, logits = _decode_forward(model, state)
    stop = model.cfg.stop_audio_token
    tok = _select_token(logits, state.seen, sampler, state.generator, row_params)
    tok = torch.where(state.finished, torch.full_like(tok, stop), tok)
    state.finished = state.finished | (tok == stop)
    state.seen[torch.arange(tok.shape[0], device=tok.device), tok] = True
    state.cur_index += 1
    state.n_generated += 1
    state.last_token = tok
    state.steps += 1
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
    if state.per_row:
        state.cur_index = torch.full_like(state.cur_index, p + 1)
        state.n_generated = torch.zeros_like(state.n_generated)
    else:
        state.cur_index, state.n_generated = p + 1, 0
    h = model.core.ln_f(h)
    latent = model.final_norm(h[:, -1]).float()
    return latent, model.mel_head(latent)


def prefill(model: gpt_model.GPT, state: DecodeState, prefix_emb, prefix_valid,
            sampler: SamplerConfig, row_params=None):
    """Fill the cache and sample the first token; returns (first_token (B,),
    first_latent (B, D)). ``state`` is advanced in place. ``row_params``
    overrides the sampler per row (see ``_select_token``)."""
    latent, logits = prefill_logits(model, state, prefix_emb, prefix_valid)
    tok = _select_token(logits, state.seen, sampler, state.generator, row_params)
    state.finished = tok == model.cfg.stop_audio_token
    state.seen[torch.arange(tok.shape[0], device=tok.device), tok] = True
    state.n_generated = state.n_generated + 1
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
                 chunk: int = 8, row_params=None):
    """Run ``chunk`` AR steps; returns (tokens (B, chunk), latents
    (B, chunk, D), finished-before-step mask (B, chunk)). The latent at slot i
    is the hidden of the input position that generated tokens[i].
    ``row_params`` overrides the sampler per row."""
    toks, lats, pre_fin = [], [], []
    for _ in range(chunk):
        pre_fin.append(state.finished)
        tok, latent = _decode_one(model, state, sampler, row_params)
        toks.append(tok)
        lats.append(latent)
    return torch.stack(toks, 1), torch.stack(lats, 1), torch.stack(pre_fin, 1)


def insert_rows(pool: DecodeState, rows: DecodeState, slots) -> None:
    """Continuous-batching admission: copy the B rows of a per-row state
    (a segment prefill) into ``slots`` (B slot indices) of a per-row pool
    state, in place. Only those slots' cache, positions and sampling state
    change; the pool keeps its generator and step count."""
    idx = torch.as_tensor(list(slots), dtype=torch.long, device=pool.last_token.device)
    pool.cache_k[:, idx] = rows.cache_k.to(pool.cache_k.dtype)
    pool.cache_v[:, idx] = rows.cache_v.to(pool.cache_v.dtype)
    for name in ("key_valid", "cur_index", "n_generated", "last_token", "seen",
                 "finished"):
        getattr(pool, name)[idx] = getattr(rows, name)


def insert_row(pool: DecodeState, row: DecodeState, slot: int) -> None:
    """:func:`insert_rows` of a single-row state into ``slot``."""
    insert_rows(pool, row, [slot])
