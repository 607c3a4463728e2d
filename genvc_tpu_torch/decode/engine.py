"""Autoregressive decode engine with a preallocated KV cache
(``genvc_tpu/decode/engine.py``).

* ``prefill`` embeds [cond | text | start_audio], fills the cache with dense
  causal attention and samples the first audio code;
* ``decode_chunk`` runs N single-token steps and returns N (token, latent)
  pairs; ``decode_all`` runs steps until every row has stopped or the cap
  (non-streaming synthesis). The cache is updated IN PLACE (JAX returns new
  arrays). Both add the steps they ran to the recorder's ``engine.steps``
  counter (``tracing``), once per call;
* ``decode_beam`` (beam search and beam_sample), ``decode_group_beam``,
  ``decode_constrained`` and ``decode_contrastive`` search one hypothesis
  tiled over the batch (see the section at the end of this file).

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

Cached attention (``_attend_cached``): on the card every bf16 or fp8 cache
is read by a hand-written CUDA kernel of ``ops.decode_attention``:
``decode_attention_layer`` after the lockstep cache write,
``decode_attention_update_layer`` (which writes each row's K/V itself) per
row. On CPU tensors a bf16 GPT takes the kernels' plain PyTorch versions,
and an f32 GPT attends in f32 over the cache widened by ``da.widen``, as
the JAX engine does off the TPU (the kernels round q and the probabilities
to bf16, so an f32 GPT's card result differs from it by that rounding). An
f32 cache takes the plain ``nn.attention`` path everywhere, as in the JAX
engine: a numerics choice, not a fallback. Every write to an fp8 cache goes
through ``da.to_cache`` (the JAX package's e4m3 rounding, overflow stored as
0x7F / 0xFF); every read takes those codes as +-480.

The DeepSeek-V3 backbone (``GPTConfig.mla_moe``, ``models/mla_moe.py``)
keeps a second kind of cache: one latent row a position and layer, shared
by every head, ``DecodeState.latent`` (L, B, T, kv_lora_rank +
qk_rope_head_dim) in the GPT's type, in place of ``cache_k`` / ``cache_v``
(None there), and each row's RoPE position of its start token
(``DecodeState.pos0``). ``prefill`` and the lockstep step dispatch on it;
its step reads the cache through ``ops.mla.mla_decode`` and routes through
``ops.moe.moe_experts``, with no host sync, and on the card runs as a CUDA
graph from its second call on (``_LatentGraphs``). Per-row (pool) states, the
searches and fp8 caches raise for it (``mla_moe.unsupported``).
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from genvc_tpu_torch import tracing
from genvc_tpu_torch.decode.constraints import PhraseListState, completes_all
from genvc_tpu_torch.models import gpt as gpt_model
from genvc_tpu_torch.models import mla_moe
from genvc_tpu_torch.ops import decode_attention as da
from genvc_tpu_torch.ops import mla as mla_ops
from genvc_tpu_torch.ops import moe as moe_ops
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
    latent: torch.Tensor | None = None  # (L, B, T, R + rope): the latent cache
    pos0: torch.Tensor | None = None    # (B,) int64: RoPE position of start_audio

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
    if cfg.mla_moe is not None:
        return _init_latent_state(cfg, t, batch, device, cache_dtype, generator, per_row)
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


def _init_latent_state(cfg, t: int, batch: int, device, cache_dtype, generator,
                       per_row: bool) -> DecodeState:
    """A lockstep state with the latent cache of the DeepSeek-V3 backbone."""
    if per_row:
        raise mla_moe.unsupported("a per-row decode state (the serving pool)")
    if cache_dtype not in (torch.bfloat16, torch.float32):
        raise mla_moe.unsupported(f"a {cache_dtype} cache")
    m = cfg.mla_moe
    return DecodeState(
        cache_k=None, cache_v=None,
        key_valid=torch.zeros(batch, t, dtype=torch.bool, device=device),
        cur_index=0, n_generated=0,
        last_token=torch.full((batch,), cfg.start_audio_token, dtype=torch.long,
                              device=device),
        seen=sampling.init_seen(cfg.num_audio_tokens, batch, device=device,
                                start_audio_token=cfg.start_audio_token),
        finished=torch.zeros(batch, dtype=torch.bool, device=device),
        generator=generator,
        latent=torch.zeros(cfg.layers, batch, t, m.kv_lora_rank + m.qk_rope_head_dim,
                           dtype=cache_dtype, device=device),
        pos0=torch.zeros(batch, dtype=torch.long, device=device))


def _gpt2_only(model, what: str):
    if model.cfg.mla_moe is not None:
        raise mla_moe.unsupported(what)


def _kernel_reads(cache, q) -> bool:
    """Whether K1 / K3 read ``cache`` for ``q``: every bf16 or e4m3 cache on
    the card; on CPU tensors only a bf16 GPT's, since an f32 GPT attends in
    f32 there, as the JAX engine does off the TPU."""
    return cache.dtype != torch.float32 and (q.dtype == torch.bfloat16
                                             or q.device.type != "cpu")


def _attend_cached(block: gpt_model.Block, h, state: DecodeState, layer_idx: int,
                   bias2, heads: int):
    """One block forward for a single token: write its K/V at
    ``state.cur_index`` of layer ``layer_idx`` (in place), attend, MLP."""
    x = block.ln_1(h)
    q, k, v = block.attn.c_attn(x).chunk(3, dim=-1)
    b = h.shape[0]
    hd = h.shape[-1] // heads
    q, k, v = (a.reshape(b, heads, hd) for a in (q, k, v))
    fused = _kernel_reads(state.cache_k, q)
    if state.per_row and fused:  # the kernel writes each row's K/V itself
        out = da.decode_attention_update_layer(q, k, v, state.cache_k, state.cache_v,
                                               bias2, state.cur_index, layer_idx)
    else:
        if state.per_row:
            da.write_rows(state.cache_k[layer_idx], k, state.cur_index)
            da.write_rows(state.cache_v[layer_idx], v, state.cur_index)
        else:
            # past the cache end the write lands on the last slot, as JAX's
            # dynamic_update_slice clamps its start
            ci = min(state.cur_index, state.cache_k.shape[3] - 1)
            state.cache_k[layer_idx, :, :, ci] = da.to_cache(k, state.cache_k.dtype)
            state.cache_v[layer_idx, :, :, ci] = da.to_cache(v, state.cache_v.dtype)
        if fused:
            out = da.decode_attention_layer(q, state.cache_k, state.cache_v, bias2,
                                            layer_idx)
        else:
            ck, cv = (da.widen(c[layer_idx], q.dtype) for c in (state.cache_k, state.cache_v))
            out = tnn.attention(q[:, :, None], ck, cv,
                                bias=tnn.key_padding_bias(state.key_valid))[:, :, 0]
    h = h + block.attn.c_proj(out.reshape(b, 1, heads * hd))
    return block.mlp_forward(h)


def _decode_forward(model: gpt_model.GPT, state: DecodeState,
                    return_hidden: bool = False):
    """One AR forward (no sampling) for ``state.last_token``; marks the
    written slot valid. Returns (latent (B, D) f32, logits (B, V) f32), and
    with ``return_hidden`` a third value: the post-``ln_f``, pre-
    ``final_norm`` hidden (B, D) f32 that contrastive search compares.

    A position past the cache end or the position table is no error, per
    row (an idle pool slot) or in lockstep (a streaming window that steps
    past the generation cap, fault C.7): the key_valid write is dropped, the
    position embedding clamped to the table's last row and a lockstep cache
    write clamped to the last slot, as JAX drops out-of-range scatters and
    clamps gathers and ``dynamic_update_slice``."""
    if state.latent is not None:
        return _decode_forward_latent(model, state, return_hidden)
    cfg = model.cfg
    t = state.cache_k.shape[3]
    tok_emb = model.mel_embedding[state.last_token]
    if state.per_row:
        pos_emb = model.mel_pos[state.n_generated.clamp(max=model.mel_pos.shape[0] - 1)]
        rows = torch.arange(state.key_valid.shape[0], device=tok_emb.device)
        idx = state.cur_index.clamp(max=t - 1)
        state.key_valid[rows, idx] = state.key_valid[rows, idx] | (state.cur_index < t)
    else:
        pos_emb = model.mel_pos[min(state.n_generated, model.mel_pos.shape[0] - 1)]
        if state.cur_index < t:
            state.key_valid[:, state.cur_index] = True
    h = (tok_emb + pos_emb)[:, None, :].to(model.compute_dtype)
    bias2 = torch.where(state.key_valid, 0.0, tnn.NEG_INF).float()
    for i, block in enumerate(model.core.blocks):
        h = _attend_cached(block, h, state, i, bias2, cfg.heads)
    h = model.core.ln_f(h)
    latent = model.final_norm(h[:, 0]).float()
    if return_hidden:
        return latent, model.mel_head(latent), h[:, 0].float()
    return latent, model.mel_head(latent)


def _decode_forward_latent(model: gpt_model.GPT, state: DecodeState, return_hidden: bool):
    """:func:`_decode_forward` of the DeepSeek-V3 backbone, lockstep: each
    block writes its latent row at ``cur_index`` (clamped to the last slot)
    and attends in the absorbed form; the RoPE position of a row is its
    start token's plus ``n_generated``."""
    if return_hidden:
        raise mla_moe.unsupported("contrastive search")
    t = state.latent.shape[2]
    tok_emb = model.mel_embedding[state.last_token]
    pos_emb = model.mel_pos[min(state.n_generated, model.mel_pos.shape[0] - 1)]
    if state.cur_index < t:
        state.key_valid[:, state.cur_index] = True
    h = (tok_emb + pos_emb).to(model.compute_dtype)
    bias2 = torch.where(state.key_valid, 0.0, tnn.NEG_INF).float()
    freqs = mla_moe.rope_freqs(state.pos0 + state.n_generated, model.cfg.mla_moe)
    slot = min(state.cur_index, t - 1)
    graphs = _latent_graphs(model, state)
    if graphs is not None:
        return graphs(model, state, (h, bias2, freqs), slot)
    for i, block in enumerate(model.core.blocks):
        h = mla_moe.decode_block(block, h, state.latent, i, slot, bias2, freqs)
    latent = model.final_norm(model.core.ln_f(h)).float()
    return latent, model.mel_head(latent)


# On the card the latent step's blocks, ``ln_f``, the final norm and the mel
# head (about 1250 launches at Moonlight's sizes) run as one CUDA graph, so
# the host's part of a step is the replay and the ~50 launches around it.
LATENT_GRAPH = True
_COUNTED = (tnn.layer_norm, tnn.rms_norm, mla_ops.mla_decode, moe_ops.moe_experts)


def _latent_graphs(model: gpt_model.GPT, state: DecodeState):
    """The graphs of ``model``'s latent step at ``state``'s cache shape and
    type, or None where the step runs op by op (CPU tensors, or
    ``LATENT_GRAPH`` off)."""
    if not (LATENT_GRAPH and state.latent.is_cuda):
        return None
    runners = model.__dict__.setdefault("_latent_graphs", {})
    key = (tuple(state.latent.shape), state.latent.dtype, state.latent.device)
    if key not in runners:
        runners[key] = _LatentGraphs(state.latent)
    return runners[key]


def _counts() -> dict:
    """The launch counters of the kernels' wrappers and the recorder's."""
    out = {fn: fn.launches for fn in _COUNTED}
    out.update(tracing.snapshot()["counters"])
    return out


def _add_counts(counts: dict, sign: int):
    for key, n in counts.items():
        if isinstance(key, str):
            tracing.count(key, sign * n)
        else:
            key.launches += sign * n


class _LatentGraphs:
    """The step's graphs at one cache shape and type of one model, one for
    each state of the recorder (whose counters, and the experts' device
    counter, decide what the kernels' wrappers launch).

    The graphs read their inputs from this runner's tensors and read and
    write its own latent cache: a state adopts that cache at its first step
    here (its prefilled cache copied in, ``state.latent`` pointed at it), and
    the state that held it before, if still alive, gets a copy of its own.
    A recorder state's first step runs the blocks op by op on the runner's
    tensors, which loads what a capture needs; the second is captured, then
    replayed. A replay adds to the launch counters and to the recorder's
    what its capture counted, so they count the kernels run. The weights are
    compared at each adoption: parameters moved, or absorbed products
    remade, capture anew."""

    def __init__(self, latent):
        self.latent = torch.empty_like(latent)
        self.slot = torch.zeros(1, dtype=torch.long, device=latent.device)
        self.inputs = None      # h (B, D), bias2 (B, T), freqs (B, rope / 2)
        self.owner = None       # weak reference to the state holding the cache
        self.weights = None
        self.graphs: dict = {}  # recorder on -> None (run once) or (graph, outputs, counts)

    def __call__(self, model, state: DecodeState, inputs, slot: int):
        self._adopt(model, state)
        if self.inputs is None:
            self.inputs = [torch.empty_like(x) for x in inputs]
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        self.slot.fill_(slot)
        on = tracing.enabled()
        if on not in self.graphs:
            self.graphs[on] = None
            return self._blocks(model)
        if self.graphs[on] is None:
            self.graphs[on] = self._capture(model)
        return self.replay(on)

    def _adopt(self, model, state: DecodeState):
        if state.latent is self.latent:
            return
        weights = (tuple(p.data_ptr() for p in model.parameters())
                   + tuple(w.data_ptr() for b in model.core.blocks for w in b.attn.absorbed()))
        if weights != self.weights:
            self.graphs.clear()
            self.weights = weights
        prev = self.owner() if self.owner is not None else None
        if prev is not None and prev.latent is self.latent:
            prev.latent = self.latent.clone()
        self.latent.copy_(state.latent)
        state.latent = self.latent
        self.owner = weakref.ref(state)

    def _blocks(self, model):
        h, bias2, freqs = self.inputs
        for i, block in enumerate(model.core.blocks):
            h = mla_moe.decode_block(block, h, self.latent, i, self.slot, bias2, freqs)
        latent = model.final_norm(model.core.ln_f(h)).float()
        return latent, model.mel_head(latent)

    def _capture(self, model):
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self._blocks(model)
        counts = {k: n - before.get(k, 0) for k, n in _counts().items()
                  if n != before.get(k, 0)}
        _add_counts(counts, -1)  # the capture ran nothing
        return graph, out, counts

    def replay(self, on: bool):
        """Run the captured step of recorder state ``on``; fresh copies of
        its (latent, logits)."""
        graph, (latent, logits), counts = self.graphs[on]
        graph.replay()
        _add_counts(counts, 1)
        return latent.clone(), logits.clone()


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
                   prefix_valid, return_hidden: bool = False):
    """Embed [prefix | start_audio], fill the cache (in place); return
    (first latent (B, D) f32, first-position logits (B, V)) without sampling.
    With ``return_hidden`` a third value: the post-``ln_f`` hiddens of the
    whole [prefix | start_audio] sequence (B, P + 1, D) f32, the context of
    contrastive search's degeneration penalty."""
    if state.latent is not None:
        return _prefill_latent(model, state, prefix_emb, prefix_valid, return_hidden)
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
        state.cache_k[i, :, :, : p + 1] = da.to_cache(kh, state.cache_k.dtype)
        state.cache_v[i, :, :, : p + 1] = da.to_cache(vh, state.cache_v.dtype)
    state.key_valid[:, : p + 1] = seq_valid
    if state.per_row:
        state.cur_index = torch.full_like(state.cur_index, p + 1)
        state.n_generated = torch.zeros_like(state.n_generated)
    else:
        state.cur_index, state.n_generated = p + 1, 0
    h = model.core.ln_f(h)
    latent = model.final_norm(h[:, -1]).float()
    if return_hidden:
        return latent, model.mel_head(latent), h.float()
    return latent, model.mel_head(latent)


def _prefill_latent(model: gpt_model.GPT, state: DecodeState, prefix_emb, prefix_valid,
                    return_hidden: bool):
    """:func:`prefill_logits` of the DeepSeek-V3 backbone: the whole
    [prefix | start_audio] through the blocks (each row's RoPE positions
    counting its valid columns), every layer's latent rows into the cache."""
    if return_hidden:
        raise mla_moe.unsupported("contrastive search")
    cfg = model.cfg
    b, p, d = prefix_emb.shape
    start_emb = (model.mel_embedding[cfg.start_audio_token] + model.mel_pos[0])
    h = torch.cat([prefix_emb, start_emb[None, None, :].expand(b, 1, d).to(prefix_emb.dtype)],
                  dim=1).to(model.compute_dtype)
    seq_valid = torch.cat([prefix_valid, torch.ones(b, 1, dtype=torch.bool,
                                                    device=h.device)], dim=1)
    bias = tnn.causal_bias(p + 1, device=h.device) + tnn.key_padding_bias(seq_valid)
    pos = mla_moe.positions(seq_valid)
    freqs = mla_moe.rope_freqs(pos, cfg.mla_moe)
    for i, block in enumerate(model.core.blocks):
        h, rows = mla_moe.full_block(block, h, bias, freqs)
        state.latent[i, :, : p + 1] = rows.to(state.latent.dtype)
    state.key_valid[:, : p + 1] = seq_valid
    state.pos0 = pos[:, -1].clone()
    state.cur_index, state.n_generated = p + 1, 0
    latent = model.final_norm(model.core.ln_f(h[:, -1])).float()
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
    tracing.count("engine.steps", steps)
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
    tracing.count("engine.steps", chunk)
    return torch.stack(toks, 1), torch.stack(lats, 1), torch.stack(pre_fin, 1)


def insert_rows(pool: DecodeState, rows: DecodeState, slots) -> None:
    """Continuous-batching admission: copy the B rows of a per-row state
    (a segment prefill) into ``slots`` (B slot indices) of a per-row pool
    state, in place. Only those slots' cache, positions and sampling state
    change; the pool keeps its generator and step count."""
    if pool.latent is not None:
        raise mla_moe.unsupported("the serving pool")
    idx = torch.as_tensor(list(slots), dtype=torch.long, device=pool.last_token.device)
    pool.cache_k[:, idx] = da.to_cache(rows.cache_k, pool.cache_k.dtype)
    pool.cache_v[:, idx] = da.to_cache(rows.cache_v, pool.cache_v.dtype)
    for name in ("key_valid", "cur_index", "n_generated", "last_token", "seen",
                 "finished"):
        getattr(pool, name)[idx] = getattr(rows, name)


def insert_row(pool: DecodeState, row: DecodeState, slot: int) -> None:
    """:func:`insert_rows` of a single-row state into ``slot``."""
    insert_rows(pool, row, [slot])


# ---------------------------------------------------------------------------
# Search modes of the reference's vendored HF generator: beam search and
# beam_sample, group (diverse) beam search, constrained beam search and
# contrastive search. Each decodes ONE hypothesis tiled over the batch (beams
# or candidates), one lockstep forward per step; the host reads one flag a
# step to decide whether to go on. Each forward adds one to ``state.steps``.

NEG = torch.finfo(torch.float32).min


def _top(x, k: int):
    """Indices of the ``k`` largest entries of a 1-D tensor, the lower index
    first among equal values (``jax.lax.top_k``'s order, which ``torch.topk``
    does not promise)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def _length_norm(cur_len: float, length_penalty: float, device):
    """HF's hypothesis normalisation ``max(cur_len, 1) ** length_penalty`` in
    f32; ``cur_len`` counts HF's ``input_ids``, fake prefix ids included."""
    cur = torch.tensor(cur_len, dtype=torch.float32, device=device)
    return torch.pow(cur.clamp_min(1.0), length_penalty)


def _bits(x):
    return x.view(torch.uint8) if x.element_size() == 1 else x


def _row_words(cache):
    """A contiguous (L, B, ...) cache as (L, B, n) words of the widest
    integer type that tiles a row, so a gather by row moves bits in wide
    words (an element-wise gather of bf16 or e4m3 is bound by its element
    count, not by bytes)."""
    flat = cache.view(cache.shape[0], cache.shape[1], -1)
    row_bytes = flat.shape[-1] * cache.element_size()
    for dt in (torch.int64, torch.int32, torch.int16):
        if row_bytes % dt.itemsize == 0 and dt.itemsize >= cache.element_size():
            return flat.view(dt)
    return _bits(flat)


def reorder_rows(state: DecodeState, parent, spare):
    """The beam reorder: row i of the cache, ``key_valid`` and ``seen``
    becomes row ``parent[i]`` of the old state. The cache is gathered into
    ``spare`` (a (cache_k, cache_v) pair of the cache's shape and type) and
    the two swap, so a parent permutation with cycles reads every row before
    any is written; the rows move as bits (an e4m3 cache too, with no
    cast). Returns the new spare."""
    old = (state.cache_k, state.cache_v)
    for src, dst in zip(old, spare):
        torch.index_select(_row_words(src), 1, parent, out=_row_words(dst))
    state.cache_k, state.cache_v = spare
    state.key_valid = state.key_valid[parent]
    state.seen = state.seen[parent]
    return old


def _gumbel(n: int, generator, device):
    """(n,) f32 standard Gumbel noise, -log of Exp(1) draws."""
    return -torch.log(torch.empty(n, device=device).exponential_(generator=generator))


def _advance(state: DecodeState, parent, tok, spare, first: bool):
    """Reorder by ``parent`` and feed ``tok`` next. The first selection
    follows the prefill, whose token lands at ``cur_index`` on the next
    forward; later ones follow a forward that wrote that slot."""
    spare = reorder_rows(state, parent, spare)
    state.seen[torch.arange(tok.shape[0], device=tok.device), tok] = True
    if first:
        state.n_generated = 1
    else:
        state.cur_index += 1
        state.n_generated += 1
    state.last_token = tok
    return spare


def _best_hypothesis(all_scores, all_bufs, all_lens, max_new: int, stop: int):
    """The best pool entry (first of equal scores), with the stop token
    appended when there is room. Returns (tokens (max_new,), n_tokens)."""
    best = int(torch.argmax(all_scores))
    buf = all_bufs[best].clone()
    n = int(all_lens[best])
    if n < max_new:
        buf[n] = stop
        n += 1
    return buf, n


def _fake_len(prefix_emb, prefix_fake_len) -> float:
    return float(prefix_emb.shape[1] + 1 if prefix_fake_len is None else prefix_fake_len)


def decode_beam(model: gpt_model.GPT, state: DecodeState, prefix_emb, prefix_valid,
                max_new: int, num_beams: int, length_penalty: float = 1.0,
                repetition_penalty: float = 1.0, prefix_fake_len=None,
                do_sample: bool = False, temperature: float = 1.0, top_k: int = 0,
                top_p: float = 1.0, noise=None):
    """Beam search (``do_sample=False``, HF ``beam_search``) and multinomial
    beam search (``do_sample=True``, HF ``beam_sample``), the ``num_beams >
    1`` modes of the reference's vendored generator.

    Per step: log-softmax, then the repetition penalty on the log-probs;
    beam_search takes the top ``2 * num_beams`` flat candidates by
    accumulated score; beam_sample applies temperature -> top-k -> top-p
    (each keeping at least ``2 * num_beams`` tokens) to the accumulated
    scores and draws ``2 * num_beams`` candidates without replacement
    (Gumbel top-k over the flat scores), sorted by score. EOS candidates
    ranked inside the top ``num_beams`` finalize a hypothesis normalised by
    HF's ``input_ids`` length (``prefix_fake_len + s``); the best non-EOS
    candidates survive and the cache follows their parents
    (:func:`reorder_rows`). Scores start at [0, finfo.min, ...]; the search
    stops once no running beam can beat the worst kept hypothesis, then the
    running beams join the pool.

    ``state``: ``init_state`` with ``batch == num_beams``; ``prefix_emb`` /
    ``prefix_valid`` the single hypothesis tiled to ``num_beams`` rows.
    ``noise(s)`` gives step s's (num_beams * V,) Gumbel noise (tests pass the
    JAX package's); by default it is drawn from ``state.generator``. Returns
    (tokens (max_new,) int64, stop-padded, n_tokens incl. the stop token
    when there is room)."""
    _gpt2_only(model, "beam search")
    cfg = model.cfg
    nb, v, stop = num_beams, cfg.num_audio_tokens, cfg.stop_audio_token
    dev = state.last_token.device
    fake_len = _fake_len(prefix_emb, prefix_fake_len)
    if do_sample and noise is None:
        def noise(_s):
            return _gumbel(nb * v, state.generator, dev)
    _, logits = prefill_logits(model, state, prefix_emb, prefix_valid)
    rank = torch.arange(2 * nb, device=dev)
    spare = (torch.empty_like(state.cache_k), torch.empty_like(state.cache_v))

    def select(logits, seen, scores, bufs, fin, s):
        logp = sampling.apply_repetition_penalty(
            torch.log_softmax(logits.float(), dim=-1), seen, repetition_penalty)
        cand = scores[:, None] + logp                                # (nb, V)
        if do_sample:
            warped = sampling.apply_temperature(cand, temperature)
            warped = sampling.apply_top_k(warped, top_k, min_tokens_to_keep=2 * nb)
            flat = sampling.apply_top_p(warped, top_p, min_tokens_to_keep=2 * nb).reshape(-1)
            drawn = _top(flat + noise(s).to(dev), 2 * nb)
            top_idx = drawn[torch.argsort(-flat[drawn], stable=True)]
        else:
            flat = cand.reshape(-1)
            top_idx = _top(flat, 2 * nb)
        top_scores = flat[top_idx]
        parent, tok = top_idx // v, top_idx % v
        is_eos = tok == stop
        norm = _length_norm(fake_len + s, length_penalty, dev)
        all_scores = torch.cat([fin[0], torch.where(is_eos & (rank < nb),
                                                    top_scores / norm, NEG)])
        keep = _top(all_scores, nb)
        fin = (all_scores[keep], torch.cat([fin[1], bufs[parent]])[keep],
               torch.cat([fin[2], torch.full((2 * nb,), s, device=dev)])[keep])
        order = torch.argsort(rank + is_eos.long() * (4 * nb), stable=True)[:nb]
        return parent[order], tok[order], top_scores[order], fin

    scores = torch.full((nb,), NEG, device=dev)
    scores[0] = 0.0
    bufs = torch.full((nb, max_new), stop, dtype=torch.long, device=dev)
    fin = (torch.full((nb,), NEG, device=dev), bufs.clone(),
           torch.zeros(nb, dtype=torch.long, device=dev))
    parent, tok, scores, fin = select(logits, state.seen, scores, bufs, fin, 0)
    bufs = bufs[parent]
    bufs[:, 0] = tok
    spare = _advance(state, parent, tok, spare, first=True)
    s = 1
    while s < max_new:
        best_possible = scores.max() / _length_norm(fake_len + s, length_penalty, dev)
        if bool(fin[0].min() >= best_possible):
            break
        _, logits = _decode_forward(model, state)
        state.steps += 1
        parent, tok, scores, fin = select(logits, state.seen, scores, bufs, fin, s)
        bufs = bufs[parent]
        bufs[:, s] = tok
        spare = _advance(state, parent, tok, spare, first=False)
        s += 1

    run_norm = scores / _length_norm(fake_len + s, length_penalty, dev)
    return _best_hypothesis(
        torch.cat([fin[0], run_norm]), torch.cat([fin[1], bufs]),
        torch.cat([fin[2], torch.full((nb,), s, device=dev)]), max_new, stop)


def decode_group_beam(model: gpt_model.GPT, state: DecodeState, prefix_emb, prefix_valid,
                      max_new: int, num_beams: int, num_beam_groups: int,
                      diversity_penalty: float = 1.0, length_penalty: float = 1.0,
                      repetition_penalty: float = 1.0, prefix_fake_len=None):
    """Group (diverse) beam search, the ``num_beam_groups > 1`` route of the
    reference's vendored generator (HF ``group_beam_search``).

    ``num_beams`` beams in ``num_beam_groups`` groups of ``gs``; one forward
    a step for all beams, then the groups select in order. Group g's
    log-probs lose ``diversity_penalty`` times the count of each token that
    groups < g chose at this step (Hamming diversity, before the repetition
    penalty; group 0 none); per group the top ``2 * gs`` flat candidates,
    EOS candidates in its top ``gs`` finalizing into the group's own pool.
    The first beam of each group starts at 0, the rest at finfo.min. A
    group whose pool can no longer be beaten (checked at HF's post-append
    length) freezes: its rows copy local beam 0 and emit the stop token, and
    its running beams stay out of the finalize. Ends when every group is
    done or at ``max_new``. Returns (tokens (max_new,), n_tokens) of the
    best hypothesis over all pools, as :func:`decode_beam`."""
    _gpt2_only(model, "group beam search")
    nb, G = num_beams, num_beam_groups
    if nb % G != 0:
        raise ValueError("num_beams must be divisible by num_beam_groups "
                         f"(got {nb} / {G})")
    gs = nb // G
    cfg = model.cfg
    v, stop = cfg.num_audio_tokens, cfg.stop_audio_token
    dev = state.last_token.device
    fake_len = _fake_len(prefix_emb, prefix_fake_len)
    _, logits = prefill_logits(model, state, prefix_emb, prefix_valid)
    rank = torch.arange(2 * gs, device=dev)
    spare = (torch.empty_like(state.cache_k), torch.empty_like(state.cache_v))

    def step_groups(logits, seen, scores, bufs, fins, done, s):
        fin_scores, fin_bufs, fin_lens = fins
        norm = _length_norm(fake_len + s, length_penalty, dev)
        norm_next = _length_norm(fake_len + s + 1, length_penalty, dev)
        parents, toks, new_scores, fs, fb, fl, new_done = ([] for _ in range(7))
        for g in range(G):
            rows = slice(g * gs, (g + 1) * gs)
            logp = torch.log_softmax(logits[rows].float(), dim=-1)
            if g > 0:
                freq = torch.bincount(torch.cat(toks), minlength=v).float()
                logp = logp - diversity_penalty * freq[None, :]
            logp = sampling.apply_repetition_penalty(logp, seen[rows], repetition_penalty)
            flat = (scores[rows][:, None] + logp).reshape(-1)
            top_idx = _top(flat, 2 * gs)
            top_scores = flat[top_idx]
            parent, tok = top_idx // v, top_idx % v
            is_eos = tok == stop
            pool = torch.cat([fin_scores[g], torch.where(is_eos & (rank < gs) & ~done[g],
                                                         top_scores / norm, NEG)])
            keep = _top(pool, gs)
            fs.append(pool[keep])
            fb.append(torch.cat([fin_bufs[g], bufs[g * gs + parent]])[keep])
            fl.append(torch.cat([fin_lens[g], torch.full((2 * gs,), s, device=dev)])[keep])
            order = torch.argsort(rank + is_eos.long() * (4 * gs), stable=True)[:gs]
            parent, tok, sc = parent[order], tok[order], top_scores[order]
            parents.append(g * gs + torch.where(done[g], torch.zeros_like(parent), parent))
            toks.append(torch.where(done[g], torch.full_like(tok, stop), tok))
            new_scores.append(torch.where(done[g], torch.zeros_like(sc), sc))
            new_done.append(done[g] | (fs[-1].min() >= top_scores[0] / norm_next))
        return (torch.cat(parents), torch.cat(toks), torch.cat(new_scores),
                (torch.stack(fs), torch.stack(fb), torch.stack(fl)), torch.stack(new_done))

    scores = torch.where(torch.arange(nb, device=dev) % gs == 0, 0.0, NEG)
    bufs = torch.full((nb, max_new), stop, dtype=torch.long, device=dev)
    fins = (torch.full((G, gs), NEG, device=dev), bufs.reshape(G, gs, max_new).clone(),
            torch.zeros((G, gs), dtype=torch.long, device=dev))
    done = torch.zeros(G, dtype=torch.bool, device=dev)
    parent, tok, scores, fins, done = step_groups(logits, state.seen, scores, bufs, fins,
                                                  done, 0)
    bufs = bufs[parent]
    bufs[:, 0] = tok
    spare = _advance(state, parent, tok, spare, first=True)
    s = 1
    while s < max_new and not bool(done.all()):
        _, logits = _decode_forward(model, state)
        state.steps += 1
        parent, tok, scores, fins, done = step_groups(logits, state.seen, scores, bufs,
                                                      fins, done, s)
        bufs = bufs[parent]
        bufs[:, s] = tok
        spare = _advance(state, parent, tok, spare, first=False)
        s += 1

    fin_scores, fin_bufs, fin_lens = fins
    run_norm = scores / _length_norm(fake_len + s, length_penalty, dev)
    run_norm = torch.where(done[:, None], NEG, run_norm.reshape(G, gs))
    return _best_hypothesis(
        torch.cat([fin_scores, run_norm], dim=1).reshape(-1),
        torch.cat([fin_bufs, bufs.reshape(G, gs, max_new)], dim=1).reshape(-1, max_new),
        torch.cat([fin_lens, torch.full((G, gs), s, device=dev)], dim=1).reshape(-1),
        max_new, stop)


def _reset_state(constraints, token_ids) -> PhraseListState:
    st = PhraseListState(constraints)
    st.reset(token_ids)
    return st


def decode_constrained(model: gpt_model.GPT, state: DecodeState, prefix_emb,
                       prefix_valid, max_new: int, num_beams: int, constraints,
                       length_penalty: float = 1.0, repetition_penalty: float = 1.0,
                       prefix_fake_len=None):
    """Constrained beam search, the ``constraints`` / ``force_words_ids``
    route of the reference's vendored generator (HF
    ``ConstrainedBeamSearchScorer``); no reference entry point reaches it.

    The banked selection is sequence bookkeeping (per-beam phrase progress,
    dedup of advance candidates, bank round-robin), so it runs on the host;
    every forward is the lockstep batch-``num_beams`` ``_decode_forward``
    and the log-softmax runs in f32 on the device, read once a step. HF
    semantics: log-softmax, the repetition penalty on the log-probs, running
    scores added (``scores_for_all_vocab``), the top ``2 * num_beams`` flat
    candidates; an EOS candidate inside the top ``num_beams`` finalizes only
    if its parent meets every constraint, normalised by
    ``(len(input_ids) + 1) ** length_penalty`` (fake prefix ids included);
    each unmet beam proposes advance candidates (the in-progress phrase's
    next token, or each pending phrase's first) not already tracked; all sort
    by ``bank * 100 + score`` and are drawn round-robin across banks; the
    early stop and the finalize fallback (no running beam meets the
    constraints: all of them join the pool) are HF's.

    ``constraints``: a list of token phrases. ``state``: ``init_state`` with
    ``batch == num_beams``. Returns (tokens (max_new,), n_tokens) as
    :func:`decode_beam`."""
    _gpt2_only(model, "constrained beam search")
    cfg = model.cfg
    nb, v, stop = num_beams, cfg.num_audio_tokens, cfg.stop_audio_token
    dev = state.last_token.device
    fake_len = int(_fake_len(prefix_emb, prefix_fake_len))
    _, logits = prefill_logits(model, state, prefix_emb, prefix_valid)
    spare = (torch.empty_like(state.cache_k), torch.empty_like(state.cache_v))

    # full sequences start with HF's fake input_ids (ones, then start_audio)
    # so constraint resets and the repetition penalty see what HF's would
    fake_prefix = [1] * (fake_len - 1) + [cfg.start_audio_token]
    seqs = [list(fake_prefix) for _ in range(nb)]
    scores = np.full((nb,), -1e9, np.float32)
    scores[0] = 0.0
    seen = np.zeros((nb, v), bool)
    seen[:, [1, cfg.start_audio_token]] = True
    hyps: list = []     # (normalised score, token list), best first

    def add_hyp(norm_score, toks):
        hyps.append((norm_score, toks))
        hyps.sort(key=lambda x: -x[0])
        del hyps[nb:]

    def select(logits):
        logp = torch.log_softmax(logits.float(), dim=-1).cpu().numpy()
        if repetition_penalty != 1.0:
            pen = np.where(logp < 0, logp * repetition_penalty, logp / repetition_penalty)
            logp = np.where(seen, pen, logp)
        cand = scores[:, None] + logp                                # (nb, V)
        flat = cand.reshape(-1)
        top = np.argsort(-flat, kind="stable")[: 2 * nb]
        sel = []                                                     # (score, tok, parent)
        cur_len = len(seqs[0]) + 1
        for rank, fi in enumerate(top):
            parent, tok = int(fi) // v, int(fi) % v
            sc = float(flat[fi])
            if tok == stop:
                if rank < nb and completes_all(constraints, seqs[parent]):
                    add_hyp(sc / cur_len ** length_penalty, list(seqs[parent]))
                continue
            sel.append((sc, tok, parent))
            if len(sel) == nb:
                break

        # advance candidates from the running beams (step_sentence_constraint)
        tracked = [seqs[p] + [t] for (_, t, p) in sel]
        cands = [(sc, t, p, _reset_state(constraints, seqs[p] + [t])) for (sc, t, p) in sel]
        for row in range(nb):
            st_row = _reset_state(constraints, seqs[row])
            if st_row.completed:
                continue
            for adv in st_row.advance():
                adv_seq = seqs[row] + [adv]
                if adv_seq in tracked:
                    continue
                tracked.append(adv_seq)
                st_new = st_row.copy()
                st_new.add(adv)
                cands.append((float(cand[row, adv]), adv, row, st_new))

        # bank round-robin: sort by bank * 100 + score, then stable-argsort
        # the position within each bank (HF's construction), only when
        # advance candidates were added
        if len(cands) > len(sel):
            zipped = [c[3].get_bank() * 100.0 + c[0] for c in cands]
            order = sorted(range(len(cands)), key=lambda i: -zipped[i])
            incr, counter, cur_bank = [], -1, None
            for i in order:
                b = cands[i][3].get_bank()
                counter = counter + 1 if b == cur_bank else 0
                cur_bank = b
                incr.append(counter)
            picked = [cands[order[j]] for j in np.argsort(incr, kind="stable")][:nb]
        else:
            picked = cands
        return picked, float(flat[top[0]])

    def is_done(best_possible):
        if len(hyps) < nb:
            return False
        return hyps[-1][0] >= best_possible / (len(seqs[0]) + 1) ** length_penalty

    done = False
    for s in range(max_new):
        picked, best_possible = select(logits)
        done = is_done(best_possible)   # HF: evaluated before the update
        parents = [p for (_, _, p, _) in picked]
        tokens = [t for (_, t, _, _) in picked]
        spare = _advance(state, torch.tensor(parents, device=dev),
                         torch.tensor(tokens, device=dev), spare, first=s == 0)
        seqs[:] = [seqs[p] + [t] for p, t in zip(parents, tokens)]
        seen = seen[parents]
        seen[np.arange(nb), tokens] = True
        scores = np.asarray([sc for (sc, _, _, _) in picked], np.float32)
        if done or s + 1 == max_new:
            break
        _, logits = _decode_forward(model, state)
        state.steps += 1

    # finalize: running beams that meet the constraints join the pool (unless
    # the early stop fired); if none does, HF's fallback adds them all
    if not done:
        complete = [row for row in range(nb) if completes_all(constraints, seqs[row])]
        for row in complete or range(nb):
            add_hyp(scores[row] / len(seqs[row]) ** length_penalty, list(seqs[row]))

    best = hyps[0][1][len(fake_prefix):]
    out = torch.full((max_new,), stop, dtype=torch.long, device=dev)
    out[: len(best)] = torch.tensor(best, dtype=torch.long)
    return out, len(best) + 1 if len(best) < max_new else len(best)


def decode_contrastive(model: gpt_model.GPT, state: DecodeState, prefix_emb,
                       prefix_valid, max_new: int, top_k: int = 4,
                       penalty_alpha: float = 0.6, repetition_penalty: float = 1.0):
    """Contrastive search, the ``penalty_alpha > 0`` mode of the reference's
    vendored generator (HF ``_contrastive_search``).

    Per step: the hypothesis's logits through the repetition penalty and a
    softmax; the top ``top_k`` tokens are the candidates, all evaluated by
    one forward of the batch-``top_k`` cache; a candidate's degeneration
    penalty is the largest cosine similarity of its post-``ln_f`` hidden
    with the hiddens of every earlier position (the prefix's invalid ones
    masked); score = ``(1 - penalty_alpha) * p - penalty_alpha * penalty``,
    the first maximum wins and its logits seed the next step. Only the slot
    just written differs between the rows, so the winner's K/V there is
    copied to every row (no full gather). Stops at the stop token (kept) or
    ``max_new`` tokens.

    ``state``: ``init_state`` with ``batch == top_k``; ``prefix_emb`` /
    ``prefix_valid`` the single hypothesis tiled to ``top_k`` rows. Returns
    (tokens (max_new,), n_tokens), stop-padded."""
    _gpt2_only(model, "contrastive search")
    k, stop = top_k, model.cfg.stop_audio_token
    dev = state.last_token.device
    _, logits, h0 = prefill_logits(model, state, prefix_emb, prefix_valid,
                                   return_hidden=True)
    p1 = prefix_emb.shape[1] + 1
    ctx_h = torch.zeros(p1 + max_new, h0.shape[-1], device=dev)
    ctx_h[:p1] = h0[0]
    ctx_valid = torch.zeros(p1 + max_new, dtype=torch.bool, device=dev)
    ctx_valid[: p1 - 1] = prefix_valid[0]
    ctx_valid[p1 - 1] = True
    buf = torch.full((max_new,), stop, dtype=torch.long, device=dev)
    seen = state.seen[0].clone()
    l = logits[0]
    # the candidates of step s are the s-th generated tokens: mel position s+1
    state.n_generated = 1
    s = 0
    while s < max_new:
        pl = sampling.apply_repetition_penalty(l[None].float(), seen[None],
                                               repetition_penalty)[0]
        probs = torch.softmax(pl, dim=-1)
        cand_ids = _top(probs, k)
        cand_p = probs[cand_ids]
        state.last_token = cand_ids
        _, cand_logits, cand_h = _decode_forward(model, state, return_hidden=True)
        state.steps += 1

        cn = cand_h / torch.linalg.norm(cand_h, dim=-1, keepdim=True).clamp_min(1e-12)
        xn = ctx_h / torch.linalg.norm(ctx_h, dim=-1, keepdim=True).clamp_min(1e-12)
        sim = torch.where(ctx_valid[:, None], xn @ cn.T, NEG)       # (ctx, k)
        score = (1.0 - penalty_alpha) * cand_p - penalty_alpha * sim.max(dim=0).values
        best = torch.argmax(score)
        tok = cand_ids[best]

        idx = state.cur_index
        for cache in map(_bits, (state.cache_k, state.cache_v)):
            cache[:, :, :, idx] = cache[:, :, :, idx].index_select(1, best.view(1))
        state.cur_index += 1
        state.n_generated += 1
        l = cand_logits[best]
        ctx_h[p1 + s] = cand_h[best]
        ctx_valid[p1 + s] = True
        seen[tok] = True
        buf[s] = tok
        s += 1
        if bool(tok == stop):
            break
    return buf, s
