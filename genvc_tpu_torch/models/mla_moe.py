"""The DeepSeek-V3 decoder block (latent attention and a mixture of experts)
as a backbone of GenVC's GPT, behind GenVC's own embeddings, position
tables, heads, Perceiver and vocoder (``models/gpt.py`` builds it where
``GPTConfig.mla_moe`` is set).

For a layer with input h at positions p:

* attention: x = RMSNorm(h); q = x W_q, per head q_nope (nope) | q_pe (rope);
  [c | k_pe] = x W_kva, c = RMSNorm(c) (kv_lora_rank wide); q_pe and the
  shared k_pe rotated on interleaved pairs (2i, 2i + 1) at angle
  p * theta^(-2i / rope); k_nope and v per head from c W_kvb; causal
  attention at scale 1 / sqrt(nope + rope); h += concat_h(o_h) W_o.
* a decode step uses the absorbed form over the latent cache rows
  [c | k_pe]: q~_h = W_UK,h^T q_nope_h, s_t = q~_h . c_t + q_pe,h . k_pe,t,
  o_h = W_UV,h (sum_t p_t c_t) (``ops.mla.mla_decode``).
* feed-forward: x = RMSNorm(h); the first ``first_k_dense_replace`` layers a
  SwiGLU down(silu(gate x) * up x); the others a mixture: s = sigmoid(x W_r)
  in f32, the top-k of s + b (the selection bias), weights s of the chosen
  over their sum times ``routed_scaling_factor``, h += sum_i w_i E_i(x) +
  S(x) with S the shared experts' SwiGLU (``ops.moe.moe_experts`` for the
  routed ones).

RoPE positions are each row's own: the count of valid keys before a
position, so a row's padded prefix columns shift nothing. Weights keep the
(in, out) layout of the port's linears, except the routed experts, stored a
row per output neuron as the kernel reads them: ``gate_up`` (E, 2F, D) and
``down`` (E, D, F). ``n_group`` = ``topk_group`` = 1 (a plain top-k) is the
only grouping built.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from genvc_tpu_torch.config import MLAMoEConfig
from genvc_tpu_torch.ops import mla as mla_ops
from genvc_tpu_torch.ops import moe as moe_ops
from genvc_tpu_torch.ops import nn as tnn

BACKBONE = "deepseek_v3"


def unsupported(what: str):
    """The error of a path the backbone does not take."""
    return NotImplementedError(
        f"{what} is not implemented for the {BACKBONE} backbone (latent attention and "
        "mixture of experts); it runs the lockstep streaming, batch and offline paths")


class _MLA(nn.Module):
    def __init__(self, d: int, heads: int, m: MLAMoEConfig):
        super().__init__()
        r, rope = m.kv_lora_rank, m.qk_rope_head_dim
        self.q = tnn.Linear(d, heads * m.qk_head_dim, bias=False)
        self.kv_a = tnn.Linear(d, r + rope, bias=False)
        self.kv_norm = tnn.RMSNorm(r, m.rms_norm_eps)
        self.kv_b = tnn.Linear(r, heads * (m.qk_nope_head_dim + m.v_head_dim), bias=False)
        self.o = tnn.Linear(heads * m.v_head_dim, d, bias=False)
        self.heads = heads
        self._absorbed = None

    def absorbed(self):
        """(W_UK (H, nope, R), W_UV (H, R, v)) from ``kv_b``, contiguous, kept
        while ``kv_b`` holds the same tensor."""
        w = self.kv_b.w
        key = (w.data_ptr(), w.dtype, w._version)
        if self._absorbed is None or self._absorbed[0] != key:
            r = w.shape[0]
            nope = w.shape[1] // self.heads - self.o.w.shape[0] // self.heads
            wv = w.view(r, self.heads, -1)
            self._absorbed = (key, wv[:, :, :nope].permute(1, 2, 0).contiguous(),
                              wv[:, :, nope:].permute(1, 0, 2).contiguous())
        return self._absorbed[1:]


class SwiGLU(nn.Module):
    """down(silu(gate x) * up x), gate and up as one (d, 2f) product."""

    def __init__(self, d: int, f: int):
        super().__init__()
        self.gate_up = tnn.Linear(d, 2 * f, bias=False)
        self.down = tnn.Linear(f, d, bias=False)

    def forward(self, x):
        g, u = self.gate_up(x).chunk(2, dim=-1)
        return self.down(torch.nn.functional.silu(g) * u)


class _Router(nn.Module):
    def __init__(self, d: int, n: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d, n), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(n), requires_grad=False)


class _Experts(nn.Module):
    def __init__(self, d: int, f: int, n: int):
        super().__init__()
        self.gate_up = nn.Parameter(torch.empty(n, 2 * f, d), requires_grad=False)
        self.down = nn.Parameter(torch.empty(n, d, f), requires_grad=False)


class _MoE(nn.Module):
    def __init__(self, d: int, m: MLAMoEConfig):
        super().__init__()
        f = m.moe_intermediate_size
        self.router = _Router(d, m.n_routed_experts)
        self.experts = _Experts(d, f, m.n_routed_experts)
        self.shared = SwiGLU(d, m.n_shared_experts * f)


class MLAMoEBlock(nn.Module):
    def __init__(self, d: int, heads: int, m: MLAMoEConfig, layer: int):
        super().__init__()
        self.attn_norm = tnn.RMSNorm(d, m.rms_norm_eps)
        self.attn = _MLA(d, heads, m)
        self.ffn_norm = tnn.RMSNorm(d, m.rms_norm_eps)
        if layer < m.first_k_dense_replace:
            self.mlp = SwiGLU(d, m.intermediate_size)
        else:
            self.moe = _MoE(d, m)
        self.m = m


# ------------------------------------------------------------------ RoPE


def rope_freqs(pos, m: MLAMoEConfig):
    """Unit complex rotations (..., rope / 2) of the positions ``pos`` (any
    integer shape): angle pos * theta^(-2i / rope), in f32."""
    rope = m.qk_rope_head_dim
    inv = 1.0 / (m.rope_theta ** (torch.arange(0, rope, 2, device=pos.device,
                                               dtype=torch.float32) / rope))
    ang = pos.float()[..., None] * inv
    return torch.polar(torch.ones_like(ang), ang)


def apply_rope(x, freqs):
    """``x`` (..., rope) rotated on its interleaved pairs by ``freqs``
    (broadcast over x's leading dimensions but the last), x's type out."""
    xc = torch.view_as_complex(x.float().reshape(*x.shape[:-1], -1, 2))
    return torch.view_as_real(xc * freqs).flatten(-2).to(x.dtype)


# ---------------------------------------------------------------- routing


def route(x, router: _Router, m: MLAMoEConfig):
    """(N, D) -> (experts (N, k) int64, weights (N, k) f32): sigmoid scores
    in f32, the top-k of score + selection bias, the chosen scores over
    their sum times the scaling factor. Device tensors only."""
    s = torch.sigmoid(x.float() @ router.w.float())
    idx = torch.topk(s + router.bias.float(), m.num_experts_per_tok, dim=-1).indices
    w = s.gather(-1, idx)
    if m.norm_topk_prob:
        w = w / w.sum(dim=-1, keepdim=True)
    return idx, w * m.routed_scaling_factor


def ffn(block: MLAMoEBlock, h):
    """h + the block's feed-forward of RMSNorm(h); h (..., D)."""
    x = block.ffn_norm(h)
    if hasattr(block, "mlp"):
        return h + block.mlp(x)
    moe = block.moe
    flat = x.reshape(-1, x.shape[-1])
    idx, w = route(flat, moe.router, block.m)
    routed = moe_ops.moe_experts(flat, idx, w, moe.experts.gate_up, moe.experts.down)
    return h + routed.view(x.shape) + moe.shared(x)


# ---------------------------------------------------------------- forwards


def _qkv(block: MLAMoEBlock, x, freqs):
    """q_nope, rotated q_pe (..., H, nope / rope), the latent rows [c |
    rotated k_pe] (..., R + rope)."""
    a, m = block.attn, block.m
    q = a.q(x).unflatten(-1, (a.heads, m.qk_head_dim))
    q_nope, q_pe = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    kva = a.kv_a(x)
    c = a.kv_norm(kva[..., : m.kv_lora_rank])
    k_pe = apply_rope(kva[..., m.kv_lora_rank:], freqs)
    q_pe = apply_rope(q_pe, freqs.unsqueeze(-2))
    return q_nope, q_pe, torch.cat([c, k_pe], dim=-1)


def full_block(block: MLAMoEBlock, h, bias, freqs):
    """The block over whole sequences (B, T, D), attention masked by
    ``bias`` (B or 1, 1, T, T), RoPE by ``freqs`` (B, T, rope / 2). Returns
    (h, the latent rows (B, T, R + rope) a cache keeps)."""
    a, m = block.attn, block.m
    q_nope, q_pe, rows = _qkv(block, block.attn_norm(h), freqs)
    kv = a.kv_b(rows[..., : m.kv_lora_rank]).unflatten(-1, (a.heads, -1))
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k_pe = rows[..., None, m.kv_lora_rank:].expand(*k_nope.shape[:-1], m.qk_rope_head_dim)
    q = torch.cat([q_nope, q_pe], dim=-1).transpose(1, 2)
    k = torch.cat([k_nope, k_pe], dim=-1).transpose(1, 2)
    o = tnn.attention(q, k, v.transpose(1, 2), bias=bias)          # (B, H, T, v)
    h = h + a.o(o.transpose(1, 2).flatten(-2))
    return ffn(block, h), rows


def decode_block(block: MLAMoEBlock, h, latent, layer_idx: int, slot: int, bias2, freqs):
    """One token a row (h (B, D)) through the block in the absorbed form:
    its latent row written at ``slot`` (a host int, or a (1,) int64 device
    tensor, as a CUDA graph of the step needs) of layer ``layer_idx`` of the
    cache (L, B, T, R + rope), in place; attention over the cache under
    ``bias2`` (B, T); RoPE by ``freqs`` (B, rope / 2)."""
    a, m = block.attn, block.m
    q_nope, q_pe, row = _qkv(block, block.attn_norm(h), freqs)
    if torch.is_tensor(slot):
        latent[layer_idx].index_copy_(1, slot, row.unsqueeze(1).to(latent.dtype))
    else:
        latent[layer_idx, :, slot] = row.to(latent.dtype)
    w_uk, w_uv = a.absorbed()
    q_lat = torch.bmm(q_nope.transpose(0, 1), w_uk).transpose(0, 1)  # (B, H, R)
    q_abs = torch.cat([q_lat, q_pe], dim=-1)
    o = mla_ops.mla_decode(q_abs, latent, bias2, layer_idx, m.kv_lora_rank,
                           1.0 / math.sqrt(m.qk_head_dim))
    o = torch.bmm(o.transpose(0, 1), w_uv).transpose(0, 1)          # (B, H, v)
    return ffn(block, h + a.o(o.flatten(-2)))


def positions(valid):
    """Each row's RoPE position of each column: the valid keys before it
    (valid (B, T) bool)."""
    return (torch.cumsum(valid.long(), dim=1) - 1).clamp_min(0)


def core_forward(core, h, key_valid):
    """The backbone over whole sequences (B, T, D) with ``key_valid`` (B, T),
    causal; ``core.ln_f`` of the result."""
    t = h.shape[1]
    bias = tnn.causal_bias(t, h.device) + tnn.key_padding_bias(key_valid)
    freqs = rope_freqs(positions(key_valid), core.blocks[0].m)
    for block in core.blocks:
        h, _ = full_block(block, h, bias, freqs)
    return core.ln_f(h)


# --------------------------------------------------------------- init


def init_block(gen, d: int, heads: int, m: MLAMoEConfig, layer: int, std: float = 0.02):
    """Seeded random parameters of one block: normal ``std`` for every
    product (the router too), ones for the norms, a normal selection bias of
    std 0.05 (nonzero, so that it moves the choice)."""
    dev = gen.device

    def w(*shape, s=std):
        return torch.randn(*shape, generator=gen, device=dev) * s

    r, rope = m.kv_lora_rank, m.qk_rope_head_dim
    tree = {
        "attn_norm": {"scale": torch.ones(d, device=dev)},
        "attn": {"q": {"w": w(d, heads * m.qk_head_dim)}, "kv_a": {"w": w(d, r + rope)},
                 "kv_norm": {"scale": torch.ones(r, device=dev)},
                 "kv_b": {"w": w(r, heads * (m.qk_nope_head_dim + m.v_head_dim))},
                 "o": {"w": w(heads * m.v_head_dim, d)}},
        "ffn_norm": {"scale": torch.ones(d, device=dev)},
    }
    if layer < m.first_k_dense_replace:
        f = m.intermediate_size
        tree["mlp"] = {"gate_up": {"w": w(d, 2 * f)}, "down": {"w": w(f, d)}}
    else:
        n, f = m.n_routed_experts, m.moe_intermediate_size
        fs = m.n_shared_experts * f
        tree["moe"] = {"router": {"w": w(d, n), "bias": w(n, s=0.05)},
                       "experts": {"gate_up": w(n, 2 * f, d), "down": w(n, d, f)},
                       "shared": {"gate_up": {"w": w(d, 2 * fs)}, "down": {"w": w(fs, d)}}}
    return tree
