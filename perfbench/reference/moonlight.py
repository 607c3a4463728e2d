"""Plain PyTorch reference of the DeepSeek-V3 backbone (Moonlight-16B-A3B's
block) behind GenVC's front end, on the weight tree.

Written from the model's equations for this benchmark; it imports neither
JAX nor the program. float32 throughout (the caller keeps TF32 off,
:func:`perfbench.reference.model.full_precision`), one utterance at a time,
no kernels, no cache and no batching: a full causal forward over
[speaker latents | text | audio tokens] gives every position's logits,
latents and routing at once. The tree may hold bf16 values: each block's
leaves are upcast to float32 as the block runs, one block at a time (the
whole backbone in float32 would be 61 GB).

For a layer with input h at positions p = 0, 1, ...:
  x = RMSNorm(h; g1); q = x W_q = [q_nope | q_pe] per head;
  [c | k_pe] = x W_kva, c = RMSNorm(c; g_kv); q_pe, k_pe rotated on the
  interleaved pairs (2i, 2i + 1) at angle p * theta^(-2i / rope);
  [k_nope | v] per head = c W_kvb; causal softmax at scale 1 / sqrt(nope +
  rope); h += concat_h(o_h) W_o.
  x = RMSNorm(h; g2); layer < first_k_dense_replace: h += down(silu(gate x) *
  up x); else s = sigmoid(x W_r), the top-k of s + b, w = s_chosen / sum *
  routed_scaling_factor, h += sum_i w_i E_i(x) + S(x).
A final RMSNorm, then GenVC's final LayerNorm and mel head.

Departures from the published Moonlight-16B-A3B, all of the configuration:
its 163840-token embedding and LM head are GenVC's text and audio tables,
learned position tables and heads; the RoPE inside the blocks sits beside
GenVC's position tables, and a position counts the sequence's valid keys
(GenVC's prefix pads nothing here); the latents GenVC vocodes are its
final LayerNorm over the backbone's final RMSNorm. ``n_group`` =
``topk_group`` = 1, so the grouped top-k of ``noaux_tc`` is a plain top-k.

``expert_mm`` is the product of the routed experts' weights: the reference
passes :func:`f32_mm`; the control passes :func:`e4m3_rows`, which rounds the
weights to float8 e4m3 with a scale per output neuron (the next precision
below the bf16 they are served in).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import model as ref

E4M3_MAX = 448.0


def f32_mm(x, w_rows):
    """x (n, in) by weights stored a row per output neuron (out, in)."""
    return x @ w_rows.T


def e4m3_rows(x, w_rows):
    scale = w_rows.abs().amax(dim=1, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return x @ ((w_rows / scale).to(torch.float8_e4m3fn).float() * scale).T


def f32_tree(node):
    """A tree's leaves as float32 (each a new tensor where it was not)."""
    if isinstance(node, dict):
        return {k: f32_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [f32_tree(v) for v in node]
    return node.float()


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale


def rope(x, pos, m):
    """x (T, ..., rope) rotated at positions pos (T,): interleaved pairs."""
    r = m["qk_rope_head_dim"]
    inv = 1.0 / (m["rope_theta"] ** (torch.arange(0, r, 2, device=x.device,
                                                  dtype=torch.float32) / r))
    ang = pos.float()[:, None] * inv                                   # (T, r / 2)
    rot = torch.polar(torch.ones_like(ang), ang).view(ang.shape[0], *([1] * (x.dim() - 2)),
                                                      -1)
    xc = torch.view_as_complex(x.reshape(*x.shape[:-1], -1, 2).contiguous())
    return torch.view_as_real(xc * rot).flatten(-2)


def attention(bp, x, pos, m, heads):
    """The MLA sub-layer's output (T, D) for normalised inputs x (T, D)."""
    a = bp["attn"]
    t = x.shape[0]
    nope, r = m["qk_nope_head_dim"], m["kv_lora_rank"]
    q = (x @ a["q"]["w"]).view(t, heads, -1)
    q_nope, q_pe = q[..., :nope], rope(q[..., nope:], pos, m)
    kva = x @ a["kv_a"]["w"]
    c = rms_norm(kva[:, :r], a["kv_norm"]["scale"], m["rms_norm_eps"])
    k_pe = rope(kva[:, r:], pos, m)
    kv = (c @ a["kv_b"]["w"]).view(t, heads, -1)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    qh = torch.cat([q_nope, q_pe], -1).transpose(0, 1)                 # (H, T, 192)
    kh = torch.cat([k_nope, k_pe[:, None].expand(t, heads, k_pe.shape[-1])], -1).transpose(0, 1)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    o = ref.attention(qh, kh, v.transpose(0, 1), causal)               # (H, T, v)
    return ref.unheads(o) @ a["o"]["w"]


def swiglu(p, x):
    g, u = (x @ p["gate_up"]["w"]).chunk(2, dim=-1)
    return (F.silu(g) * u) @ p["down"]["w"]


def judged_experts(sel, forced, k: int, tie: float):
    """The experts a check reads at each position: the judged side's
    ``forced`` (T, k) where each of them scores within ``tie`` of the k-th
    best selection score ``sel`` (T, E) gives (a near tie that round-off may
    break either way), else the reference's own top-k. Returns (experts (T,
    k), taken (T,) bool: the forced set was judged sound, same (T,) bool:
    it is the reference's own set, below (T,): how far the forced set's
    lowest score lies under the k-th, 0 where it is the reference's own)."""
    top = torch.topk(sel, k, dim=-1)
    own = top.indices
    if forced is None:
        ones = torch.ones(sel.shape[0], dtype=torch.bool, device=sel.device)
        return own, ones, ones, torch.zeros(sel.shape[0], device=sel.device)
    forced = torch.as_tensor(forced, device=sel.device).long()
    below = (top.values[:, -1] - sel.gather(-1, forced).min(-1).values).clamp_min(0)
    taken = below <= tie
    same = (torch.sort(forced, -1).values == torch.sort(own, -1).values).all(-1)
    return torch.where(taken[:, None], forced, own), taken, same, below


def moe(p, x, m, expert_mm=f32_mm, forced=None, tie=0.0):
    """(T, D) -> (output (T, D), experts used (T, k), selection scores of
    the k + 1 best, best first (T, k + 1), taken (T,), same (T,), below
    (T,)): with ``forced``, the judged side's experts where
    :func:`judged_experts` takes them."""
    k = m["num_experts_per_tok"]
    s = torch.sigmoid(x @ p["router"]["w"])
    sel = torch.topk(s + p["router"]["bias"], k + 1, dim=-1)
    idx, taken, same, below = judged_experts(s + p["router"]["bias"], forced, k, tie)
    w = s.gather(-1, idx)
    if m["norm_topk_prob"]:
        w = w / w.sum(dim=-1, keepdim=True)
    w = w * m["routed_scaling_factor"]
    out = swiglu(p["shared"], x)
    ex = p["experts"]
    f = ex["down"].shape[-1]
    for e in torch.unique(idx).tolist():
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        gu = expert_mm(x[rows], ex["gate_up"][e].float())
        h = F.silu(gu[:, :f]) * gu[:, f:]
        out = out.index_add(0, rows, w[rows, slot, None] * expert_mm(h, ex["down"][e].float()))
    return out, idx, sel.values, taken, same, below


def block(bp, h, pos, m, heads, layer, expert_mm=f32_mm, forced=None, tie=0.0):
    """One layer over a sequence h (T, D); the routing of a mixture layer
    (:func:`moe`'s experts used, scores, taken, same, below) or None."""
    eps = m["rms_norm_eps"]
    h = h + attention(bp, rms_norm(h, bp["attn_norm"]["scale"], eps), pos, m, heads)
    x = rms_norm(h, bp["ffn_norm"]["scale"], eps)
    if layer < m["first_k_dense_replace"]:
        return h + swiglu(bp["mlp"], x), None
    out, *routing = moe(bp["moe"], x, m, expert_mm, forced, tie)
    return h + out, tuple(routing)


def gpt_forward(p, g, cond, codes, audio_in, expert_mm=f32_mm, forced=None, tie=0.0):
    """Causal forward over [cond | start_text, codes, stop_text | start_audio,
    audio_in]: (cond (32, D), codes (n,), audio_in (m,)) -> (latents (m + 1,
    D), logits (m + 1, V), routing): row j belongs to the position whose
    input is start_audio (j = 0) or audio_in[j - 1]. ``routing`` holds, per
    mixture layer, :func:`moe`'s experts used, selection scores, taken, same
    and below, over every position. ``forced``: per mixture layer the judged
    side's experts at every position (or None), read where they lie within
    ``tie`` (:func:`judged_experts`). ``p`` is the GPT's tree in any float
    type; ``g`` its configuration (``g["backbone"]`` the backbone's)."""
    m = g["backbone"]
    dev = cond.device
    emb = {k: p[k].float() for k in ("text_embedding", "text_pos", "mel_embedding", "mel_pos")}
    text = torch.cat([torch.tensor([g["start_text_token"]], device=dev), codes,
                      torch.tensor([g["stop_text_token"]], device=dev)])
    audio = torch.cat([torch.tensor([g["start_audio_token"]], device=dev), audio_in])
    x = torch.cat([cond.float(),
                   emb["text_embedding"][text] + emb["text_pos"][: text.shape[0]],
                   emb["mel_embedding"][audio] + emb["mel_pos"][: audio.shape[0]]])
    pos = torch.arange(x.shape[0], device=dev)
    routing = []
    for i, bp in enumerate(p["core"]["blocks"]):
        f = None
        if forced is not None and i >= m["first_k_dense_replace"]:
            f = forced[i - m["first_k_dense_replace"]][: x.shape[0]]
        x, r = block(f32_tree(bp), x, pos, m, g["heads"], i, expert_mm, f, tie)
        if r is not None:
            routing.append(r)
    x = rms_norm(x, p["core"]["ln_f"]["scale"].float(), m["rms_norm_eps"])
    lat = ref.layer_norm(f32_tree(p["final_norm"]), x[-audio.shape[0]:])
    head = f32_tree(p["mel_head"])
    return lat, ref.linear(head, lat), routing
