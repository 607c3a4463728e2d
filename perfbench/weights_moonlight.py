"""Seeded random weights of the GenVC model set around the DeepSeek-V3
backbone (``configs/genvc-moonlight-bf16.json``), and the configuration's
views that the program and the reference read.

The GPT family (the backbone's blocks, GenVC's tables, heads and Perceiver)
is drawn leaf by leaf in bf16 on the device, 30.6 GB whole: the float32
buffers of :func:`perfbench.weights.draw` would need 61 GB. Each leaf is its
own allocation (16-byte aligned, as the expert kernel reads it). The other
families are :func:`perfbench.weights.draw`'s, float32, from the same seed.
Distributions: normal, std 0.02, for every product of the backbone
(DeepSeek-V3's ``initializer_range``), ones for its norms, a normal
selection bias of std 0.05; GenVC's tables, heads and Perceiver as
:func:`perfbench.weights.gpt_spec` draws them.
"""

from __future__ import annotations

import torch

from perfbench import weights

STD = 0.02
BIAS_STD = 0.05
_BACKBONE_KEYS = ("kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
                  "rope_theta", "intermediate_size", "moe_intermediate_size",
                  "n_routed_experts", "num_experts_per_tok", "n_shared_experts",
                  "first_k_dense_replace", "routed_scaling_factor", "norm_topk_prob",
                  "rms_norm_eps")


def gpt_group(cfg: dict) -> dict:
    """The configuration's ``gpt`` group with the backbone's numbers under
    ``backbone`` (the reference's ``g``)."""
    for key, want in (("n_group", 1), ("topk_group", 1), ("q_lora_rank", None),
                      ("scoring_func", "sigmoid"), ("hidden_act", "silu")):
        if cfg[key] != want:
            raise ValueError(f"{key} {cfg[key]!r}: only {want!r} is built")
    g = dict(cfg["gpt"])
    g.update(layers=cfg["num_hidden_layers"], model_dim=cfg["hidden_size"],
             heads=cfg["num_attention_heads"],
             backbone={k: cfg[k] for k in _BACKBONE_KEYS})
    return g


def block_spec(m: dict, d: int, heads: int, layer: int) -> dict:
    def w(*shape):
        return (shape, "n", STD)

    r, rope = m["kv_lora_rank"], m["qk_rope_head_dim"]
    qk = m["qk_nope_head_dim"] + rope
    spec = {
        "attn_norm": {"scale": ((d,), "1", 1.0)},
        "attn": {"q": {"w": w(d, heads * qk)}, "kv_a": {"w": w(d, r + rope)},
                 "kv_norm": {"scale": ((r,), "1", 1.0)},
                 "kv_b": {"w": w(r, heads * (m["qk_nope_head_dim"] + m["v_head_dim"]))},
                 "o": {"w": w(heads * m["v_head_dim"], d)}},
        "ffn_norm": {"scale": ((d,), "1", 1.0)},
    }
    if layer < m["first_k_dense_replace"]:
        f = m["intermediate_size"]
        spec["mlp"] = {"gate_up": {"w": w(d, 2 * f)}, "down": {"w": w(f, d)}}
    else:
        e, f = m["n_routed_experts"], m["moe_intermediate_size"]
        fs = m["n_shared_experts"] * f
        spec["moe"] = {"router": {"w": w(d, e), "bias": ((e,), "n", BIAS_STD)},
                       "experts": {"gate_up": w(e, 2 * f, d), "down": w(e, d, f)},
                       "shared": {"gate_up": {"w": w(d, 2 * fs)}, "down": {"w": w(fs, d)}}}
    return spec


def gpt_spec(cfg: dict) -> dict:
    g = gpt_group(cfg)
    d, m = g["model_dim"], g["backbone"]
    spec = weights.gpt_spec({**g, "layers": 1}, cfg["perceiver"])
    spec["core"] = {"blocks": [block_spec(m, d, g["heads"], i) for i in range(g["layers"])],
                    "ln_f": {"scale": ((d,), "1", 1.0)}}
    return spec


def inference_spec(cfg: dict) -> dict:
    return {"gpt": gpt_spec(cfg), "hifigan": weights.hifigan_spec(cfg["hifigan"]),
            "content_dvae": weights.dvae_spec(cfg["content_dvae"]),
            "contentvec": weights.contentvec_spec(cfg["contentvec"])}


def _draw_bf16(spec, gen, device):
    if isinstance(spec, dict):
        return {k: _draw_bf16(v, gen, device) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_draw_bf16(v, gen, device) for v in spec]
    shape, kind, scale = spec
    t = torch.empty(shape, dtype=torch.bfloat16, device=device)
    if kind == "n":
        return t.normal_(0.0, scale, generator=gen)
    if kind == "u":
        return t.uniform_(-scale, scale, generator=gen)
    return t.fill_(1.0 if kind == "1" else 0.0)


def draw(cfg: dict, seed: int, device) -> dict:
    """The inference tree of ``seed``: the GPT family bf16, the rest f32."""
    spec = inference_spec(cfg)
    tree = weights.draw({k: v for k, v in spec.items() if k != "gpt"}, seed, device)
    gen = torch.Generator(device=device).manual_seed(weights.torch_seed(seed + 1))
    tree["gpt"] = _draw_bf16(spec["gpt"], gen, device)
    return tree
