"""Operations and bytes of the DeepSeek-V3 cell's work, from the
configuration's shapes and what the traced group served: the least time of
the two new kernels' calls, and the model FLOPs of the group.

Model FLOPs count useful work: each row's prefill over its valid prefix,
and the positions that gave the latents it emitted (the first from the
prefill); a token's backbone is its four attention products, attention over
the keys it attends (non-absorbed: q.k over nope + rope, p.v over v), the
dense SwiGLU (layer 0) or the router, 6 routed and 2 shared experts (the
other layers), and GenVC's mel head in float32. ContentVec, the content
dVAE, the Perceiver and HiFi-GAN are :mod:`perfbench.flops`'s.
"""

from __future__ import annotations

from perfbench import flops, weights_moonlight
from perfbench.reference import check

BF16 = 2


def _g(cfg: dict) -> dict:
    return weights_moonlight.gpt_group(cfg)


def expert_bytes(cfg: dict) -> int:
    """One routed expert's weights: gate, up and down, bf16."""
    g = _g(cfg)
    return 3 * g["model_dim"] * g["backbone"]["moe_intermediate_size"] * BF16


def token_flops(cfg: dict, keys: int) -> tuple[float, float]:
    """(backbone flops in bf16, head flops in float32) of one position that
    attends ``keys`` keys."""
    g = _g(cfg)
    m, d, h = g["backbone"], g["model_dim"], g["heads"]
    nope, rope, v, r = (m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"],
                        m["kv_lora_rank"])
    attn = 2 * d * h * (nope + rope) + 2 * d * (r + rope) + 2 * r * h * (nope + v) + 2 * h * v * d
    attn += 2 * h * keys * (nope + rope + v)
    f = m["moe_intermediate_size"]
    dense = 6 * d * m["intermediate_size"]
    mix = 2 * d * m["n_routed_experts"] + 6 * d * f * (m["num_experts_per_tok"]
                                                      + m["n_shared_experts"])
    k = m["first_k_dense_replace"]
    body = g["layers"] * attn + k * dense + (g["layers"] - k) * mix
    return body, 2 * d * g["num_audio_tokens"]


def prefix_keys(cfg: dict, n: int) -> int:
    return cfg["perceiver"]["latents"] + n + 2


def _emitted(cfg: dict, seg: dict) -> int:
    return check.n_valid(seg["tokens"], check.max_new(cfg, seg["n"]),
                         cfg["gpt"]["stop_audio_token"])


def group_peak_seconds(record: dict) -> float:
    """The traced group's model FLOPs at the card's peaks, in seconds."""
    cfg, grp = record["cfg"], record["group"]
    s = cfg["stream"]
    body = f32 = 0.0
    for row in grp["rows"]:
        f32 += flops.speaker_flops(cfg, row["ref_samples"])
        for r, ((_, t_real), seg) in enumerate(zip(check.segments(row["src"], cfg),
                                                   row["served"])):
            f32 += flops.content_flops(cfg, t_real)
            keys, m = prefix_keys(cfg, seg["n"]), _emitted(cfg, seg)
            for p in range(keys + 1):
                body += token_flops(cfg, p + 1)[0]
            for j in range(m):
                b, h = token_flops(cfg, keys + 1 + j)
                body, f32 = body + (b if j else 0.0), f32 + h
            first = s["first_chunk_tokens"] if r == 0 else s["chunk_tokens"]
            for a, e in check.windows(m, first, s["chunk_tokens"]):
                f32 += flops.vocoder_flops(cfg, e - a)
    return flops.seconds_at_peak(cfg, {cfg["gpt"]["dtype"]: body, "float32": f32})


def _moe_rows(record: dict) -> int:
    """Rows the expert kernel took in the traced group, summed over calls
    and mixture layers: each round's prefill over the group's static width
    and each decode step's rows."""
    grp = record["group"]
    g = _g(record["cfg"])
    per_layer = sum(grp["batch"] * (grp["prefix_width"] + 1) + grp["batch"] * r["steps"]
                    for r in grp["rounds"])
    return per_layer * (g["layers"] - g["backbone"]["first_k_dense_replace"])


def moe_bound_s(record: dict):
    """Least time of the traced group's ``moe_experts`` calls: the weights
    of every expert the routing chose, once a call (``moe.experts_touched``),
    and each row's input and output (bf16), indices and weights, at 3.35
    TB/s. None without the program's counter."""
    touched = record.get("counters", {}).get("moe.experts_touched")
    if not touched:
        return None
    g = _g(record["cfg"])
    k = g["backbone"]["num_experts_per_tok"]
    act = _moe_rows(record) * (2 * g["model_dim"] * BF16 + k * 8)
    return (touched * expert_bytes(record["cfg"]) + act) / flops.HBM_BYTES_S


def mla_bound_s(record: dict) -> float:
    """Least time of the traced group's ``mla_decode`` calls: per decode
    step and layer, each row's latent rows at its true length read once (its
    valid prefix, the start token and the steps so far, with their bias),
    the new row written, the absorbed queries read and the outputs written,
    at 3.35 TB/s."""
    cfg, grp = record["cfg"], record["group"]
    g = _g(cfg)
    m, h = g["backbone"], g["heads"]
    w = m["kv_lora_rank"] + m["qk_rope_head_dim"]
    total = 0.0
    for r in grp["rounds"]:
        for j in range(1, r["steps"] + 1):
            for n in r["n"]:
                keys = prefix_keys(cfg, n) + 1 + j
                total += keys * (w * BF16 + 4) + w * BF16
            total += grp["batch"] * h * (w + m["kv_lora_rank"]) * BF16
    return g["layers"] * total / flops.HBM_BYTES_S
