"""The DeepSeek-V3 backbone (``models/mla_moe.py``) behind GenVC on the CPU,
held to the benchmark's plain reference (``perfbench/reference/moonlight.py``,
the same file that decides the cell's ``correct`` on the card) at a small
Moonlight-shaped size: 3 layers (1 dense + 2 mixture) of width 64, 4 heads,
nope 16, rope 8, v 16, kv_lora 32, 8 experts with top 2, 1 shared.

Everything runs in float32: the port's plain versions of its kernels
against the reference's equations, so the tolerances are float32 round-off
of different summation orders (absorbed against non-absorbed attention,
grouped against per-position experts).
"""

import json
import os

import numpy as np
import pytest
import torch

from genvc_tpu_torch import checkpoint as ckpt
from genvc_tpu_torch.config import MLAMoEConfig
from genvc_tpu_torch.decode import engine
from genvc_tpu_torch.inference import pipeline
from genvc_tpu_torch.models import gpt as gpt_model
from genvc_tpu_torch.models import mla_moe
from genvc_tpu_torch.ops import mla, moe
from genvc_tpu_torch.ops import nn as tnn
from perfbench.reference import moonlight

SMALL = MLAMoEConfig(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                     intermediate_size=128, moe_intermediate_size=32, n_routed_experts=8,
                     num_experts_per_tok=2, n_shared_experts=1)


def _config():
    cfg = pipeline.flagship_config()
    ma = cfg.model_args
    ma.gpt_layers, ma.gpt_n_model_channels, ma.gpt_n_heads = 3, 64, 4
    cd = cfg.content_dvae_config
    cd.num_tokens, cd.codebook_dim, cd.hidden_dim, cd.num_resnet_blocks = 64, 32, 32, 1
    cfg.vocoder_config.input_feat_dim, cfg.vocoder_config.upsample_initial_channel = 64, 32
    return cfg


@pytest.fixture(scope="module")
def small():
    cfg = _config()
    tree = pipeline.random_tree(cfg, 3, "cpu", contentvec_layers=2, backbone=SMALL)
    pipe = pipeline.build_pipeline(tree, cfg, device="cpu", backbone=SMALL)
    pipe.gen_cap_tokens_per_code = 1.875
    return cfg, tree, pipe


def _ref_g(gcfg: gpt_model.GPTConfig) -> dict:
    """The reference's view of the GPT configuration."""
    m = gcfg.mla_moe
    return {"heads": gcfg.heads, "start_text_token": gcfg.start_text_token,
            "stop_text_token": gcfg.stop_text_token, "start_audio_token": gcfg.start_audio_token,
            "backbone": {f: getattr(m, f) for f in m.__dataclass_fields__}}


def test_prefill_then_decode_through_the_latent_cache_matches_the_full_forward(small):
    """Two rows of different prefix lengths (padded columns in the static
    prefix shift each row's RoPE positions): the prefill's logits and each
    teacher-forced step's through the cache against the reference's full
    causal forward of each row alone. Tolerance 2e-4 absolute on logits of
    O(1): float32 sums in other orders (absorbed attention, grouped experts)
    over 3 layers."""
    _, tree, pipe = small
    model, gcfg = pipe.gpt, pipe.gpt_cfg
    g = torch.Generator().manual_seed(7)
    cond = torch.randn(2, 32, 64, generator=g) * 0.1
    n = [5, 9]
    codes = torch.zeros(2, 12, dtype=torch.long)
    for i, k in enumerate(n):
        codes[i, :k] = torch.randint(0, 64, (k,), generator=g)
    audio = torch.randint(0, 1024, (2, 6), generator=g)
    prefix, valid = gpt_model.build_prefix_emb(model, cond, codes, torch.tensor(n))
    state = engine.init_state(gcfg, prefix.shape[1], 2, "cpu", cache_dtype=torch.float32,
                              gen_tokens=8)
    assert state.latent.shape == (3, 2, 128, 32 + 8) and state.cache_k is None
    _, logits0 = engine.prefill_logits(model, state, prefix, valid)
    got = [logits0]
    for j in range(audio.shape[1]):
        state.last_token = audio[:, j]
        state.n_generated += 1
        _, lg = engine._decode_forward(model, state)
        state.cur_index += 1
        got.append(lg)
    got = torch.stack(got, 1)                                   # (2, 7, V)
    for i, k in enumerate(n):
        _, want, _ = moonlight.gpt_forward(tree["gpt"], _ref_g(gcfg), cond[i], codes[i, :k],
                                           audio[i])
        torch.testing.assert_close(got[i], want, rtol=0, atol=2e-4)


def test_absorbed_mla_oracle_matches_the_non_absorbed_form():
    """softmax((W_UK^T q_nope) . c + q_pe . k_pe) . c then W_UV equals
    attention over k = [W_UK c | k_pe], v = W_UV c; float32 round-off."""
    g = torch.Generator().manual_seed(1)
    b, t, h, nope, rope, v, r = 2, 11, 4, 16, 8, 16, 32
    c = torch.randn(b, t, r, generator=g)
    k_pe = torch.randn(b, t, rope, generator=g)
    w_uk = torch.randn(h, nope, r, generator=g) * 0.2
    w_uv = torch.randn(h, r, v, generator=g) * 0.2
    q_nope = torch.randn(b, h, nope, generator=g)
    q_pe = torch.randn(b, h, rope, generator=g)
    valid = torch.ones(b, t, dtype=torch.bool)
    valid[0, 7:] = False
    bias = torch.where(valid, 0.0, -1e9)
    scale = 1.0 / np.sqrt(nope + rope)
    q_abs = torch.cat([torch.einsum("bhn,hnr->bhr", q_nope, w_uk), q_pe], -1)
    cache = torch.cat([c, k_pe], -1)[None]
    o = mla.mla_decode(q_abs, cache, bias, 0, r, scale)
    got = torch.einsum("bhr,hrv->bhv", o, w_uv)
    k = torch.cat([torch.einsum("hnr,btr->bhtn", w_uk, c),
                   k_pe[:, None].expand(b, h, t, rope)], -1)
    vv = torch.einsum("hrv,btr->bhtv", w_uv, c)
    s = torch.einsum("bhd,bhtd->bht", torch.cat([q_nope, q_pe], -1), k) * scale + bias[:, None]
    want = torch.einsum("bht,bhtv->bhv", torch.softmax(s, -1), vv)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_routing_and_experts_match_the_reference(small):
    """The port's router (selection bias in the choice, chosen scores over
    their sum times the scaling factor) and its grouped experts with the
    shared expert against the reference's mixture layer."""
    _, tree, pipe = small
    block = pipe.gpt.core.blocks[1]
    m = block.m
    g = torch.Generator().manual_seed(2)
    x = torch.randn(9, 64, generator=g)
    idx, w = mla_moe.route(x, block.moe.router, m)
    ref_p = tree["gpt"]["core"]["blocks"][1]["moe"]
    out, ref_idx, *_ = moonlight.moe(ref_p, x, {f: getattr(m, f) for f in m.__dataclass_fields__})
    assert torch.equal(torch.sort(idx, 1).values, torch.sort(ref_idx, 1).values)
    torch.testing.assert_close(w.sum(-1), torch.full((9,), m.routed_scaling_factor))
    bias_moves = torch.topk(torch.sigmoid(x @ ref_p["router"]["w"]), 2).indices
    assert not torch.equal(torch.sort(bias_moves, 1).values, torch.sort(idx, 1).values)
    got = moe.moe_experts(x, idx, w, block.moe.experts.gate_up, block.moe.experts.down)
    torch.testing.assert_close(got + block.moe.shared(x), out, rtol=1e-5, atol=1e-5)


def test_rms_norm_reads_strided_rows_on_the_cpu():
    x = torch.randn(3, 5, 40)
    s = torch.rand(32) + 0.5
    want = moonlight.rms_norm(x[..., :32], s, 1e-5)
    torch.testing.assert_close(tnn.rms_norm(x[..., :32], s), want)


def test_streaming_batch_end_to_end_at_two_rows(small):
    """Two callers in lockstep (one of two segments) through the cache; each
    row's audio is the single-caller stream's, and the spans are there."""
    from genvc_tpu_torch import tracing

    _, _, pipe = small
    rng = np.random.default_rng(0)
    srcs = [rng.standard_normal((1, 9600)).astype(np.float32) * 0.1,
            rng.standard_normal((1, 16000 * 6 + 4000)).astype(np.float32) * 0.1]
    refs = [rng.standard_normal((1, 24000)).astype(np.float32) * 0.1] * 2
    tracing.reset()
    tracing.enable()
    try:
        wavs, lat, _ = pipe.synthesize_streaming_batch(srcs, refs, verbose=False)
        moe.flush_touched()
        snap = tracing.snapshot()
    finally:
        tracing.disable()
    names = {s["name"] for s in snap["spans"]}
    assert {"genvc.cond_latents", "genvc.prefill", "genvc.decode", "genvc.decode.enqueue",
            "genvc.decode.readback", "genvc.vocode"} <= names
    assert snap["counters"]["moe.experts_touched"] > 0
    assert all(w.size > 0 for w in wavs) and all(t is not None for t in lat)
    one, _, _ = pipe.synthesize_streaming(srcs[0], refs[0], verbose=False)
    np.testing.assert_allclose(wavs[0][: one.size], one, atol=1e-5)


def test_each_path_the_backbone_does_not_take_raises(small):
    cfg, tree, pipe = small
    from genvc_tpu_torch.serving.server import StreamServer

    codes = torch.zeros(1, 80, dtype=torch.long)
    pipe._cond_latent = torch.zeros(1, 32, 64)
    cases = [
        lambda: StreamServer(pipe, slots=2),
        lambda: pipe.generate_segment_codes(codes, 10, num_beams=2),
        lambda: pipe.generate_segment_codes(codes, 10, num_beams=2, num_beam_groups=2),
        lambda: pipe.generate_segment_codes(codes, 10, penalty_alpha=0.6),
        lambda: engine.decode_constrained(pipe.gpt, None, None, None, 8, 2, [[1]]),
        lambda: pipeline.build_pipeline(tree, cfg, device="cpu", quantize="int8",
                                        backbone=SMALL),
        lambda: pipeline.build_pipeline(tree, cfg, device="cpu", kv_cache_dtype="fp8",
                                        backbone=SMALL),
        lambda: gpt_model.GPT(ckpt.gpt_config(cfg, SMALL), n_model=2),
        lambda: gpt_model.forward_train(pipe.gpt, codes, torch.tensor([10]),
                                        torch.zeros(1, 8, dtype=torch.long),
                                        torch.tensor([8000]), cond_latents=torch.zeros(1, 32, 64)),
    ]
    for case in cases:
        with pytest.raises(NotImplementedError, match=mla_moe.BACKBONE):
            case()


def test_the_benchmark_config_builds_the_published_backbone():
    """The cell's configuration file maps onto the port's config: every
    width and the depth as published (the model is built on the meta
    device, no memory)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "perfbench", "configs", "genvc-moonlight-bf16.json")) as f:
        raw = json.load(f)
    cfg = _config()
    ma = cfg.model_args
    ma.gpt_layers, ma.gpt_n_model_channels, ma.gpt_n_heads = (
        raw["num_hidden_layers"], raw["hidden_size"], raw["num_attention_heads"])
    backbone = MLAMoEConfig(**{k: raw[k] for k in MLAMoEConfig.__dataclass_fields__})
    with torch.device("meta"):
        model = gpt_model.GPT(ckpt.gpt_config(cfg, backbone))
    n = sum(p.numel() for p in model.core.parameters())
    assert 15.28e9 < n < 15.30e9
    assert model.core.blocks[0].mlp.gate_up.w.shape == (2048, 2 * 11264)
    assert model.core.blocks[5].moe.experts.gate_up.shape == (64, 2 * 1408, 2048)
