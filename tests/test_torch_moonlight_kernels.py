"""The DeepSeek-V3 backbone's kernels on the card against their plain
versions, at the published widths (Moonlight-16B-A3B): ``mla_decode``
(``csrc/mla_decode.cu``), ``moe_experts`` (``csrc/moe_experts.cu``) and the
RMS mode of ``csrc/layer_norm.cu``. Each skips without a CUDA device. The
file imports no JAX, so on the card it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_moonlight_kernels.py -q
"""

import math

import pytest
import torch

from genvc_tpu_torch import tracing
from genvc_tpu_torch.ops import mla, moe
from genvc_tpu_torch.ops import nn as tnn

D, H, NOPE, ROPE, V, R = 2048, 16, 128, 64, 128, 512
E, K, F = 64, 6, 1408


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,t", [(8, 384), (1, 1024), (8, 100)])
def test_mla_decode_matches_plain(card, b, t):
    """f32 logits, softmax and P.C sums in another order than the plain
    version's: bf16 out within 2 bf16 ulps of it (2^-7 relative), and each
    call one count and two launches."""
    g = torch.Generator(device=card).manual_seed(b * t)
    cache = torch.randn(3, b, t, R + ROPE, generator=g, device=card).to(torch.bfloat16)
    q = (torch.randn(b, H, R + ROPE, generator=g, device=card) * 0.3).to(torch.bfloat16)
    valid = torch.rand(b, t, generator=g, device=card) < 0.8
    valid[:, 0] = True
    bias = torch.where(valid, 0.0, -1e9)
    scale = 1.0 / math.sqrt(NOPE + ROPE)
    before = mla.mla_decode.launches
    got = mla.mla_decode(q, cache, bias, 1, R, scale)
    torch.cuda.synchronize()
    want = mla.mla_decode_plain(q, cache, bias, 1, R, scale)
    assert mla.mla_decode.launches - before == 1
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=2e-3)


def _experts(m, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(m, D, generator=g, device=device).to(torch.bfloat16)
    w1 = (torch.randn(E, 2 * F, D, generator=g, device=device) * 0.02).to(torch.bfloat16)
    w2 = (torch.randn(E, D, F, generator=g, device=device) * 0.02).to(torch.bfloat16)
    idx = torch.argsort(torch.rand(m, E, generator=g, device=device), dim=-1)[:, :K]
    w = torch.rand(m, K, generator=g, device=device)
    return x, idx, w, w1, w2


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 2000])
def test_moe_experts_matches_plain(card, m):
    """Each rounding point of the plain version is the kernel's; the f32
    sums run in another order, so a rounded intermediate may land one bf16
    ulp apart. The widest such step is a down output z (|z| < 1, its ulp at
    most 2^-7) times its weight (< 1): y within 2^-7 absolute plus 2^-6
    relative (on the card: 49 of 4.1M elements past 2e-3, at most 0.0064)."""
    x, idx, w, w1, w2 = _experts(m, m, card)
    before = moe.moe_experts.launches
    got = moe.moe_experts(x, idx, w, w1, w2)
    torch.cuda.synchronize()
    want = moe.moe_experts_plain(x, idx, w, w1, w2)
    assert moe.moe_experts.launches - before == 1
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -6, atol=2 ** -7)


@pytest.mark.cuda
def test_moe_experts_counts_the_experts_chosen(card):
    """With the recorder on, the device counter holds the distinct experts
    of each call, read once by ``flush_touched``."""
    x, idx, w, w1, w2 = _experts(8, 3, card)
    tracing.reset()
    tracing.enable()
    try:
        moe.moe_experts(x, idx, w, w1, w2)
        moe.moe_experts(x[:1], idx[:1], w[:1], w1, w2)
        moe.flush_touched()
        counters = tracing.snapshot()["counters"]
    finally:
        tracing.disable()
    assert counters["moe.experts_touched"] == len(set(idx.reshape(-1).tolist())) + K
    assert counters["ops.moe_experts.kernel"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,ld", [(8, 2048, 2048), (2000, 2048, 2048), (8, 512, 576),
                                       (920, 512, 576)])
def test_rms_norm_kernel_matches_plain(card, rows, d, ld):
    """One launch a call, rows of x read ``ld`` apart (MLA's latent slice);
    the sum of squares in another order: within one bf16 ulp."""
    g = torch.Generator(device=card).manual_seed(rows + d)
    full = (torch.randn(rows, ld, generator=g, device=card) * 3).to(torch.bfloat16)
    x = full[:, :d]
    scale = (1 + 0.1 * torch.randn(d, generator=g, device=card)).to(torch.bfloat16)
    before = tnn.rms_norm.launches
    got = tnn.rms_norm(x, scale)
    torch.cuda.synchronize()
    assert tnn.rms_norm.launches - before == 1 and got.is_contiguous()
    torch.testing.assert_close(got.float(), tnn.rms_norm_plain(x, scale).float(),
                               rtol=2 ** -7, atol=1e-6)


def _small_gpt(device):
    """The GPT of a small Moonlight-shaped pipeline in bf16 on ``device``
    (3 layers of width 64, 4 heads, kv_lora 32, 8 experts, top 2)."""
    from genvc_tpu_torch.config import MLAMoEConfig
    from genvc_tpu_torch.inference import pipeline

    small = MLAMoEConfig(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                         v_head_dim=16, intermediate_size=128, moe_intermediate_size=32,
                         n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1)
    cfg = pipeline.flagship_config()
    ma = cfg.model_args
    ma.gpt_layers, ma.gpt_n_model_channels, ma.gpt_n_heads = 3, 64, 4
    cd = cfg.content_dvae_config
    cd.num_tokens, cd.codebook_dim, cd.hidden_dim, cd.num_resnet_blocks = 64, 32, 32, 1
    cfg.vocoder_config.input_feat_dim, cfg.vocoder_config.upsample_initial_channel = 64, 32
    tree = pipeline.random_tree(cfg, 3, device, contentvec_layers=2, backbone=small)
    pipe = pipeline.build_pipeline(tree, cfg, device=device, dtype=torch.bfloat16,
                                   backbone=small)
    return pipe.gpt, pipe.gpt_cfg


@pytest.mark.cuda
def test_latent_step_graph_replays_the_op_by_op_step(card, monkeypatch):
    """Two lockstep states of one shape, stepped in turns through the step's
    CUDA graph (the first step op by op, the second captured, the rest
    replayed; each state adopts the graph's cache from the other), give the
    tokens and latents of each state stepped alone op by op: the same
    kernels on the same inputs, so equal to the bit. The launch counters
    count each replayed kernel."""
    from genvc_tpu_torch.decode import engine
    from genvc_tpu_torch.models import gpt as gpt_model

    model, gcfg = _small_gpt(card)
    sampler = engine.SamplerConfig(top_k=1, repetition_penalty=2.0, do_sample=False)

    def start(seed):
        g = torch.Generator(device=card).manual_seed(seed)
        cond = (torch.randn(2, 32, 64, generator=g, device=card) * 0.1).to(torch.bfloat16)
        codes = torch.randint(0, 64, (2, 12), generator=g, device=card)
        prefix, valid = gpt_model.build_prefix_emb(model, cond, codes,
                                                   torch.tensor([5, 12], device=card))
        state = engine.init_state(gcfg, prefix.shape[1], 2, card,
                                  cache_dtype=torch.bfloat16, gen_tokens=16)
        engine.prefill(model, state, prefix, valid, sampler)
        return state

    def run(order):
        states = {s: start(s) for s in (1, 2)}
        out = {1: [], 2: []}
        for s, k in order:
            toks, lats, _ = engine.decode_chunk(model, states[s], sampler, chunk=k)
            out[s].append((toks, lats))
        return {s: (torch.cat([t for t, _ in v], 1), torch.cat([x for _, x in v], 1))
                for s, v in out.items()}

    with torch.inference_mode():
        monkeypatch.setattr(engine, "LATENT_GRAPH", False)
        want = run([(1, 6), (2, 6)])
        monkeypatch.setattr(engine, "LATENT_GRAPH", True)
        before = mla.mla_decode.launches
        got = run([(1, 3), (2, 2), (1, 3), (2, 4)])
        torch.cuda.synchronize()
    assert mla.mla_decode.launches - before == 12 * 3
    assert model._latent_graphs, "the step ran op by op"
    for s in (1, 2):
        assert torch.equal(got[s][0], want[s][0])
        assert torch.equal(got[s][1], want[s][1])
