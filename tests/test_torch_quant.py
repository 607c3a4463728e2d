"""Quantized serving in the port against the JAX package, on the CPU: int8
W8A8 GPT linears (``ops.quant``) and the fp8 (e4m3) KV cache.

* ``quantize_linear``: int8 weights and scales bit-equal to JAX's on the same
  f32 weights, per layer of a stacked (L, in, out) leaf.
* ``linear_q8`` on identical f32 and bf16 inputs (the cases of
  ``tests/test_quant.py``): int8 activations and int32 accumulators equal,
  outputs within 1e-6 relative (both sides take the same steps in the same
  order; the sums of the f32 rescale differ at most by rounding).
* ``quantize_gpt`` swaps exactly the linears ``quantize_gpt_params`` quantizes.
* The synthetic bundle in f32, greedy, cap 1.0: with ``quantize="int8"``,
  with ``kv_cache_dtype="fp8"`` and with both, the port's decode gives the
  JAX engine's tokens (latents within 1e-5), and its streaming, offline and
  served audio is within 1e-3 of the JAX package's.
* The fp8 cache under an f32 GPT: on CPU tensors the port attends in f32
  over the cache widened by ``from_e4m3`` (0x7F / 0xFF read as +-480, never
  NaN); the card's kernels round q and the probabilities to bf16, within
  the bound ``decode_attention.bf16_rounding_bound`` works out from that
  rounding, and with those numerics (their plain versions, on the CPU) the
  decode keeps JAX's tokens and streaming audio within 1e-3.
* A bf16 GPT with int8 linears and an fp8 cache: prefill logits within 0.05
  relative of JAX's same configuration (the bound of bf16 rounding that
  ``tests/test_quant.py`` states against full precision; the measured error
  is printed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genvc_tpu.decode import engine as jeng
from genvc_tpu.models import gpt as jgpt
from genvc_tpu.ops import quant as jquant
from genvc_tpu_torch.decode import engine as teng
from genvc_tpu_torch.inference import pipeline as tpipe
from genvc_tpu_torch.models import gpt as tgpt
from genvc_tpu_torch.ops import nn as tnn
from genvc_tpu_torch.ops import quant as tquant

GREEDY = dict(temperature=1.0, top_k=1, top_p=1.0, repetition_penalty=1.0,
              do_sample=False)
MODES = {"int8": dict(quantize="int8"), "fp8": dict(kv_cache_dtype="fp8"),
         "int8_fp8": dict(quantize="int8", kv_cache_dtype="fp8")}


def _jax_acc(p, x):
    """JAX ``linear_q8``'s int8 activations and int32 accumulators."""
    xf = x.astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-12) / 127.0
    x_q = jnp.round(xf / sx).astype(jnp.int8)
    acc = jax.lax.dot_general(x_q, p["w_q"], (((x_q.ndim - 1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    return np.asarray(x_q), np.asarray(acc)


@pytest.mark.parametrize("shape", [(3, 128, 64), (2, 64, 1026), (256, 512)],
                         ids=["stacked", "stacked_odd_width", "plain"])
def test_torch_quantize_linear_bit_equal_jax(shape):
    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 3.0, shape[-1])).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero column: scale 1e-12, int8 zeros
    want = jquant.quantize_linear({"w": jnp.asarray(w)})
    w_q, scale, _ = tquant.quantize_linear(torch.from_numpy(w))
    assert w_q.dtype == torch.int8 and scale.dtype == torch.float32
    for layer in range(shape[0] if len(shape) == 3 else 1):
        sl = (layer,) if len(shape) == 3 else ()
        np.testing.assert_array_equal(w_q.numpy()[sl], np.asarray(want["w_q"])[sl])
        np.testing.assert_array_equal(scale.numpy()[sl], np.asarray(want["scale"])[sl])
    assert int(w_q.abs().max()) == 127


LINEAR_CASES = [(256, 512, (4, 256), 1.0, 0), (64, 32, (2, 64), 3.0, 1),
                (128, 64, (4, 128), 1.0, 2), (64, 1026, (3, 5, 64), 0.05, 3),
                (64, 258, (16, 64), 10.0, 4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", LINEAR_CASES,
                         ids=["accuracy", "range", "scan_width", "mel_head", "text_head"])
def test_torch_linear_q8_matches_jax(case, dtype):
    """Same int8 activations and int32 accumulators as JAX; y within 1e-6
    relative of JAX's and within 2e-2 of the float product (the W8A8 bound of
    ``tests/test_quant.py``); a (B, T, D) input keeps its leading axes."""
    k, n, xshape, wstd, seed = case
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * wstd).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    p = jquant.quantize_linear({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    x = jnp.asarray(rng.standard_normal(xshape), getattr(jnp, dtype))
    want = np.asarray(jquant.linear_q8(p, x).astype(jnp.float32))
    lin = tquant.QLinear.from_float(torch.from_numpy(w), torch.from_numpy(b))
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dtype))
    got = lin(xt)
    assert got.dtype == xt.dtype and got.shape == (*xshape[:-1], n)
    x_q, sx = tquant.quantize_rows(xt)
    acc = tquant.int8_matmul(x_q.reshape(-1, k), lin.w_q)[:, :n]
    jx_q, jacc = _jax_acc(p, x)
    np.testing.assert_array_equal(x_q.numpy(), jx_q)
    np.testing.assert_array_equal(acc.numpy(), jacc.reshape(-1, n))
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    ref = np.asarray(x.astype(jnp.float32)) @ w + b
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 2e-2


def test_torch_int8_matmul_plain_is_exact():
    rng = np.random.default_rng(5)
    a = rng.integers(-127, 128, (40, 4096)).astype(np.int8)
    w = rng.integers(-127, 128, (4096, 24)).astype(np.int8)
    got = tquant.int8_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ w.astype(np.int64))
    with pytest.raises(ValueError, match="int8"):
        tquant.int8_matmul(torch.from_numpy(a).float(), torch.from_numpy(w))


def test_torch_quantize_gpt_structure():
    """The block projections and both heads become int8 linears with JAX's
    int8 weights and scales; the Perceiver, embeddings, positional tables
    and LayerNorms stay as they were (``tests/test_quant.py``'s structure)."""
    cfg = tgpt.GPTConfig(layers=2, model_dim=64, heads=2)
    tree = tgpt.init_tree(torch.Generator().manual_seed(3), cfg)
    np_tree = jax.tree.map(lambda t: t.numpy(), tree)
    np_tree["core"]["blocks"] = jax.tree.map(lambda *xs: np.stack(xs),
                                             *np_tree["core"]["blocks"])
    want = jquant.quantize_gpt_params(jax.tree.map(jnp.asarray, np_tree))
    from genvc_tpu_torch.checkpoint import assign

    with torch.device("meta"):
        model = tgpt.GPT(cfg)
    assign(model, tree, "cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tquant.quantize_gpt(model, np_tree)
    for i, block in enumerate(model.core.blocks):
        for sub, name in (("attn", "c_attn"), ("attn", "c_proj"),
                          ("mlp", "c_fc"), ("mlp", "c_proj")):
            lin = getattr(getattr(block, sub), name)
            leaf = want["core"]["blocks"][sub][name]
            assert isinstance(lin, tquant.QLinear) and lin.w_q.dtype == torch.int8
            np.testing.assert_array_equal(lin.w_q.numpy(), np.asarray(leaf["w_q"][i]))
            np.testing.assert_array_equal(lin.scale.numpy(), np.asarray(leaf["scale"][i]))
            np.testing.assert_array_equal(lin.b.numpy(), np.asarray(leaf["b"][i]))
        assert isinstance(block.ln_1, tnn.LayerNorm) and isinstance(block.ln_2, tnn.LayerNorm)
    for head in ("mel_head", "text_head"):
        lin = getattr(model, head)
        n = lin.scale.shape[0]
        assert lin.w_q.shape[1] == -(-n // 8) * 8 and not lin.w_q[:, n:].any()
        np.testing.assert_array_equal(lin.w_q[:, :n].numpy(), np.asarray(want[head]["w_q"]))
    kinds = {type(m) for m in model.perceiver.modules()
             if isinstance(m, (tnn.Linear, tquant.QLinear))}
    assert kinds == {tnn.Linear}
    after = model.state_dict()
    for k, v in before.items():
        if k in after:  # embeddings, positional tables, norms, Perceiver
            torch.testing.assert_close(after[k], v, rtol=0, atol=0)
    assert "mel_embedding" in after and "core.ln_f.scale" in after


# ---------------------------------------------------------------------------
# the synthetic bundle, f32


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    from synthetic_bundle import write_bundle

    path = str(tmp_path_factory.mktemp("bundle") / "tiny_genvc.pth")
    write_bundle(path)
    return path


@pytest.fixture(scope="module")
def pipes(bundle):
    """mode -> (JAX pipeline, port pipeline), greedy, cap 1.0; each built at
    its first use."""
    from genvc_tpu.decode.engine import SamplerConfig as JSampler
    from genvc_tpu.inference.pipeline import model_init as jax_init

    built = {}

    def get(mode):
        if mode not in built:
            jp = jax_init(bundle, **MODES[mode])
            jp.sampler = JSampler(**GREEDY)
            jp._build_jits()
            jp.gen_cap_tokens_per_code = 1.0
            tp = tpipe.model_init(bundle, device="cpu", **MODES[mode])
            tp.sampler = teng.SamplerConfig(**GREEDY)
            tp.gen_cap_tokens_per_code = 1.0
            built[mode] = (jp, tp)
        return built[mode]
    return get


def _utterance(seed, seconds):
    rng = np.random.default_rng(seed)
    src = (rng.standard_normal((1, int(16000 * seconds))) * 0.1).astype(np.float32)
    ref = (rng.standard_normal((1, 48000)) * 0.1).astype(np.float32)
    return src, ref


@pytest.mark.parametrize("mode", list(MODES))
def test_torch_quantized_decode_matches_jax_engine(pipes, mode):
    """Prefill + 24 lockstep steps over two rows: identical greedy tokens,
    latents within 1e-5; the e4m3 caches bit-equal. With an fp8 cache this is
    the decode step of ``tests/test_kv_cache_fp8.py``, held to JAX's."""
    jp, tp = pipes(mode)
    rng = np.random.default_rng(10)
    cond = (rng.standard_normal((2, 32, 64)) * 0.5).astype(np.float32)
    codes = np.zeros((2, 80), np.int64)
    codes[:, :60] = rng.integers(0, 256, (2, 60))
    n = np.asarray([60, 23])
    cfg = jp.gpt_cfg
    jemb, jvalid = jgpt.build_prefix_emb(jp.gpt_params, cfg, jnp.asarray(cond),
                                         jnp.asarray(codes, jnp.int32), jnp.asarray(n))
    js = jeng.init_state(cfg, jp._prefix_width, 2, cfg.heads, cfg.model_dim // cfg.heads,
                         jax.random.key(0), cache_dtype=jp._cache_dtype, gen_tokens=32)
    js, jtok0, jlat0 = jeng.prefill(jp.gpt_params, cfg, js, jemb, jvalid,
                                    jeng.SamplerConfig(**GREEDY))
    js, jtoks, jlats, _ = jeng.decode_chunk(jp.gpt_params, cfg, js,
                                            jeng.SamplerConfig(**GREEDY), chunk=24)
    with torch.inference_mode():
        temb, tvalid = tgpt.build_prefix_emb(tp.gpt, torch.from_numpy(cond),
                                             torch.from_numpy(codes), torch.from_numpy(n))
        ts = teng.init_state(tp.gpt_cfg, tp._prefix_width, 2, "cpu",
                             cache_dtype=tp.cache_dtype, gen_tokens=32)
        ttok0, tlat0 = teng.prefill(tp.gpt, ts, temb, tvalid, teng.SamplerConfig(**GREEDY))
        ttoks, tlats, _ = teng.decode_chunk(tp.gpt, ts, teng.SamplerConfig(**GREEDY),
                                            chunk=24)
    np.testing.assert_array_equal(ttok0.numpy(), np.asarray(jtok0))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    assert len(set(ttoks[0].tolist())) > 4  # a real sequence
    np.testing.assert_allclose(tlat0.numpy(), np.asarray(jlat0), atol=1e-5)
    np.testing.assert_allclose(tlats.numpy(), np.asarray(jlats), atol=1e-5)
    if mode != "int8":
        assert ts.cache_k.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(ts.cache_k.view(torch.uint8).numpy(),
                                      np.asarray(js.cache_k).view(np.uint8))


@pytest.mark.parametrize("mode,seconds", [("int8", 1.5), ("int8", 7.0), ("fp8", 1.5),
                                          ("int8_fp8", 7.0)])
def test_torch_quantized_streaming_matches_jax(pipes, mode, seconds):
    jp, tp = pipes(mode)
    src, ref = _utterance(int(seconds * 10), seconds)
    want, _, _ = jp.synthesize_streaming(src, ref, verbose=False)
    got, latency, rtf = tp.synthesize_streaming(src, ref, verbose=False)
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert latency > 0 and rtf > 0


@pytest.mark.parametrize("mode,seconds", [("int8", 7.0), ("fp8", 7.0), ("int8_fp8", 1.5)])
def test_torch_quantized_synthesize_matches_jax(pipes, mode, seconds):
    """Offline: decode_all, then the latent pass on int8 linears."""
    jp, tp = pipes(mode)
    src, ref = _utterance(int(seconds * 10) + 1, seconds)
    want = jp.synthesize(src, ref)
    got = tp.synthesize(src, ref)
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert tp.last_timing["latent_passes"] == (2 if seconds > 6 else 1)


def test_torch_quantized_server_matches_jax_server(pipes):
    """The README's serving configuration (int8, fp8 cache) in f32: a 2-slot
    StreamServer, three streams, the third arriving mid-flight; per stream
    the JAX server's length and audio within 1e-3. The server needs no code
    of its own for it."""
    from genvc_tpu.serving.server import StreamServer as JServer
    from genvc_tpu_torch.serving.server import StreamServer

    jp, tp = pipes("int8_fp8")
    rng = np.random.default_rng(23)
    srcs = [(rng.standard_normal((1, n)) * 0.1).astype(np.float32)
            for n in (16000, 24000, 9000)]
    refs = [(rng.standard_normal((1, n)) * 0.1).astype(np.float32)
            for n in (24000, 30000, 24000)]
    outs = []
    for cls, pipe in ((JServer, jp), (StreamServer, tp)):
        server = cls(pipe, slots=2, first_window=4)
        sids = [server.submit(s, r) for s, r in zip(srcs[:2], refs[:2])]
        assert server.step()
        sids += [server.submit(srcs[2], refs[2])]
        server.drain()
        outs.append([server.result(sid)[0] for sid in sids])
    for w, g in zip(*outs):
        assert g.shape == w.shape and g.size > 0
        np.testing.assert_allclose(g, w, atol=1e-3)


def _prefilled_fp8_state(tp):
    """Two rows prefilled on the port's fp8 pipeline, greedy."""
    rng = np.random.default_rng(12)
    cond = torch.from_numpy((rng.standard_normal((2, 32, 64)) * 0.5).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 256, (2, 80)))
    emb, valid = tgpt.build_prefix_emb(tp.gpt, cond, codes, torch.tensor([60, 23]))
    st = teng.init_state(tp.gpt_cfg, tp._prefix_width, 2, "cpu",
                         cache_dtype=tp.cache_dtype, gen_tokens=32)
    teng.prefill(tp.gpt, st, emb, valid, teng.SamplerConfig(**GREEDY))
    return st


def test_torch_f32_decode_reads_e4m3_overflow_as_480(pipes):
    """An f32 GPT over an e4m3 cache holding the overflow codes 0x7F / 0xFF
    in valid slots: the step reads them as +480 / -480, as the kernels and
    the JAX package's Pallas kernels do (ROADMAP C.1). Its latents and
    logits are finite and within 1e-4 of those of the same step over an f32
    cache that holds +-480 there (the step's own K/V are stored in e4m3 in
    one and in f32 in the other)."""
    import dataclasses

    from genvc_tpu_torch.ops import decode_attention as da

    _, tp = pipes("fp8")
    with torch.inference_mode():
        st = _prefilled_fp8_state(tp)
        assert st.key_valid[:, 3:9].all()
        bits = st.cache_k.view(torch.uint8)
        bits[:, :, :, 3:9] = torch.tensor([0x7F, 0xFF], dtype=torch.uint8).repeat(3)[:, None]
        st.cache_v.view(torch.uint8)[:, :, 1, 5] = 0xFF
        wide = dataclasses.replace(st, cache_k=da.from_e4m3(st.cache_k).float(),
                                   cache_v=da.from_e4m3(st.cache_v).float(),
                                   key_valid=st.key_valid.clone())
        assert wide.cache_k.abs().max() == 480 and wide.cache_v.min() == -480
        got = teng._decode_forward(tp.gpt, st)
        want = teng._decode_forward(tp.gpt, wide)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4)


@pytest.mark.parametrize("hd", [16, 256])
@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
def test_torch_kernel_f32_query_within_bf16_rounding_bound(cache, hd):
    """What the card computes for an f32 GPT (the kernels' plain version, the
    same casts) against the f32 attention the CPU engine takes, over one
    widened cache with masked keys (an overflow code among them, which must
    not turn the output into NaN): every element within
    ``bf16_rounding_bound``, and the bound below a tenth of the largest
    |v| (it is not vacuous)."""
    from genvc_tpu_torch.ops import decode_attention as da

    g = torch.Generator().manual_seed(hd)
    b, h, t = 3, 4, 160
    q = torch.randn(b, h, hd, generator=g) * 0.3
    kv = [torch.randn(2, b, h, t, hd, generator=g) * 2 for _ in range(2)]
    kv[1][1, 2, 0, 120, :4] = 1e4  # row 2 holds 97 keys
    ck, cv = (da.to_cache(x, torch.bfloat16 if cache == "bf16" else da._F8) for x in kv)
    lens = torch.tensor([t, 1, 97])
    valid = torch.arange(t)[None] < lens[:, None]
    bias = torch.where(valid, 0.0, tnn.NEG_INF)
    got = da.decode_attention_layer(q, ck, cv, bias, 1)
    want = tnn.attention(q[:, :, None], da.widen(ck[1], torch.float32),
                         da.widen(cv[1], torch.float32),
                         bias=tnn.key_padding_bias(valid))[:, :, 0]
    bound = da.bf16_rounding_bound(q, ck, cv, bias, 1)
    err = (got - want).abs()
    assert torch.isfinite(want).all() and (err <= bound).all(), float((err - bound).max())
    assert float(bound.max()) < 0.1 * float(da.widen(cv[1, :2]).float().abs().max())


def test_torch_card_fp8_numerics_keep_jax_tokens_and_audio(pipes, monkeypatch, capsys):
    """The stated deviation of ROADMAP C.4: on the card an f32 GPT's e4m3
    cache is read by K1 / K3, which round q and the probabilities to bf16,
    where the JAX package (off the TPU) attends in f32. With the kernels'
    numerics (their plain versions on the CPU, through the card's gate), the
    fp8 pipeline keeps the JAX engine's greedy tokens over 24 steps and its
    streaming audio within 1e-3; the latents' error is printed."""
    from genvc_tpu_torch.ops import decode_attention as da

    monkeypatch.setattr(teng, "_kernel_reads", lambda cache, q: cache.dtype != torch.float32)
    calls, kernel = [], da.decode_attention_layer
    monkeypatch.setattr(da, "decode_attention_layer", lambda *a: calls.append(1) or kernel(*a))
    jp, tp = pipes("fp8")
    rng = np.random.default_rng(10)
    cond = (rng.standard_normal((2, 32, 64)) * 0.5).astype(np.float32)
    codes = np.zeros((2, 80), np.int64)
    codes[:, :60] = rng.integers(0, 256, (2, 60))
    n = np.asarray([60, 23])
    cfg = jp.gpt_cfg
    jemb, jvalid = jgpt.build_prefix_emb(jp.gpt_params, cfg, jnp.asarray(cond),
                                         jnp.asarray(codes, jnp.int32), jnp.asarray(n))
    js = jeng.init_state(cfg, jp._prefix_width, 2, cfg.heads, cfg.model_dim // cfg.heads,
                         jax.random.key(0), cache_dtype=jp._cache_dtype, gen_tokens=32)
    js, _, _ = jeng.prefill(jp.gpt_params, cfg, js, jemb, jvalid, jeng.SamplerConfig(**GREEDY))
    js, jtoks, jlats, _ = jeng.decode_chunk(jp.gpt_params, cfg, js,
                                            jeng.SamplerConfig(**GREEDY), chunk=24)
    with torch.inference_mode():
        temb, tvalid = tgpt.build_prefix_emb(tp.gpt, torch.from_numpy(cond),
                                             torch.from_numpy(codes), torch.from_numpy(n))
        ts = teng.init_state(tp.gpt_cfg, tp._prefix_width, 2, "cpu",
                             cache_dtype=tp.cache_dtype, gen_tokens=32)
        teng.prefill(tp.gpt, ts, temb, tvalid, teng.SamplerConfig(**GREEDY))
        ttoks, tlats, _ = teng.decode_chunk(tp.gpt, ts, teng.SamplerConfig(**GREEDY),
                                            chunk=24)
    assert len(calls) == 24 * tp.gpt_cfg.layers
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    src, ref = _utterance(15, 1.5)
    want, _, _ = jp.synthesize_streaming(src, ref, verbose=False)
    got, _, _ = tp.synthesize_streaming(src, ref, verbose=False)
    assert got.shape == want.shape and got.size > 0
    lat_err = float(np.abs(tlats.numpy() - np.asarray(jlats)).max())
    audio_err = float(np.abs(got - want).max())
    with capsys.disabled():
        print(f"\nfp8 cache, f32 GPT, kernel numerics vs JAX: latents {lat_err:.3g}, "
              f"streaming audio {audio_err:.3g}")
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_torch_quantize_and_cache_modes_validated(bundle):
    with pytest.raises(ValueError, match="quantize"):
        tpipe.model_init(bundle, device="cpu", quantize="int4")
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        tpipe.model_init(bundle, device="cpu", kv_cache_dtype="int4")


def _prefix_inputs():
    rng = np.random.default_rng(10)
    codes = rng.integers(0, 256, (1, 80))
    cond = (rng.standard_normal((1, 32, 64)) * 0.05).astype(np.float32)
    return cond, codes, np.asarray([13])


def _jax_prefill_logits(pipe):
    cond, codes, n = _prefix_inputs()
    cfg = pipe.gpt_cfg
    emb, valid = jgpt.build_prefix_emb(pipe.gpt_params, cfg, jnp.asarray(cond),
                                       jnp.asarray(codes, jnp.int32), jnp.asarray(n))
    st = jeng.init_state(cfg, pipe._prefix_width, 1, cfg.heads, cfg.model_dim // cfg.heads,
                         jax.random.key(0), cache_dtype=pipe._cache_dtype)
    return np.asarray(jeng.prefill_logits(pipe.gpt_params, cfg, st, emb, valid)[2],
                      np.float32)


def _torch_prefill_logits(pipe):
    cond, codes, n = _prefix_inputs()
    with torch.inference_mode():
        emb, valid = tgpt.build_prefix_emb(pipe.gpt, torch.from_numpy(cond),
                                           torch.from_numpy(codes), torch.from_numpy(n))
        st = teng.init_state(pipe.gpt_cfg, pipe._prefix_width, 1, "cpu",
                             cache_dtype=pipe.cache_dtype)
        return teng.prefill_logits(pipe.gpt, st, emb, valid)[1].float().numpy()


def test_torch_bf16_int8_fp8_prefill_logits_match_jax(bundle, capsys):
    """bf16 GPT, int8 linears, fp8 cache, on both sides: the core's
    LayerNorms stay f32 under quantize (as the JAX package keeps them), and
    the prefill logits agree within 0.05 relative (bf16 rounding of the
    activations between the int8 products; the measured error is printed).
    Each side's quantized logits also stay within 0.05 of its own bf16 run
    without int8 (``tests/test_quant.py``'s bound)."""
    from genvc_tpu.inference.pipeline import model_init as jax_init

    kw = dict(quantize="int8", kv_cache_dtype="fp8")
    jq = jax_init(bundle, compute_dtype=jnp.bfloat16, **kw)
    tq = tpipe.model_init(bundle, device="cpu", dtype=torch.bfloat16, **kw)
    assert tq.quantize == "int8" and tq.cache_dtype == torch.float8_e4m3fn
    block = tq.gpt.core.blocks[0]
    assert block.ln_1.scale.dtype == torch.float32 and tq.gpt.core.ln_f.bias.dtype == torch.float32
    assert tq.gpt.mel_embedding.dtype == torch.bfloat16
    assert block.attn.c_attn.scale.dtype == torch.float32 and block.attn.c_attn.b.dtype == torch.float32
    lj = _jax_prefill_logits(jq)
    lt = _torch_prefill_logits(tq)
    rel = np.linalg.norm(lt - lj) / np.linalg.norm(lj)
    jf = jax_init(bundle, compute_dtype=jnp.bfloat16)
    tf = tpipe.model_init(bundle, device="cpu", dtype=torch.bfloat16)
    rel_j = np.linalg.norm(lj - _jax_prefill_logits(jf)) / np.linalg.norm(lj)
    rel_t = np.linalg.norm(lt - _torch_prefill_logits(tf)) / np.linalg.norm(lt)
    with capsys.disabled():
        print(f"\nbf16 int8 fp8 prefill logits: port vs JAX rel {rel:.3g}; int8 vs "
              f"bf16: JAX {rel_j:.3g}, port {rel_t:.3g}")
    assert rel < 0.05 and rel_j < 0.05 and rel_t < 0.05
