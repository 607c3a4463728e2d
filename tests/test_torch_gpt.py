"""GPT-side parity, port vs JAX package on the CPU in f32 (synthetic bundle):
Perceiver style latents, ``build_prefix_emb`` and prefill logits at atol 1e-4;
greedy decode tokens identical over 24 steps; the sampling chain on fixed
logits (same filtered distribution, same ids from the same uniform draws)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genvc_tpu.decode import engine as jeng
from genvc_tpu.models import gpt as jgpt
from genvc_tpu.ops import sampling as jsamp
from genvc_tpu_torch.decode import engine as teng
from genvc_tpu_torch.models import gpt as tgpt
from genvc_tpu_torch.ops import sampling as tsamp

GREEDY = dict(temperature=0.85, top_k=15, top_p=0.85, repetition_penalty=2.0,
              do_sample=False)


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    from synthetic_bundle import write_bundle
    from genvc_tpu.inference.pipeline import model_init as jax_init
    from genvc_tpu_torch.inference.pipeline import model_init as torch_init

    path = str(tmp_path_factory.mktemp("bundle") / "tiny_genvc.pth")
    write_bundle(path)
    return jax_init(path), torch_init(path, device="cpu")


@pytest.fixture(scope="module")
def prefix(pipes):
    """Shared cond latents, codes and prefix from the JAX side."""
    jp, tp = pipes
    rng = np.random.default_rng(5)
    ref = (rng.standard_normal((1, 24000 * 2)) * 0.1).astype(np.float32)
    cond = np.array(jp.get_gpt_cond_latents(ref))
    codes = np.zeros((1, 80), np.int64)
    codes[0, :30] = rng.integers(0, 256, 30)
    return ref, cond, codes, np.asarray([30])


def test_torch_style_latents_match_jax(pipes, prefix):
    jp, tp = pipes
    ref, cond, _, _ = prefix
    got = tp.get_gpt_cond_latents(ref).numpy()
    assert got.shape == (1, 32, 64)
    np.testing.assert_allclose(got, cond, atol=1e-4)


def test_torch_prefix_emb_matches_jax(pipes, prefix):
    jp, tp = pipes
    _, cond, codes, n = prefix
    want_emb, want_valid = jgpt.build_prefix_emb(
        jp.gpt_params, jp.gpt_cfg, jnp.asarray(cond), jnp.asarray(codes, jnp.int32),
        jnp.asarray(n, jnp.int32))
    got_emb, got_valid = tgpt.build_prefix_emb(
        tp.gpt, torch.from_numpy(cond), torch.from_numpy(codes), torch.from_numpy(n))
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(want_emb), atol=1e-6)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))


def test_torch_prefill_and_greedy_decode_match_jax(pipes, prefix):
    jp, tp = pipes
    _, cond, codes, n = prefix
    steps = 24
    jcfg = jp.gpt_cfg
    pw = jp._prefix_width
    jemb, jvalid = jgpt.build_prefix_emb(jp.gpt_params, jcfg, jnp.asarray(cond),
                                         jnp.asarray(codes, jnp.int32),
                                         jnp.asarray(n, jnp.int32))
    jstate = jeng.init_state(jcfg, pw, 1, jcfg.heads, jcfg.model_dim // jcfg.heads,
                             jax.random.key(0), cache_dtype=jnp.float32, gen_tokens=64)
    _, jlat0, jlogits = jeng.prefill_logits(jp.gpt_params, jcfg, jstate, jemb, jvalid)
    jstate, jtok0, _ = jeng.prefill(jp.gpt_params, jcfg, jstate, jemb, jvalid,
                                    jeng.SamplerConfig(**GREEDY))
    jstate, jtoks, jlats, _ = jeng.decode_chunk(jp.gpt_params, jcfg, jstate,
                                                jeng.SamplerConfig(**GREEDY), chunk=steps)

    temb, tvalid = tgpt.build_prefix_emb(tp.gpt, torch.from_numpy(cond),
                                         torch.from_numpy(codes), torch.from_numpy(n))
    tstate = teng.init_state(tp.gpt_cfg, pw, 1, "cpu", gen_tokens=64)
    with torch.inference_mode():
        tlat0, tlogits = teng.prefill_logits(tp.gpt, tstate, temb, tvalid)
        tstate = teng.init_state(tp.gpt_cfg, pw, 1, "cpu", gen_tokens=64)
        ttok0, _ = teng.prefill(tp.gpt, tstate, temb, tvalid, teng.SamplerConfig(**GREEDY))
        ttoks, tlats, _ = teng.decode_chunk(tp.gpt, tstate, teng.SamplerConfig(**GREEDY),
                                            chunk=steps)
    assert tstate.cache_k.shape == jstate.cache_k.shape
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-4)
    np.testing.assert_allclose(tlat0.numpy(), np.asarray(jlat0), atol=1e-4)
    assert int(ttok0[0]) == int(jtok0[0])
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    assert len(set(ttoks[0].tolist())) > 3  # a real sequence, not one id repeated
    np.testing.assert_allclose(tlats.numpy(), np.asarray(jlats), atol=1e-4)
    assert tstate.cur_index == int(jstate.cur_index)


def test_torch_sampling_chain_matches_jax():
    rng = np.random.default_rng(7)
    b, v = 4, 1026
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    seen = rng.random((b, v)) < 0.05
    kw = dict(repetition_penalty=2.0, temperature=0.85, top_k=15, top_p=0.85)
    want = np.array(jsamp.process_logits(jnp.asarray(logits), jnp.asarray(seen), **kw))
    got = tsamp.process_logits(torch.from_numpy(logits), torch.from_numpy(seen), **kw).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], rtol=1e-6)

    # the same uniform draws pick the same ids (inverse CDF over softmax)
    u = rng.random(b)
    ids = tsamp.sample_token(torch.from_numpy(want), uniform=torch.from_numpy(u)).numpy()
    p = np.exp(want - want.max(axis=-1, keepdims=True))
    cdf = np.cumsum(p / p.sum(axis=-1, keepdims=True), axis=-1)
    ref_ids = [int(np.searchsorted(cdf[i], u[i] * cdf[i, -1], side="right")) for i in range(b)]
    np.testing.assert_array_equal(ids, ref_ids)
    assert np.all(np.isfinite(want[np.arange(b), ids]))

    seen_j = np.asarray(jsamp.init_seen(v, b))
    np.testing.assert_array_equal(tsamp.init_seen(v, b).numpy(), seen_j)


def test_torch_sampling_uses_the_generator():
    logits = torch.zeros(2, 50)
    a = tsamp.sample_token(logits, torch.Generator().manual_seed(3))
    b = tsamp.sample_token(logits, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b)


def test_torch_forward_latent_matches_jax(pipes, prefix):
    """The latent pass at B = 2 (text lengths 30 / 50, 20 / 45 generated
    codes at the bucketed width 64) against JAX ``forward_train(...,
    return_latent=True, train=False)``, atol 1e-4 (f32 on both sides; the
    JAX CPU path is its dense attention, the port's the flash version)."""
    jp, tp = pipes
    _, cond, _, _ = prefix
    rng = np.random.default_rng(11)
    cond2 = np.concatenate([cond, cond[:, ::-1]])
    codes = np.zeros((2, 80), np.int64)
    codes[:, :50] = rng.integers(0, 256, (2, 50))
    text_len = np.asarray([30, 50])
    gen = np.zeros((2, 64), np.int64)
    gen[0, :20] = rng.integers(0, 1024, 20)
    gen[1, :45] = rng.integers(0, 1024, 45)
    wav_len = np.asarray([20, 45]) * 1024
    want = jgpt.forward_train(
        jp.gpt_params, jp.gpt_cfg, jnp.asarray(codes, jnp.int32),
        jnp.asarray(text_len, jnp.int32), jnp.asarray(gen, jnp.int32),
        jnp.asarray(wav_len, jnp.int32), cond_latents=jnp.asarray(cond2),
        return_latent=True, train=False)
    with torch.inference_mode():
        got = tgpt.forward_latent(tp.gpt, *(torch.from_numpy(np.ascontiguousarray(x))
                                            for x in (codes, text_len, gen, wav_len, cond2)))
    assert got.shape == want.shape == (2, 64 + 2 - 5, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("rows,stop_bias", [(1, 0.0), (1, 0.8), (2, 0.8)])
def test_torch_decode_all_matches_jax(pipes, prefix, rows, stop_bias):
    """``decode_all`` tokens and n_generated identical to JAX's, greedy with
    the repetition penalty, to the cap of 48. ``stop_bias`` raises the stop
    token's logit so that rows stop on their own: with 0.8 the two rows
    (text lengths 30 and 50) stop at different steps."""
    jp, tp = pipes
    _, cond, _, _ = prefix
    rng = np.random.default_rng(12)
    codes = np.zeros((rows, 80), np.int64)
    codes[:, :50] = rng.integers(0, 256, (rows, 50))
    n = np.asarray([30, 50][:rows])
    cond = np.repeat(cond, rows, axis=0)
    max_new, stop = 48, jp.gpt_cfg.stop_audio_token
    jcfg, pw = jp.gpt_cfg, jp._prefix_width

    jparams = dict(jp.gpt_params)
    jparams["mel_head"] = dict(jparams["mel_head"])
    jparams["mel_head"]["b"] = jparams["mel_head"]["b"].at[stop].add(stop_bias)
    jemb, jvalid = jgpt.build_prefix_emb(jparams, jcfg, jnp.asarray(cond),
                                         jnp.asarray(codes, jnp.int32),
                                         jnp.asarray(n, jnp.int32))
    jstate = jeng.init_state(jcfg, pw, rows, jcfg.heads, jcfg.model_dim // jcfg.heads,
                             jax.random.key(0), cache_dtype=jnp.float32, gen_tokens=64)
    jstate, _, _ = jeng.prefill(jparams, jcfg, jstate, jemb, jvalid,
                                jeng.SamplerConfig(**GREEDY))
    _, jtoks, jn = jeng.decode_all(jparams, jcfg, jstate, jeng.SamplerConfig(**GREEDY),
                                   max_new)

    bias = tp.gpt.mel_head.b.clone()
    try:
        tp.gpt.mel_head.b[stop] += stop_bias
        with torch.inference_mode():
            temb, tvalid = tgpt.build_prefix_emb(tp.gpt, torch.from_numpy(cond),
                                                 torch.from_numpy(codes), torch.from_numpy(n))
            tstate = teng.init_state(tp.gpt_cfg, pw, rows, "cpu", gen_tokens=64)
            teng.prefill(tp.gpt, tstate, temb, tvalid, teng.SamplerConfig(**GREEDY))
            ttoks, tn = teng.decode_all(tp.gpt, tstate, teng.SamplerConfig(**GREEDY),
                                        max_new)
    finally:
        tp.gpt.mel_head.b.copy_(bias)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tstate.n_generated <= max_new
    if stop_bias:
        assert (tn.numpy() < max_new).all() and len(set(tn.tolist())) == rows
    else:
        assert tn.tolist() == [max_new]
