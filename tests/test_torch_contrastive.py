"""The port's contrastive search against the JAX engine's, on the CPU with
the synthetic bundle's GPT in f32: the same seeded prefix (one hypothesis
tiled over the candidates) gives the same token list (exact equality), also
when the stop token ends the search early; and the post-``ln_f`` hiddens
that its degeneration penalty reads (``_decode_forward`` and
``prefill_logits`` with ``return_hidden``) agree within 1e-5."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genvc_tpu.decode import engine as jeng
from genvc_tpu_torch.decode import engine as teng

from test_torch_decode_modes import _inputs, _jax_tokens, _torch_tokens
from test_torch_engine import pipes  # noqa: F401


def _with_stop_bias(jp, tp, bias):
    """Both packages' GPT with ``bias`` added to the stop token's logit."""
    stop = tp.gpt_cfg.stop_audio_token
    params = dict(jp.gpt_params)
    head = dict(params["mel_head"])
    head["b"] = head["b"].at[stop].add(bias)
    params["mel_head"] = head
    model = copy.deepcopy(tp.gpt)
    with torch.no_grad():
        model.mel_head.b[stop] += bias
    return params, model


@pytest.mark.parametrize("top_k,alpha,rep_pen,max_new,stop_bias",
                         [(4, 0.6, 1.0, 12, 0.0), (3, 0.3, 2.0, 12, 0.0),
                          # the stop token wins at step 12 of 16
                          (4, 0.6, 1.0, 16, 0.7)])
def test_torch_decode_contrastive_matches_jax(pipes, top_k, alpha, rep_pen, max_new,
                                              stop_bias):
    jp, tp = pipes
    (je, jv), jst, (te, tv), tst = _inputs(jp, tp, top_k)
    params, model = _with_stop_bias(jp, tp, stop_bias)
    kw = dict(max_new=max_new, top_k=top_k, penalty_alpha=alpha, repetition_penalty=rep_pen)
    want = _jax_tokens(*jax.jit(lambda p, st, e, v: jeng.decode_contrastive(
        p, jp.gpt_cfg, st, e, v, **kw))(params, jst, je, jv))
    with torch.inference_mode():
        got = _torch_tokens(*teng.decode_contrastive(model, tst, te, tv, **kw))
    assert got == want
    stop = tp.gpt_cfg.stop_audio_token
    if stop_bias:
        assert got[-1] == stop and len(got) < max_new
    else:
        assert len(got) == max_new
    assert tst.steps == len(got)


def test_torch_return_hidden_matches_jax(pipes):
    """``prefill_logits(return_hidden=True)`` (B, P + 1, D) and
    ``_decode_forward(return_hidden=True)`` (B, D) agree with the JAX
    engine's hiddens within 1e-5, and the other outputs are unchanged."""
    jp, tp = pipes
    (je, jv), jst, (te, tv), tst = _inputs(jp, tp, 2)
    cfg = jp.gpt_cfg
    filled, jlat, jlogits, jh0 = jeng.prefill_logits(jp.gpt_params, cfg, jst, je, jv,
                                                     return_hidden=True)
    filled = filled._replace(last_token=jnp.asarray([5, 9], jnp.int32),
                             n_generated=jnp.int32(1))
    *_, jlat1, jlogits1, jh1 = jeng._decode_forward(jp.gpt_params, cfg, filled)
    with torch.inference_mode():
        tlat, tlogits, th0 = teng.prefill_logits(tp.gpt, tst, te, tv, return_hidden=True)
        tst.last_token = torch.tensor([5, 9])
        tst.n_generated = 1
        tlat1, tlogits1, th1 = teng._decode_forward(tp.gpt, tst, return_hidden=True)
        lat1, logits1 = teng._decode_forward(tp.gpt, tst)
    assert th0.shape == (2, je.shape[1] + 1, cfg.model_dim) and th1.shape == (2, cfg.model_dim)
    for got, want in ((th0, jh0), (th1, jh1), (tlat, jlat), (tlogits, jlogits),
                      (tlat1, jlat1), (tlogits1, jlogits1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert torch.equal(lat1, tlat1) and torch.equal(logits1, tlogits1)


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float8_e4m3fn])
def test_torch_contrastive_rows_share_the_winners_cache(pipes, cache_dtype):
    """After contrastive search on a bf16 / e4m3 cache every candidate row
    holds the same bits at every written slot: each step copies the
    winner's K/V at the slot just written to all rows."""
    jp, tp = pipes
    _, _, (te, tv), _ = _inputs(jp, tp, 3)
    st = teng.init_state(tp.gpt_cfg, tp._prefix_width, 3, "cpu", cache_dtype=cache_dtype,
                         gen_tokens=32)
    with torch.inference_mode():
        buf, n = teng.decode_contrastive(tp.gpt, st, te, tv, max_new=12, top_k=3,
                                         penalty_alpha=0.6)
    assert n == 12 and st.cur_index == tp._prefix_width + 1 + n
    bits = {1: torch.uint8, 2: torch.int16}[st.cache_k.element_size()]
    for cache in (st.cache_k, st.cache_v):
        written = cache.view(bits)[:, :, :, : st.cur_index]
        assert all(torch.equal(written[:, i], written[:, 0]) for i in (1, 2))
        assert bool((written != 0).any())
