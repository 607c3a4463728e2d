"""The decode engine's per-row positions (the serving pool), port vs JAX
package on the CPU with the synthetic bundle's GPT in f32: slot insertion,
per-row rows that happen to be aligned against lockstep, a 3-slot pool whose
rows are inserted at different depths (identical greedy tokens, latents
within 1e-5: the same f32 arithmetic, sums in other orders), and idle slots
driven past the cache end (JAX drops the writes and clamps the gathers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genvc_tpu.decode import engine as jeng
from genvc_tpu.models import gpt as jgpt
from genvc_tpu_torch.decode import engine as teng
from genvc_tpu_torch.models import gpt as tgpt

GREEDY = dict(temperature=0.85, top_k=15, top_p=0.85, repetition_penalty=2.0,
              do_sample=False)
ROW_PARAMS = {"repetition_penalty": [2.0, 1.0, 1.5], "temperature": [0.85, 1.0, 1.0],
              "top_k": [15, 0, 5], "top_p": [0.85, 1.0, 0.9],
              "do_sample": [False, False, False]}


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    from synthetic_bundle import write_bundle
    from genvc_tpu.inference.pipeline import model_init as jax_init
    from genvc_tpu_torch.inference.pipeline import model_init as torch_init

    path = str(tmp_path_factory.mktemp("bundle") / "tiny_genvc.pth")
    write_bundle(path)
    return jax_init(path), torch_init(path, device="cpu")


def _prefixes(seed, text_lens):
    """(cond (B, 32, 64), codes (B, 80), text lengths (B,)) from numpy."""
    rng = np.random.default_rng(seed)
    b = len(text_lens)
    cond = (rng.standard_normal((b, 32, 64)) * 0.5).astype(np.float32)
    codes = np.zeros((b, 80), np.int64)
    codes[:, :60] = rng.integers(0, 256, (b, 60))
    return cond, codes, np.asarray(text_lens)


def _jax_prefix(jp, cond, codes, n):
    return jgpt.build_prefix_emb(jp.gpt_params, jp.gpt_cfg, jnp.asarray(cond),
                                 jnp.asarray(codes, jnp.int32), jnp.asarray(n, jnp.int32))


def _torch_prefix(tp, cond, codes, n):
    return tgpt.build_prefix_emb(tp.gpt, torch.from_numpy(cond), torch.from_numpy(codes),
                                 torch.from_numpy(n))


def test_torch_insert_row_isolation():
    """insert_row replaces exactly one slot's cache, positions and tokens
    (JAX tests/test_serving.py::test_insert_row_isolation)."""
    cfg = tgpt.GPTConfig(layers=2, model_dim=16, heads=2)
    pool = teng.init_state(cfg, 8, 3, "cpu", gen_tokens=8, per_row=True)
    pool.cache_k.fill_(1.0)
    pool.last_token.fill_(7)
    row = teng.init_state(cfg, 8, 1, "cpu", gen_tokens=8, per_row=True)
    row.cache_k.fill_(2.0)
    row.cur_index = torch.tensor([5])
    row.last_token = torch.tensor([3])
    teng.insert_row(pool, row, 1)
    assert torch.all(pool.cache_k[:, 1] == 2.0)
    assert torch.all(pool.cache_k[:, 0] == 1.0) and torch.all(pool.cache_k[:, 2] == 1.0)
    assert pool.cur_index.tolist() == [0, 5, 0]
    assert pool.last_token.tolist() == [7, 3, 7]
    assert pool.steps == 0 and pool.per_row and not teng.init_state(cfg, 8, 1, "cpu").per_row


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_torch_aligned_per_row_matches_lockstep(pipes, cache_dtype):
    """A per-row state whose rows happen to be aligned decodes exactly like
    the lockstep state (JAX test_serving.py::test_per_row_decode_matches_lockstep).
    With a bf16 cache the two take the update kernel's and K1's plain
    versions: the same arithmetic, so the same bits."""
    _, tp = pipes
    cond, codes, n = _prefixes(0, [30, 50])
    emb, valid = _torch_prefix(tp, cond, codes, n)
    sampler = teng.SamplerConfig(**GREEDY)
    outs = {}
    with torch.inference_mode():
        for per_row in (False, True):
            st = teng.init_state(tp.gpt_cfg, tp._prefix_width, 2, "cpu",
                                 cache_dtype=cache_dtype, gen_tokens=32, per_row=per_row)
            tok0, _ = teng.prefill(tp.gpt, st, emb, valid, sampler)
            toks, lats, _ = teng.decode_chunk(tp.gpt, st, sampler, chunk=6)
            outs[per_row] = (tok0, toks, lats, st)
    torch.testing.assert_close(outs[False][0], outs[True][0], rtol=0, atol=0)
    torch.testing.assert_close(outs[False][1], outs[True][1], rtol=0, atol=0)
    torch.testing.assert_close(outs[False][2], outs[True][2], rtol=0, atol=0)
    lock, row = outs[False][3], outs[True][3]
    assert row.cur_index.tolist() == [lock.cur_index] * 2 and row.steps == lock.steps == 6
    assert torch.equal(row.cache_k, lock.cache_k) and torch.equal(row.key_valid, lock.key_valid)


def _idle_pool_jax(jp, slots, gen_tokens):
    cfg = jp.gpt_cfg
    pool = jeng.init_state(cfg, jp._prefix_width, slots, cfg.heads,
                           cfg.model_dim // cfg.heads, jax.random.key(0),
                           cache_dtype=jnp.float32, gen_tokens=gen_tokens, per_row=True)
    return pool._replace(key_valid=pool.key_valid.at[:, 0].set(True),
                         finished=jnp.ones((slots,), bool))


def _idle_pool_torch(tp, slots, gen_tokens, cache_dtype=torch.float32):
    pool = teng.init_state(tp.gpt_cfg, tp._prefix_width, slots, "cpu",
                           cache_dtype=cache_dtype, gen_tokens=gen_tokens, per_row=True)
    pool.key_valid[:, 0] = True
    pool.finished.fill_(True)
    return pool


def test_torch_pool_rows_at_different_depths_match_jax(pipes):
    """A 3-slot pool: rows prefilled and inserted at different depths
    between decode chunks, the last chunk with per-row sampler parameters;
    each chunk's tokens identical to JAX's per-row ``decode_chunk`` and its
    latents within 1e-5, on the occupied slots."""
    jp, tp = pipes
    jsampler, tsampler = jeng.SamplerConfig(**GREEDY), teng.SamplerConfig(**GREEDY)
    jcfg, pw = jp.gpt_cfg, jp._prefix_width
    jpool = _idle_pool_jax(jp, 3, 64)
    tpool = _idle_pool_torch(tp, 3, 64)
    plan = [(0, 30, 3), (2, 50, 2), (1, 12, 6)]  # (slot, text length, steps after)
    occupied = []
    for i, (slot, n_text, steps) in enumerate(plan):
        cond, codes, n = _prefixes(10 + i, [n_text])
        jrow = jeng.init_state(jcfg, pw, 1, jcfg.heads, jcfg.model_dim // jcfg.heads,
                               jax.random.key(1), cache_dtype=jnp.float32, gen_tokens=64,
                               per_row=True)
        jrow, jtok0, _ = jeng.prefill(jp.gpt_params, jcfg, jrow,
                                      *_jax_prefix(jp, cond, codes, n), jsampler)
        jpool = jeng.insert_row(jpool, jrow, slot)
        last = i == len(plan) - 1
        jrp = {k: jnp.asarray(v) for k, v in ROW_PARAMS.items()} if last else None
        trp = ({k: torch.tensor(v) for k, v in ROW_PARAMS.items()} if last else None)
        jpool, jtoks, jlats, _ = jeng.decode_chunk(jp.gpt_params, jcfg, jpool, jsampler,
                                                   chunk=steps, row_params=jrp)
        with torch.inference_mode():
            trow = teng.init_state(tp.gpt_cfg, pw, 1, "cpu", gen_tokens=64, per_row=True)
            ttok0, _ = teng.prefill(tp.gpt, trow, *_torch_prefix(tp, cond, codes, n),
                                    tsampler)
            teng.insert_row(tpool, trow, slot)
            ttoks, tlats, _ = teng.decode_chunk(tp.gpt, tpool, tsampler, chunk=steps,
                                                row_params=trp)
        assert int(ttok0[0]) == int(jtok0[0])
        occupied.append(slot)
        np.testing.assert_array_equal(ttoks[occupied].numpy(),
                                      np.asarray(jtoks)[occupied])
        np.testing.assert_allclose(tlats[occupied].numpy(), np.asarray(jlats)[occupied],
                                   atol=1e-5)
    assert tpool.cur_index.tolist() == np.asarray(jpool.cur_index).tolist()
    assert tpool.steps == 11
    assert len(set(ttoks[0].tolist())) > 2  # a real sequence


def test_torch_idle_slots_past_the_cache_end(pipes):
    """Never-occupied slots tick past the cache end (T = 256 here) and past
    the position table: no error, finite latents, equal to JAX's (its
    out-of-range writes dropped, gathers clamped) within 1e-5. A bf16 cache
    (the update kernel's plain version) also stays finite."""
    jp, tp = pipes
    steps, start = 270, 400  # positions 0..269 > T; n_generated 400..669 > 608
    jpool = _idle_pool_jax(jp, 2, 64)
    jpool = jpool._replace(n_generated=jnp.full((2,), start, jnp.int32))
    jpool, jtoks, jlats, _ = jeng.decode_chunk(jp.gpt_params, jp.gpt_cfg, jpool,
                                               jeng.SamplerConfig(**GREEDY), chunk=steps)
    for cache_dtype in (torch.float32, torch.bfloat16):
        tpool = _idle_pool_torch(tp, 2, 64, cache_dtype)
        t = tpool.cache_k.shape[3]
        tpool.n_generated = torch.full((2,), start)
        with torch.inference_mode():
            ttoks, tlats, _ = teng.decode_chunk(tp.gpt, tpool, teng.SamplerConfig(**GREEDY),
                                                chunk=steps)
        assert t == 256 and tpool.cur_index.tolist() == [steps, steps]
        assert bool(torch.isfinite(tlats).all()) and bool(tpool.key_valid.all())
        if cache_dtype == torch.float32:
            np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
            np.testing.assert_allclose(tlats.numpy(), np.asarray(jlats), atol=1e-5)
