"""The port's beam search, beam_sample, group beam search and constrained
beam search against the JAX engine's, on the CPU with the synthetic bundle's
GPT in f32: the same seeded prefix (one hypothesis tiled over the beams) in
both packages gives the same token list (exact equality); beam_sample takes
the JAX engine's own Gumbel noise. Also the beam reorder of a bf16 and an
e4m3 cache, bit for bit, with a cyclic parent permutation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genvc_tpu.decode import engine as jeng
from genvc_tpu.decode.constraints import PhraseListState as JPhraseListState
from genvc_tpu_torch.decode import engine as teng
from genvc_tpu_torch.decode.constraints import PhraseListState
from genvc_tpu_torch.ops import decode_attention as da

from test_torch_engine import _jax_prefix, _prefixes, _torch_prefix, pipes  # noqa: F401

MAX_NEW = 12
GEN_TOKENS = 32
KEY = 42


def _inputs(jp, tp, rows, seed=3, text_len=40):
    """The single hypothesis of a seeded prefix tiled to ``rows`` rows, and a
    fresh f32 decode state, for each package."""
    cond, codes, n = _prefixes(seed, [text_len])
    tile = (lambda a: np.repeat(a, rows, axis=0))
    cond, codes, n = tile(cond), tile(codes), tile(n)
    cfg = jp.gpt_cfg
    jstate = jeng.init_state(cfg, jp._prefix_width, rows, cfg.heads,
                             cfg.model_dim // cfg.heads, jax.random.key(KEY),
                             cache_dtype=jnp.float32, gen_tokens=GEN_TOKENS)
    tstate = teng.init_state(tp.gpt_cfg, tp._prefix_width, rows, "cpu",
                             gen_tokens=GEN_TOKENS)
    return (_jax_prefix(jp, cond, codes, n), jstate,
            _torch_prefix(tp, cond, codes, n), tstate)


def _jax_tokens(buf, n):
    return [int(t) for t in np.asarray(buf)[: int(n)]]


def _torch_tokens(buf, n):
    return buf[:n].tolist()


@pytest.mark.parametrize("num_beams", [2, 3])
@pytest.mark.parametrize("length_penalty,rep_pen", [(1.0, 1.0), (1.8, 2.0), (1.0, 2.0),
                                                    (1.8, 1.0)])
def test_torch_decode_beam_matches_jax(pipes, num_beams, length_penalty, rep_pen):
    """HF beam_search: nb 2 / 3 x length penalty 1.0 / 1.8 x repetition
    penalty 1.0 / 2.0; the token lists are equal."""
    jp, tp = pipes
    (je, jv), jst, (te, tv), tst = _inputs(jp, tp, num_beams)
    kw = dict(max_new=MAX_NEW, num_beams=num_beams, length_penalty=length_penalty,
              repetition_penalty=rep_pen, prefix_fake_len=je.shape[1] + 1)
    want = _jax_tokens(*jax.jit(lambda p, st, e, v: jeng.decode_beam(
        p, jp.gpt_cfg, st, e, v, **kw))(jp.gpt_params, jst, je, jv))
    with torch.inference_mode():
        got = _torch_tokens(*teng.decode_beam(tp.gpt, tst, te, tv, **kw))
    assert got == want and len(got) > 1
    assert tst.steps == tst.cur_index - tp._prefix_width - 1 and tst.steps >= 1


@pytest.mark.parametrize("num_beams,temp,top_k,top_p,lp,rep_pen",
                         [(2, 1.3, 8, 1.0, 1.0, 1.0),
                          (3, 0.9, 0, 0.9, 1.8, 2.0),
                          # top_k = 1 < 2 * nb: the min_tokens_to_keep floor
                          (2, 1.0, 1, 1.0, 1.0, 1.0)])
def test_torch_decode_beam_sample_matches_jax(pipes, num_beams, temp, top_k, top_p, lp,
                                              rep_pen):
    """HF beam_sample with the JAX engine's own Gumbel noise
    (``fold_in(rng, step)``) passed through ``noise``: equal tokens."""
    jp, tp = pipes
    (je, jv), jst, (te, tv), tst = _inputs(jp, tp, num_beams)
    kw = dict(max_new=MAX_NEW, num_beams=num_beams, length_penalty=lp,
              repetition_penalty=rep_pen, prefix_fake_len=je.shape[1] + 1,
              do_sample=True, temperature=temp, top_k=top_k, top_p=top_p)
    want = _jax_tokens(*jax.jit(lambda p, st, e, v: jeng.decode_beam(
        p, jp.gpt_cfg, st, e, v, **kw))(jp.gpt_params, jst, je, jv))
    n = num_beams * jp.gpt_cfg.num_audio_tokens

    def noise(s):
        g = jax.random.gumbel(jax.random.fold_in(jax.random.key(KEY), s), (n,), jnp.float32)
        return torch.from_numpy(np.array(g))

    with torch.inference_mode():
        got = _torch_tokens(*teng.decode_beam(tp.gpt, tst, te, tv, noise=noise, **kw))
    assert got == want and len(got) > 1


def test_torch_decode_beam_sample_draws_from_the_generator(pipes):
    """Without ``noise`` beam_sample draws from the state's generator: the
    same seed gives the same tokens."""
    _, tp = pipes
    outs = []
    for _ in range(2):
        _, _, (te, tv), tst = _inputs(pipes[0], tp, 2)
        tst.generator = torch.Generator().manual_seed(5)
        with torch.inference_mode():
            outs.append(_torch_tokens(*teng.decode_beam(
                tp.gpt, tst, te, tv, max_new=MAX_NEW, num_beams=2, do_sample=True,
                temperature=1.3, top_k=8)))
    assert outs[0] == outs[1] and len(outs[0]) > 1


@pytest.mark.parametrize("num_beams,groups", [(4, 2), (6, 3)])
@pytest.mark.parametrize("diversity", [1.0, 0.5])
def test_torch_decode_group_beam_matches_jax(pipes, num_beams, groups, diversity):
    """Group (diverse) beam search: (nb, G) (4, 2) / (6, 3) x diversity
    penalty 1.0 / 0.5, repetition penalty 2.0; equal tokens."""
    jp, tp = pipes
    (je, jv), jst, (te, tv), tst = _inputs(jp, tp, num_beams)
    kw = dict(max_new=MAX_NEW, num_beams=num_beams, num_beam_groups=groups,
              diversity_penalty=diversity, length_penalty=1.0, repetition_penalty=2.0,
              prefix_fake_len=je.shape[1] + 1)
    want = _jax_tokens(*jax.jit(lambda p, st, e, v: jeng.decode_group_beam(
        p, jp.gpt_cfg, st, e, v, **kw))(jp.gpt_params, jst, je, jv))
    with torch.inference_mode():
        got = _torch_tokens(*teng.decode_group_beam(tp.gpt, tst, te, tv, **kw))
    assert got == want and len(got) > 1


def test_torch_group_beam_requires_divisible_groups(pipes):
    _, tp = pipes
    _, _, (te, tv), tst = _inputs(pipes[0], tp, 4)
    with pytest.raises(ValueError, match="divisible"):
        teng.decode_group_beam(tp.gpt, tst, te, tv, max_new=MAX_NEW, num_beams=4,
                               num_beam_groups=3)


@pytest.mark.parametrize("constraints", [[[17, 3]], [[17, 3], [250]]],
                         ids=["one_phrase", "two_phrases"])
def test_torch_decode_constrained_matches_jax(pipes, constraints):
    """Constrained beam search, nb = 3, length penalty 1.0, repetition
    penalty 2.0, with one and with two phrases: equal tokens."""
    jp, tp = pipes
    (je, jv), jst, (te, tv), tst = _inputs(jp, tp, 3)
    kw = dict(max_new=MAX_NEW, num_beams=3, constraints=constraints, length_penalty=1.0,
              repetition_penalty=2.0, prefix_fake_len=je.shape[1] + 1)
    want = _jax_tokens(*jeng.decode_constrained(jp.gpt_params, jp.gpt_cfg, jst, je, jv,
                                                **kw))
    with torch.inference_mode():
        got = _torch_tokens(*teng.decode_constrained(tp.gpt, tst, te, tv, **kw))
    assert got == want and len(got) > 1


def test_torch_phrase_list_state_semantics():
    """The port's tracker against HF's ConstraintListState (and the JAX
    package's copy) on random token streams (JAX
    tests/test_constrained_beam.py::test_phrase_list_state_semantics)."""
    from transformers.generation.beam_constraints import (ConstraintListState,
                                                          PhrasalConstraint)

    rng = np.random.default_rng(0)
    phrases = [[3, 4, 5], [7], [4, 9]]
    for _ in range(50):
        seq = rng.integers(0, 12, size=rng.integers(1, 15)).tolist()
        ours = PhraseListState(phrases)
        ours.reset(seq)
        jax_side = JPhraseListState(phrases)
        jax_side.reset(seq)
        theirs = ConstraintListState([PhrasalConstraint(list(p)) for p in phrases])
        theirs.reset([int(t) for t in seq])
        assert ours.completed == theirs.completed == jax_side.completed, seq
        assert ours.get_bank() == theirs.get_bank() == jax_side.get_bank(), seq
        assert sorted(ours.advance()) == sorted(theirs.advance() or []), seq


def _bits(t):
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("parent", [[1, 2, 0], [2, 2, 0], [0, 1, 2]],
                         ids=["cycle", "duplicate", "identity"])
def test_torch_reorder_rows_is_bit_exact(cache_dtype, parent):
    """Each row of the reordered cache, ``key_valid`` and ``seen`` equals its
    parent's row bit for bit (an e4m3 cache, overflow codes included, moves
    as bits), also when the permutation has a cycle; the old buffers are
    handed back as the next spare."""
    from genvc_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig(layers=3, model_dim=32, heads=2)
    st = teng.init_state(cfg, 8, 3, "cpu", cache_dtype=cache_dtype, gen_tokens=8)
    g = torch.Generator().manual_seed(0)
    for c in (st.cache_k, st.cache_v):
        c.copy_(da.to_cache(torch.randn(c.shape, generator=g) * 300, cache_dtype))
    st.key_valid.copy_(torch.rand(st.key_valid.shape, generator=g) > 0.5)
    st.seen.copy_(torch.rand(st.seen.shape, generator=g) > 0.5)
    before = [_bits(st.cache_k).clone(), _bits(st.cache_v).clone(), st.key_valid.clone(),
              st.seen.clone()]
    spare = (torch.empty_like(st.cache_k), torch.empty_like(st.cache_v))
    spare_ptrs = [t.data_ptr() for t in spare]
    old_ptrs = [t.data_ptr() for t in (st.cache_k, st.cache_v)]
    new_spare = teng.reorder_rows(st, torch.tensor(parent), spare)
    after = [_bits(st.cache_k), _bits(st.cache_v), st.key_valid, st.seen]
    for i, p in enumerate(parent):
        for a, b in zip(after, before):
            assert torch.equal(a[:, i] if a.dim() == 5 else a[i],
                               b[:, p] if b.dim() == 5 else b[p])
    assert [t.data_ptr() for t in (st.cache_k, st.cache_v)] == spare_ptrs
    assert [t.data_ptr() for t in new_spare] == old_ptrs


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float8_e4m3fn])
def test_torch_beam_steps_reorder_cache_by_parent(pipes, cache_dtype):
    """In a beam search on a bf16 / e4m3 cache, after every selection each
    beam's cache row equals, bit for bit, its parent's row of the cache the
    forward wrote, and a parent vector with a repeat or a cycle occurs."""
    _, tp = pipes
    _, _, (te, tv), _ = _inputs(pipes[0], tp, 3)
    tst = teng.init_state(tp.gpt_cfg, tp._prefix_width, 3, "cpu", cache_dtype=cache_dtype,
                          gen_tokens=GEN_TOKENS)
    parents = []
    real = teng.reorder_rows

    def checked(state, parent, spare):
        before = [_bits(state.cache_k).clone(), _bits(state.cache_v).clone()]
        out = real(state, parent, spare)
        for i, p in enumerate(parent.tolist()):
            for a, b in zip((_bits(state.cache_k), _bits(state.cache_v)), before):
                assert torch.equal(a[:, i], b[:, p])
        parents.append(parent.tolist())
        return out

    teng.reorder_rows = checked
    try:
        with torch.inference_mode():
            teng.decode_beam(tp.gpt, tst, te, tv, max_new=MAX_NEW, num_beams=3,
                             repetition_penalty=2.0)
    finally:
        teng.reorder_rows = real
    assert len(parents) >= 2
    assert any(p != [0, 1, 2] for p in parents[1:])
