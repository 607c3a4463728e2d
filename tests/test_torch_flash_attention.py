"""Flash-attention parity: the port's plain versions (what its wrappers run
on CPU tensors) against the JAX Pallas kernels in interpret mode, forward
(``_pallas_attention``, O and LSE) and backward (``_pallas_backward``, dq, dk
and dv); ``FlashAttention``'s gradients against autograd; and the CUDA
kernels against the plain versions on a card.

Tolerances: f32 inputs at atol 2e-5 (both sides compute in f32; the sums run
in other orders). bf16 inputs: O at atol 1e-2, since O is rounded to bf16
(2^-8 relative, |O| < 1 here) on both sides and the f32 sums before the
rounding differ in order; LSE at 2e-5, as it stays f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genvc_tpu.ops.flash_attention import _pallas_attention
from genvc_tpu_torch.ops import flash_attention as tfa

DT = {"f32": (jnp.float32, torch.float32, 2e-5),
      "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _inputs(dt, b=2, h=2, t=128, hd=64, tail=37, seed=0):
    """The same values on both sides (rounded to the dtype in JAX, widened
    exactly to f32 numpy, narrowed exactly again in torch); the last row's last
    ``tail`` keys are masked."""
    rng = np.random.default_rng(seed)
    jd, td, _ = DT[dt]
    qkv = [np.array(jnp.asarray(rng.standard_normal((b, h, t, hd)) * 0.3, jnp.float32)
                    .astype(jd).astype(jnp.float32)) for _ in range(3)]
    valid = np.ones((b, t), bool)
    valid[-1, t - tail:] = False
    jax_in = [jnp.asarray(x).astype(jd) for x in qkv] + [jnp.asarray(valid)]
    torch_in = [torch.from_numpy(x).to(td) for x in qkv] + [torch.from_numpy(valid)]
    return jax_in, torch_in


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("t", [128, 200])
def test_torch_flash_plain_matches_pallas_kernel(t, dt):
    (jq, jk, jv, jvalid), (tq, tk, tv, tvalid) = _inputs(dt, t=t)
    scale = 1.0 / np.sqrt(tq.shape[-1])
    want_o, want_lse = _pallas_attention(jq, jk, jv, jvalid, scale, True,
                                         interpret=True)
    got_o, got_lse = tfa.flash_attention_fwd(tq, tk, tv, tvalid)
    assert got_o.dtype == tq.dtype and got_o.shape == tq.shape
    assert got_lse.dtype == torch.float32 and got_lse.shape == tq.shape[:3]
    np.testing.assert_allclose(got_o.float().numpy(), np.asarray(want_o, np.float32),
                               atol=DT[dt][2], rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=2e-5, rtol=0)
    torch.testing.assert_close(tfa.flash_attention(tq, tk, tv, tvalid), got_o,
                               rtol=0, atol=0)


def test_torch_flash_plain_non_causal_and_unseen_keys_match_pallas_kernel():
    """Not causal; and a row whose keys are all masked takes the Pallas
    kernel's uniform mean over its padded key width."""
    (jq, jk, jv, jvalid), (tq, tk, tv, tvalid) = _inputs("f32", t=72, hd=16, seed=2)
    scale = 0.3
    for causal in (False, True):
        want_o, want_lse = _pallas_attention(jq, jk, jv, jvalid, scale, causal,
                                             interpret=True)
        got_o, got_lse = tfa.flash_attention_fwd(tq, tk, tv, tvalid, scale, causal)
        np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=2e-5, rtol=0)
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=2e-5, rtol=0)
    jvalid = jvalid.at[0].set(False)
    tvalid = tvalid.clone()
    tvalid[0] = False
    want_o, _ = _pallas_attention(jq, jk, jv, jvalid, scale, True, interpret=True)
    got_o, _ = tfa.flash_attention_fwd(tq, tk, tv, tvalid, scale, True)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_o[0, 0, 0].numpy(), tv[0, 0].sum(0).numpy() / 128,
                               atol=2e-5, rtol=0)


def test_torch_flash_attention_rejects_what_the_kernel_does_not_take():
    _, (tq, tk, tv, tvalid) = _inputs("f32", t=16, hd=16)
    with pytest.raises(ValueError, match="dtypes"):
        tfa.flash_attention(tq.half(), tk.half(), tv.half(), tvalid)
    with pytest.raises(ValueError, match="dtypes"):
        tfa.flash_attention(tq, tk.bfloat16(), tv, tvalid)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(tq[..., :12], tk[..., :12], tv[..., :12], tvalid)
    with pytest.raises(ValueError, match="must be equal"):
        tfa.flash_attention(tq, tk[:, :, :8], tv, tvalid)
    with pytest.raises(ValueError, match="kv_valid"):
        tfa.flash_attention(tq, tk, tv, tvalid.float())
    with pytest.raises(ValueError, match="kv_valid"):
        tfa.flash_attention(tq, tk, tv, tvalid[:, :8])
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention(*(x.to("meta") for x in (tq, tk, tv, tvalid)))


# ---- the bf16 kernel's tile arithmetic (csrc/flash_attention.cu), in torch

TILE_WARPS, TILE_SLICE = 4, 16  # warps of a block; keys of a tile per warp


def _tile_attention(q, k, v, valid, scale, causal):
    """What the bf16 kernel computes, in f32 torch: each warp runs an online
    softmax over its 16 keys of every 64-key tile (keys past T masked, their
    v zero) with p rounded to bf16 before P.V; the four warps' (m, l, O) are
    combined, and the padded columns (to a multiple of 128) that were not
    summed are added to l. Slices the kernel skips past the causal diagonal
    are all masked for their tile's rows, so running them too changes no
    number. Returns (O in q's dtype, LSE)."""
    b, h, t, hd = q.shape
    neg = -1e9
    tile = TILE_WARPS * TILE_SLICE
    t_keys = -(-t // tile) * tile
    pad = t_keys - t
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    ok = torch.nn.functional.pad(valid, (0, pad), value=False)[:, None, None, :]
    if causal:
        col = torch.arange(t_keys)
        ok = ok & (col[None, :] <= torch.arange(t)[:, None])
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    s = torch.where(ok, s, torch.full_like(s, neg))
    ms, ls, os_ = [], [], []
    for w in range(TILE_WARPS):
        m = torch.full((b, h, t, 1), neg)
        l = torch.zeros(b, h, t, 1)
        o = torch.zeros(b, h, t, hd)
        for k0 in range(w * TILE_SLICE, t_keys, tile):
            sl = s[..., k0:k0 + TILE_SLICE]
            m_new = torch.maximum(m, sl.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sl - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + torch.matmul(p.to(torch.bfloat16).float(),
                                         vf[:, :, k0:k0 + TILE_SLICE])
            m = m_new
        ms.append(m), ls.append(l), os_.append(o)
    m = torch.stack(ms).amax(0)
    f = [torch.exp(mw - m) for mw in ms]
    l = sum(lw * fw for lw, fw in zip(ls, f))
    l = l + (-(-t // 128) * 128 - t_keys) * torch.exp(neg - m)
    o = sum(ow * fw for ow, fw in zip(os_, f)) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [128, 200])
def test_torch_flash_tile_arithmetic_with_bf16_p_matches_pallas_kernel(t, causal):
    """The bf16 kernel's arithmetic (p rounded to bf16 before P.V, per-warp
    online softmax, in-block combine) against the Pallas forward in
    interpret mode, bf16 inputs: O within 1e-2 (FLASH_TOL: O rounds to bf16
    on both sides, p's rounding adds 2^-9 of each weight), LSE within 1e-4
    (from the f32 p). A masked tail in batch row 1; in batch row 0 the
    first 5 keys masked (causal: rows 0-4 see no valid key) or every key
    (not causal): such rows take the uniform mean over the padded width."""
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs("bf16", t=t, seed=7)
    valid = np.ones((2, t), bool)
    valid[1, t - 37:] = False
    if causal:
        valid[0, :5] = False
    else:
        valid[0] = False
    scale = 1.0 / np.sqrt(tq.shape[-1])
    want_o, want_lse = _pallas_attention(jq, jk, jv, jnp.asarray(valid), scale, causal,
                                         interpret=True)
    got_o, got_lse = _tile_attention(tq, tk, tv, torch.from_numpy(valid), scale, causal)
    assert got_o.dtype == torch.bfloat16
    np.testing.assert_allclose(got_o.float().numpy(), np.asarray(want_o, np.float32),
                               atol=1e-2, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=1e-4, rtol=0)
    unseen = got_o[0, :, :5] if causal else got_o[0]
    np.testing.assert_allclose(unseen.float().numpy(),
                               np.broadcast_to(tv[0].float().sum(1, keepdim=True).numpy()
                                               / -(-t // 128) / 128, unseen.shape),
                               atol=1e-2, rtol=0)


# (B, T, hd, masked tail of the last row, masked leading keys of row 0, row 0
# all masked, causal): the latent pass, the training step, and the bf16
# kernel's tile edges (16 query rows, 64 keys a tile; hd padded to 16)
CUDA_FLASH_CASES = [(1, 308, 256, 50, 0, False, True), (8, 184, 256, 0, 0, False, True),
                    (1, 11, 256, 0, 0, False, True), (2, 77, 256, 5, 0, False, True),
                    (2, 184, 64, 9, 0, False, True), (2, 184, 72, 9, 0, False, True),
                    (2, 184, 256, 0, 37, False, True), (2, 136, 256, 11, 0, True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_FLASH_CASES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_torch_cuda_flash_kernel_matches_plain(dt, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    b, t, hd, tail, lead, unseen, causal = case
    _, cpu_in = _inputs(dt, b=b, h=4, t=t, hd=hd, tail=tail)
    tq, tk, tv, tvalid = (x.cuda() for x in cpu_in)
    tvalid[0, :lead] = False
    if unseen:
        tvalid[0] = False
    before = tfa.flash_attention.launches
    got_o, got_lse = tfa.flash_attention_fwd(tq, tk, tv, tvalid, None, causal)
    want_o, want_lse = tfa.flash_attention_plain(tq, tk, tv, tvalid, None, causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    np.testing.assert_allclose(got_o.float().cpu().numpy(), want_o.float().cpu().numpy(),
                               atol=DT[dt][2], rtol=0)
    np.testing.assert_allclose(got_lse.cpu().numpy(), want_lse.cpu().numpy(),
                               atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# Backward (K5: dq, K6: dk / dv). The plain version against the Pallas
# backward in interpret mode, from the Pallas forward's LSE, in f32 at atol
# 2e-5 (both sides compute in f32; the sums run in other orders).


def _bwd_inputs(t, causal, seed, b=2, h=2, hd=16):
    """f32 inputs on both sides; batch row 0 has its first 5 keys and a tail
    of 9 masked (under causal its first rows see no valid key), batch row 1
    has every key masked (non-causal: rows with no valid key at all) or a
    tail of 21 (causal)."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, h, t, hd)).astype(np.float32) * 0.5
                  for _ in range(4))
    valid = np.ones((b, t), bool)
    valid[0, :5] = False
    valid[0, t - 9:] = False
    if causal:
        valid[1, t - 21:] = False
    else:
        valid[1] = False
    return q, k, v, g, valid


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [128, 136])
def test_torch_flash_bwd_plain_matches_pallas_backward(t, causal):
    from genvc_tpu.ops.flash_attention import _pallas_backward

    q, k, v, g, valid = _bwd_inputs(t, causal, seed=t + causal)
    scale = 1.0 / np.sqrt(q.shape[-1])
    jq, jk, jv, jg, jvalid = (jnp.asarray(x) for x in (q, k, v, g, valid))
    out, lse = _pallas_attention(jq, jk, jv, jvalid, scale, causal, interpret=True)
    want = _pallas_backward(jq, jk, jv, jvalid, out, lse, jg, scale, causal,
                            interpret=True)
    tq, tk, tv, tg, tvalid = (torch.from_numpy(x) for x in (q, k, v, g, valid))
    got = tfa.flash_attention_bwd(tq, tk, tv, tvalid, torch.from_numpy(np.array(out)),
                                  torch.from_numpy(np.array(lse)), tg, scale, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == tq.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=0,
                                   err_msg=name)
    # rows that see no valid key take p = exp(-1e9 - LSE) = 1 on every key
    unseen = 1 if not causal else 0
    np.testing.assert_allclose(np.asarray(lse)[unseen, :, :5], -1e9)
    assert np.abs(got[0][unseen, :, :5].numpy()).max() > 0


# ---- the bf16 backward kernels' arithmetic (csrc/flash_attention_bwd.cu), in torch


DQ_GROUP, DKDV_TILE = 16, 64  # K5's query rows per warp group; K6's per query tile


def _bf16_parts(x, rows_split, rows):
    """``x`` (B, H, T, T) rounded to bf16, but carried as bf16(x) +
    bf16(x - bf16(x)) in the query rows of the ``rows``-row groups where
    ``rows_split`` (B, T) holds a True."""
    hi = x.to(torch.bfloat16).float()
    b, t = rows_split.shape
    pad = -t % rows
    grp = torch.nn.functional.pad(rows_split, (0, pad)).reshape(b, -1, rows).any(-1)
    grp = grp.repeat_interleave(rows, 1)[:, :t][:, None, :, None]
    return torch.where(grp, hi + (x - hi).to(torch.bfloat16).float(), hi)


def _tile_backward(q, k, v, valid, out, lse, g, scale, causal):
    """What the bf16 K5 and K6 compute, in f32 torch: s, p = exp(s - LSE),
    dp and ds = p (dp - D) in f32 from the bf16 inputs; p and ds rounded to
    bf16 before the second products, except that ds is carried as two bf16
    parts in a K5 query group (16 rows) or K6 query tile (64 rows) holding a
    row that sees no valid key. K5: dQ = dS.K (scaled), each element summed
    over the keys in one order; K6: dV = P^T.dO and dK = dS^T.Q (scaled),
    summed over the query tiles. Keys and slices the kernels skip past the
    causal diagonal have p = 0 here, so they add nothing. Returns (dq, dk,
    dv) in q's dtype."""
    t = q.shape[2]
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    dd = (gf * out.float()).sum(-1, keepdim=True)
    ok = valid[:, None, None, :]
    rows = torch.arange(t)
    if causal:
        ok = ok & (rows[None, :] <= rows[:, None])
        unseen = rows[None, :] < valid.int().argmax(1, keepdim=True)
        unseen = unseen | ~valid.any(1, keepdim=True)
    else:
        unseen = ~valid.any(1, keepdim=True).expand(-1, t)
    s = torch.where(ok, torch.matmul(qf, kf.transpose(-1, -2)) * scale,
                    torch.full((), -1e9))
    p = torch.exp(s - lse[..., None])
    ds = p * (torch.matmul(gf, vf.transpose(-1, -2)) - dd)
    p16 = p.to(torch.bfloat16).float()
    ds_q, ds_k = (_bf16_parts(ds, unseen, n) for n in (DQ_GROUP, DKDV_TILE))
    dq = torch.matmul(ds_q, kf) * scale
    dk = torch.matmul(ds_k.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p16.transpose(-1, -2), gf)
    return tuple(x.to(q.dtype) for x in (dq, dk, dv))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [128, 136])
def test_torch_flash_bwd_tile_arithmetic_with_bf16_p_ds_matches_pallas_backward(t, causal):
    """The bf16 backward kernels' arithmetic (p and ds rounded to bf16 before
    the second products, ds in two bf16 parts where rows see no valid key)
    against
    the Pallas backward in interpret mode, bf16 inputs with ``_bwd_inputs``'
    masked keys and rows that see no valid key: dq, dk and dv within
    1e-2 + 1e-2 |w| (BWD_TOL for bf16 in chip_smoke.py: the outputs round to
    bf16 on both sides, p and ds add 2^-9 of each term)."""
    from genvc_tpu.ops.flash_attention import _pallas_backward

    arrays = _bwd_inputs(t, causal, seed=20 + t + causal, hd=64)
    q, k, v, g = (np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
                  for x in arrays[:4])
    valid = arrays[4]
    scale = 1.0 / np.sqrt(q.shape[-1])
    jq, jk, jv, jg = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v, g))
    jvalid = jnp.asarray(valid)
    out, lse = _pallas_attention(jq, jk, jv, jvalid, scale, causal, interpret=True)
    want = _pallas_backward(jq, jk, jv, jvalid, out, lse, jg, scale, causal,
                            interpret=True)
    tq, tk, tv, tg = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, g))
    got = _tile_backward(tq, tk, tv, torch.from_numpy(valid),
                         torch.from_numpy(np.array(out, np.float32)).to(torch.bfloat16),
                         torch.from_numpy(np.array(lse)), tg, scale, causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16, name
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(a.float().numpy(), w, atol=1e-2, rtol=1e-2, err_msg=name)


def test_torch_flash_attention_gradients_match_autograd_of_plain():
    """``FlashAttention`` (forward K4, backward K5 + K6; their plain versions
    here) against autograd through :func:`flash_attention_plain`, on rows
    that all see a valid key, where the Pallas backward's formula is the
    true gradient. f32, atol 1e-5."""
    rng = np.random.default_rng(3)
    b, h, t, hd = 2, 2, 40, 16
    base = [torch.from_numpy(rng.standard_normal((b, h, t, hd)).astype(np.float32))
            for _ in range(3)]
    w = torch.from_numpy(rng.standard_normal((b, h, t, hd)).astype(np.float32))
    valid = torch.ones(b, t, dtype=torch.bool)
    valid[1, t - 11:] = False
    for causal in (True, False):
        grads = []
        for fn in (lambda q, k, v: tfa.flash_attention(q, k, v, valid, 0.3, causal),
                   lambda q, k, v: tfa.flash_attention_plain(q, k, v, valid, 0.3, causal)[0]):
            qkv = [x.clone().requires_grad_(True) for x in base]
            (fn(*qkv) * w).sum().backward()
            grads.append([x.grad for x in qkv])
        for a, want in zip(*grads):
            torch.testing.assert_close(a, want, atol=1e-5, rtol=0)


def test_torch_flash_bwd_rejects_what_the_kernels_do_not_take():
    _, (tq, tk, tv, tvalid) = _inputs("f32", t=16, hd=16)
    out, lse = tfa.flash_attention_fwd(tq, tk, tv, tvalid)
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention_bwd(*(x.to("meta") for x in (tq, tk, tv, tvalid, out, lse, out)))
    with pytest.raises(ValueError, match="dtypes"):
        tfa.flash_attention_bwd(tq.half(), tk.half(), tv.half(), tvalid, out, lse, out)


# (T, causal, masked tail of every batch row): the training step's T = 184,
# the recipe's 100-token maximum T = 328, a masked tail of every row, and
# not causal (batch row 1 then sees no valid key)
CUDA_BWD_CASES = [(184, True, 0), (328, True, 0), (328, True, 45), (136, False, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_BWD_CASES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_torch_cuda_flash_bwd_kernels_match_plain(dt, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    t, causal, tail = case
    q, k, v, g, valid = (torch.from_numpy(x).cuda() for x in _bwd_inputs(t, causal, 0,
                                                                         b=2, h=4, hd=256))
    if tail:
        valid[:, t - tail:] = False
    q, k, v, g = (x.to(DT[dt][1]) for x in (q, k, v, g))
    out, lse = tfa.flash_attention_fwd(q, k, v, valid, None, causal)
    before = (tfa.flash_attention_dq.launches, tfa.flash_attention_dkdv.launches)
    got = tfa.flash_attention_bwd(q, k, v, valid, out, lse, g, None, causal)
    want = tfa.flash_attention_bwd_plain(q, k, v, valid, out, lse, g, None, causal)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_dq.launches, tfa.flash_attention_dkdv.launches) == \
        (before[0] + 1, before[1] + 1)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=DT[dt][2], rtol=DT[dt][2])
