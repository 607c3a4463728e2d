"""Decode-attention parity: the port's plain version (what its wrapper runs on
CPU tensors) against the JAX Pallas kernels in interpret mode, and the CUDA
kernel against the plain version on a card.

Tolerance: atol/rtol 2e-2 with a bf16 cache, 3e-2 with an e4m3 cache. Both
sides round the probabilities to bf16 before P.V, and the output to bf16 when
q is bf16 (2^-8 relative per rounding); the sums run in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genvc_tpu.ops import decode_attention as jda
from genvc_tpu_torch.ops import decode_attention as tda

CACHE = {"bf16": (jnp.bfloat16, torch.bfloat16, 2e-2),
         "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn, 3e-2)}
QD = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


def _inputs(cache, qd, L=3, b=2, h=2, t=256, hd=128, seed=0):
    """The same values on both sides: rounded to the storage type in JAX,
    widened exactly to f32 numpy, then narrowed again (exactly) in torch."""
    rng = np.random.default_rng(seed)
    jc, tc, _ = CACHE[cache]
    jq, tq = QD[qd]
    q = np.array(jnp.asarray(rng.standard_normal((b, h, hd)), jnp.float32)
                   .astype(jq).astype(jnp.float32))
    ck = np.array(jnp.asarray(rng.standard_normal((L, b, h, t, hd)), jnp.float32)
                    .astype(jc).astype(jnp.float32))
    cv = np.array(jnp.asarray(rng.standard_normal((L, b, h, t, hd)), jnp.float32)
                    .astype(jc).astype(jnp.float32))
    lens = rng.integers(1, t + 1, b)
    lens[0] = 1  # a row with only one valid key
    bias = np.where(np.arange(t)[None, :] < lens[:, None], 0.0, -1e9).astype(np.float32)
    jax_in = (jnp.asarray(q).astype(jq), jnp.asarray(ck).astype(jc),
              jnp.asarray(cv).astype(jc), jnp.asarray(bias))
    torch_in = (torch.from_numpy(q).to(tq), torch.from_numpy(ck).to(tc),
                torch.from_numpy(cv).to(tc), torch.from_numpy(bias))
    return jax_in, torch_in


@pytest.mark.parametrize("qd", ["bf16", "f32"])
@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
def test_torch_layer_plain_matches_jax_kernel(cache, qd):
    (jq, jk, jv, jb), (tq, tk, tv, tb) = _inputs(cache, qd)
    tol = CACHE[cache][2]
    for layer in range(3):
        want = np.asarray(jda.decode_attention_layer(jq, jk, jv, jb, layer,
                                                     interpret=True), np.float32)
        got = tda.decode_attention_layer(tq, tk, tv, tb, layer)
        assert got.dtype == tq.dtype and got.shape == tq.shape
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
def test_torch_single_layer_plain_matches_jax_kernel(cache):
    (jq, jk, jv, jb), (tq, tk, tv, tb) = _inputs(cache, "bf16", seed=1)
    tol = CACHE[cache][2]
    want = np.asarray(jda.decode_attention(jq, jk[1], jv[1], jb, interpret=True),
                      np.float32)
    got = tda.decode_attention(tq, tk[1], tv[1], tb)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    # the row with one valid key returns that key's value row
    np.testing.assert_allclose(got[0].float().numpy(), tv[1, 0, :, 0].float().numpy(),
                               atol=tol, rtol=tol)


def test_torch_decode_attention_rejects_what_the_kernel_does_not_take():
    (_, (tq, tk, tv, tb)) = _inputs("bf16", "bf16", t=16, hd=16)
    with pytest.raises(ValueError, match="cache dtype"):
        tda.decode_attention_layer(tq, tk.float(), tv.float(), tb, 0)
    with pytest.raises(ValueError, match="head dim"):
        tda.decode_attention_layer(tq[..., :12], tk[..., :12], tv[..., :12], tb, 0)
    with pytest.raises(IndexError):
        tda.decode_attention_layer(tq, tk, tv, tb, 3)
    with pytest.raises(ValueError, match="do not match"):
        tda.decode_attention_layer(tq, tk, tv, tb[:, :8], 0)


# ---- K1's split of the cache length, carried out in torch on the CPU


def _split_attention(q, ck, cv, bias, layer, n_split):
    """The arithmetic of K1's split kernels (csrc/decode_attention.cu) in
    torch: (a) per key range, the logits (scaled, bias added) and the local
    (max, sum of exp); (b) the global (M, L) from the S pairs, p =
    bf16(exp(x - M) / L) per range, the range's P.V in f32; then the partials
    summed in the order s = 0..S-1."""
    k = ck[layer].to(torch.bfloat16).float()
    v = cv[layer].to(torch.bfloat16).float()
    return _split_passes(q, k, v, bias, n_split)


def _split_passes(q, k, v, bias, n_split):
    """The two passes of the split over widened (B, H, T, hd) K and V."""
    hd, t = q.shape[-1], k.shape[2]
    per = -(-t // n_split)
    qf = q.to(torch.bfloat16).float()
    logits = torch.einsum("bhd,bhtd->bht", qf, k) * (1.0 / np.sqrt(hd)) + bias[:, None, :]
    ranges = [(s * per, min(t, (s + 1) * per)) for s in range(n_split)]
    m = torch.stack([logits[..., a:b].amax(-1) for a, b in ranges])       # (S, B, H)
    l = torch.stack([torch.exp(logits[..., a:b] - m[i, ..., None]).sum(-1)
                     for i, (a, b) in enumerate(ranges)])
    big_m = m.amax(0)
    big_l = (l * torch.exp(m - big_m)).sum(0)
    out = torch.zeros_like(qf)
    for a, b in ranges:
        p = (torch.exp(logits[..., a:b] - big_m[..., None]) / big_l[..., None])
        out = out + torch.einsum("bht,bhtd->bhd", p.to(torch.bfloat16).float(), v[:, :, a:b])
    return out.to(q.dtype)


@pytest.mark.parametrize("n_split", [1, 3, 8])  # 8 = T / 32
@pytest.mark.parametrize("qd", ["bf16", "f32"])
@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
def test_torch_split_arithmetic_matches_jax_kernel_and_plain(cache, qd, n_split):
    """K1's split normalises by the global max and sum before the bf16
    rounding, as the Pallas body does: within TOL of the Pallas kernel
    (interpret mode) and of the plain version, the row with one valid key
    included. TOL, because the bf16 probabilities round at 2^-8 and the f32
    sums run in another order."""
    (jq, jk, jv, jb), (tq, tk, tv, tb) = _inputs(cache, qd, seed=5)
    tol = CACHE[cache][2]
    layer = 1
    got = _split_attention(tq, tk, tv, tb, layer, n_split)
    want = np.asarray(jda.decode_attention_layer(jq, jk, jv, jb, layer, interpret=True),
                      np.float32)
    plain = tda.decode_attention_layer_plain(tq, tk, tv, tb, layer)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), atol=tol, rtol=tol)
    np.testing.assert_allclose(got[0].float().numpy(), tv[layer, 0, :, 0].float().numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("n_blocks", [528, 132, 16])
def test_torch_split_len_covers_the_cache_with_nonempty_ranges(n_blocks):
    """The wrapper's split: ranges of at least MIN_SPLIT_KEYS keys (the last
    may be shorter, never empty); B*H*S at least half the block target when
    the cache is long enough, one range once B*H reaches the target."""
    for bh in (1, 4, 16, 64, 132, 200, 600):
        for t in (1, 15, 16, 17, 128, 384, 1000, 1024):
            per = tda.split_len(bh, t, n_blocks)
            s = -(-t // per)  # the kernel's grid.y
            assert per >= tda.MIN_SPLIT_KEYS and (s - 1) * per < t <= s * per
            if bh >= n_blocks:
                assert s == 1
            elif t >= tda.MIN_SPLIT_KEYS * -(-n_blocks // bh):
                assert 2 * bh * s >= n_blocks


# (B, T, cache layers): the flagship cache (30 layers, B = 16, T = 384) read at
# its first and last layer, and the split's edges at fewer layers
@pytest.mark.cuda
@pytest.mark.parametrize("b,t,n_layers", [(16, 384, 30), (1, 128, 4), (1, 384, 30),
                                           (4, 1024, 4), (16, 1024, 4)])
@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
def test_torch_cuda_kernel_matches_plain(cache, b, t, n_layers):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _, (tq, tk, tv, tb) = _inputs(cache, "bf16", L=n_layers, b=b, h=4, t=t, hd=256)
    tq, tk, tv, tb = (x.cuda() for x in (tq, tk, tv, tb))
    tol = CACHE[cache][2]
    before = tda.decode_attention_layer.launches
    for layer in (0, n_layers - 1):
        got = tda.decode_attention_layer(tq, tk, tv, tb, layer).float().cpu()
        want = tda.decode_attention_layer_plain(tq, tk, tv, tb, layer).float().cpu()
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol, rtol=tol)
    assert tda.decode_attention_layer.launches == before + 2


# ---- K3: the per-row cache write + attention (decode_attention_update_layer)

UPDATE_TOL = {"bf16": 4e-3, "e4m3": 2e-2}


def _update_inputs(cache, qd, positions, seed=0):
    """JAX test_decode_attention.py:84's case (L=3, H=2, T=64, hd=128; B = 4
    there, one row per position here): the same values on both sides, q /
    k_new / v_new exact in ``qd``."""
    rng = np.random.default_rng(seed)
    jc, tc, _ = CACHE[cache]
    jq, tq = QD[qd]
    L, B, H, T, hd = 3, len(positions), 2, 64, 128

    def stored(x, jt):
        return np.array(jnp.asarray(x, jnp.float32).astype(jt).astype(jnp.float32))

    ck, cv = (stored(rng.standard_normal((L, B, H, T, hd)) * 0.3, jc) for _ in range(2))
    q, kn, vn = (stored(rng.standard_normal((B, H, hd)) * 0.3, jq) for _ in range(3))
    valid = np.zeros((B, T), bool)
    for i, p in enumerate(positions):
        valid[i, : min(p, T - 1) + 1] = True
    bias = np.where(valid, 0.0, -1e9).astype(np.float32)
    jax_in = (jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(kn), jnp.asarray(vn),
              jnp.asarray(ck).astype(jc), jnp.asarray(cv).astype(jc), jnp.asarray(bias))
    torch_in = tuple(torch.from_numpy(x).to(tq) for x in (q, kn, vn)) + tuple(
        torch.from_numpy(x).to(tc) for x in (ck, cv)) + (torch.from_numpy(bias),)
    return jax_in, torch_in


def _bits(x):
    return x.view(torch.uint8).numpy() if x.dtype == torch.float8_e4m3fn else \
        x.view(torch.int16).numpy()


def _jbits(x, cache):
    return np.asarray(x).view(np.uint8 if cache == "e4m3" else np.int16)


@pytest.mark.parametrize("qd", ["bf16", "f32"])
@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
def test_torch_update_layer_plain_matches_jax_kernel(cache, qd):
    """Caches bit-equal to the Pallas kernel's (interpret mode) on every
    layer; ``out`` within 4e-3 (bf16 cache) / 2e-2 (e4m3 cache)."""
    positions = [5, 37, 0, 63]
    (jq, jkn, jvn, jck, jcv, jb), (tq, tkn, tvn, tck, tcv, tb) = \
        _update_inputs(cache, qd, positions)
    out, jck2, jcv2 = jda.decode_attention_update_layer(
        jq, jkn, jvn, jck, jcv, jb, jnp.asarray(positions, jnp.int32), 1, interpret=True)
    got = tda.decode_attention_update_layer(tq, tkn, tvn, tck, tcv, tb,
                                            torch.tensor(positions), 1)
    np.testing.assert_array_equal(_bits(tck), _jbits(jck2, cache))
    np.testing.assert_array_equal(_bits(tcv), _jbits(jcv2, cache))
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(out, np.float32),
                               atol=UPDATE_TOL[cache])


@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
def test_torch_update_layer_drops_rows_past_the_cache(cache):
    """A row at pos >= T writes nothing (JAX's ``.at[].set`` drops it): the
    caches equal JAX's scatter bit for bit, and ``out`` equals K1 over them."""
    positions = [5, 64, 0, 97]  # T = 64
    (jq, jkn, jvn, jck, jcv, jb), (tq, tkn, tvn, tck, tcv, tb) = \
        _update_inputs(cache, "bf16", positions, seed=3)
    rows, pos = jnp.arange(4), jnp.asarray(positions, jnp.int32)
    jck2 = jck.at[2, rows, :, pos, :].set(jkn.astype(jck.dtype))
    jcv2 = jcv.at[2, rows, :, pos, :].set(jvn.astype(jcv.dtype))
    want = jda.decode_attention_layer(jq, jck2, jcv2, jb, 2, interpret=True)
    before = tck.clone()
    got = tda.decode_attention_update_layer(tq, tkn, tvn, tck, tcv, tb,
                                            torch.tensor(positions, dtype=torch.int32), 2)
    np.testing.assert_array_equal(_bits(tck), _jbits(jck2, cache))
    np.testing.assert_array_equal(_bits(tcv), _jbits(jcv2, cache))
    np.testing.assert_array_equal(_bits(tck[:, 1]), _bits(before[:, 1]))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=UPDATE_TOL[cache])


# ---- e4m3 at overflow: the JAX package's astype bits, read as its kernels read

OVERFLOW = [1e4, 460.0, 500.0, -1e4, 464.0, 447.0]
OVERFLOW_BITS = [0x7F, 0x7E, 0x7F, 0xFF, 0x7E, 0x7E]
OVERFLOW_READ = [480.0, 448.0, 480.0, -480.0, 448.0, 448.0]


# ---- K3 as the split: the row write folded into the logits pass


def _split_update_attention(q, kn, vn, ck, cv, bias, pos, layer, n_split):
    """The arithmetic of K3's split kernels (csrc/decode_attention.cu) in
    torch, caches updated in place: (a) the block whose key range holds
    pos[b] rounds the new K / V rows to the cache type (``to_cache``) and
    stores them at row pos[b] (a pos outside [0, T) lies in no range: no
    write); its logit at pos[b] takes the rounded K row it holds, widened as
    a read widens it, every other key comes from the cache as it was before
    the launch; (b) reads V after (a)'s store, then K1's global (M, L),
    bf16 p, partial P.V and the fixed-order combine."""
    t = ck.shape[3]
    per = -(-t // n_split)
    k = tda.widen(ck[layer]).float()              # read by (a): before the store
    for b, p in enumerate(pos.tolist()):
        if not 0 <= p < t:
            continue
        s = p // per                              # the owning block's range
        assert s * per <= p < min(t, (s + 1) * per)
        k_row, v_row = tda.to_cache(kn[b], ck.dtype), tda.to_cache(vn[b], cv.dtype)
        ck[layer, b, :, p], cv[layer, b, :, p] = k_row, v_row
        k[b, :, p] = tda.widen(k_row).float()     # the owner's substitution
    v = tda.widen(cv[layer]).float()              # read by (b): after the store
    return _split_passes(q, k, v, bias, n_split)


@pytest.mark.parametrize("n_split", [1, 3, 8])
@pytest.mark.parametrize("qd", ["bf16", "f32"])
@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
def test_torch_split_update_arithmetic_matches_jax_kernel_and_plain(cache, qd, n_split):
    """K3's split holds to the Pallas K3 (interpret mode) and to the plain
    version: caches bit-equal and ``out`` within TOL, with rows at pos 0,
    T - 1, past the end (T + 7), and on both edges of a key range (per * k
    - 1 and per * k, the last key of one block and the first of the next),
    one of them holding the overflow values (K: OVERFLOW, V: -OVERFLOW).
    pos is int32 with a bf16 q and int64 (the engine's) with an f32 q.

    Two stated exceptions on the Pallas side: its slab write-back clamps a
    past-end slab index and there rewrites another row, so the caches are
    held to the JAX package's scatter (``.at[].set``, which drops the row,
    as the port does) and to the Pallas kernel on every other row; and its
    own ``out`` reads an overflowed e4m3 code it has just rounded in
    registers differently from what it stores (see the overflow test
    below), so on that row ``out`` is held to ``decode_attention_layer``
    over the JAX caches instead."""
    t, n_layers, layer = 64, 3, 1
    per = -(-t // n_split)
    k = max(1, n_split // 2)
    positions = [0, t - 1, t + 7, per * k - 1, per * k, 37]
    over_row = 3
    (jq, jkn, jvn, jck, jcv, jb), (tq, tkn, tvn, tck, tcv, tb) = \
        _update_inputs(cache, qd, positions, seed=17 + n_split)
    over = np.asarray(OVERFLOW, np.float32)
    jkn, jvn = jkn.at[over_row, :, :6].set(over), jvn.at[over_row, :, :6].set(-over)
    tkn[over_row, :, :6] = torch.from_numpy(over).to(tkn.dtype)
    tvn[over_row, :, :6] = torch.from_numpy(-over).to(tvn.dtype)
    tol = CACHE[cache][2]
    pos = torch.tensor(positions, dtype=torch.int32 if qd == "bf16" else torch.int64)

    jpos = jnp.asarray(positions, jnp.int32)
    jout, pk, pv = jda.decode_attention_update_layer(jq, jkn, jvn, jck, jcv, jb, jpos,
                                                     layer, interpret=True)
    rows = jnp.arange(len(positions))
    sk = jck.at[layer, rows, :, jpos].set(jkn.astype(jck.dtype))
    sv = jcv.at[layer, rows, :, jpos].set(jvn.astype(jcv.dtype))
    jwant = np.asarray(jda.decode_attention_layer(jq, sk, sv, jb, layer, interpret=True),
                       np.float32)
    plain_k, plain_v = tck.clone(), tcv.clone()
    plain = tda.decode_attention_update_layer_plain(tq, tkn, tvn, plain_k, plain_v, tb,
                                                    pos, layer)
    before = tck.clone()
    got = _split_update_attention(tq, tkn, tvn, tck, tcv, tb, pos, layer, n_split)

    assert got.dtype == tq.dtype and got.shape == tq.shape
    in_cache = [b for b, p in enumerate(positions) if p < t]
    for mine, scatter, pallas, ref in ((tck, sk, pk, plain_k), (tcv, sv, pv, plain_v)):
        np.testing.assert_array_equal(_bits(mine), _jbits(scatter, cache))
        np.testing.assert_array_equal(_bits(mine)[:, in_cache],
                                      _jbits(pallas, cache)[:, in_cache])
        np.testing.assert_array_equal(_bits(mine), _bits(ref))
    np.testing.assert_array_equal(_bits(tck[:, 2]), _bits(before[:, 2]))
    if cache == "e4m3":
        assert _bits(tck)[layer, over_row, 0, per * k - 1, :6].tolist() == OVERFLOW_BITS
    got = got.float().numpy()
    np.testing.assert_allclose(got, plain.float().numpy(), atol=tol, rtol=tol)
    np.testing.assert_allclose(got, jwant, atol=tol, rtol=tol)
    held = [b for b in range(len(positions)) if cache == "bf16" or b != over_row]
    np.testing.assert_allclose(got[held], np.asarray(jout, np.float32)[held],
                               atol=tol, rtol=tol)


def test_torch_e4m3_overflow_cache_bits_and_attention_match_jax():
    """K/V rows holding OVERFLOW, written into an e4m3 cache by the port's
    lockstep write (``to_cache``, what the engine calls) and per-row update
    (``decode_attention_update_layer``, its plain version here), and by the
    JAX package (``astype``; ``decode_attention_update_layer`` in interpret
    mode): the caches are equal to the bit (0x7F / 0xFF where the value
    rounds past 448), the port reads those codes as +-480, and its attention
    over them matches ``decode_attention_layer`` (interpret mode) over the
    JAX package's cache within the e4m3 tolerance. The interpret-mode
    update kernel's own ``out`` is not the yardstick: it reads the row it
    has just rounded in registers, and there gives one of the 0xFF codes
    (from -500) the value 0, though its cache stores 0xFF."""
    positions = [5, 37, 0, 63]
    (jq, jkn, jvn, jck, jcv, jb), (tq, tkn, tvn, tck, tcv, tb) = \
        _update_inputs("e4m3", "f32", positions, seed=11)
    over = np.asarray(OVERFLOW, np.float32)
    jkn, jvn = jkn.at[:, :, :6].set(over), jvn.at[:, :, :6].set(-over)
    tkn[:, :, :6], tvn[:, :, :6] = torch.from_numpy(over), torch.from_numpy(-over)
    tol = CACHE["e4m3"][2]

    # per-row update, layer 1
    _, jck2, jcv2 = jda.decode_attention_update_layer(
        jq, jkn, jvn, jck, jcv, jb, jnp.asarray(positions, jnp.int32), 1, interpret=True)
    got = tda.decode_attention_update_layer(tq, tkn, tvn, tck, tcv, tb,
                                            torch.tensor(positions), 1)
    np.testing.assert_array_equal(_bits(tck), _jbits(jck2, "e4m3"))
    np.testing.assert_array_equal(_bits(tcv), _jbits(jcv2, "e4m3"))
    assert _bits(tck)[1, 0, 0, 5, :6].tolist() == OVERFLOW_BITS
    want = jda.decode_attention_layer(jq, jck2, jcv2, jb, 1, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(got[2].float().numpy()[:, :6],
                               np.broadcast_to([-x for x in OVERFLOW_READ], (2, 6)))

    # lockstep write of row 9 of layer 2, then K1's attention over it
    ci = 9
    tck[2, :, :, ci] = tda.to_cache(tkn, tck.dtype)
    tcv[2, :, :, ci] = tda.to_cache(tvn, tcv.dtype)
    jck3 = jck2.at[2, :, :, ci].set(jkn.astype(jck2.dtype))
    jcv3 = jcv2.at[2, :, :, ci].set(jvn.astype(jcv2.dtype))
    np.testing.assert_array_equal(_bits(tck), _jbits(jck3, "e4m3"))
    np.testing.assert_array_equal(_bits(tcv), _jbits(jcv3, "e4m3"))
    assert tda.from_e4m3(tck[2, 0, 0, ci, :6]).float().tolist() == OVERFLOW_READ
    assert tda.from_e4m3(tcv[2, 0, 0, ci, :6]).float().tolist() == [-x for x in OVERFLOW_READ]
    tb = tb.clone()
    tb[:, : ci + 1] = 0.0
    jb = jnp.asarray(tb.numpy())
    for layer in (1, 2):
        want = np.asarray(jda.decode_attention_layer(jq, jck3, jcv3, jb, layer,
                                                     interpret=True), np.float32)
        got = tda.decode_attention_layer(tq, tck, tcv, tb, layer)
        assert np.isfinite(got.float().numpy()).all()
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def test_torch_update_layer_rejects_what_the_kernel_does_not_take():
    _, (tq, tkn, tvn, tck, tcv, tb) = _update_inputs("bf16", "bf16", [1, 2, 3, 4])
    pos = torch.tensor([1, 2, 3, 4])
    with pytest.raises(ValueError, match="k_new"):
        tda.decode_attention_update_layer(tq, tkn[:, :1], tvn, tck, tcv, tb, pos, 0)
    with pytest.raises(ValueError, match="q's dtype"):
        tda.decode_attention_update_layer(tq, tkn.float(), tvn, tck, tcv, tb, pos, 0)
    with pytest.raises(ValueError, match="pos"):
        tda.decode_attention_update_layer(tq, tkn, tvn, tck, tcv, tb, pos.float(), 0)
    with pytest.raises(ValueError, match="cache dtype"):
        tda.decode_attention_update_layer(tq, tkn, tvn, tck.float(), tcv.float(), tb, pos, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("t,n_layers", [(384, 30), (128, 4), (1024, 4)])
@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
def test_torch_cuda_update_kernel_matches_plain(cache, t, n_layers):
    """On a card: the kernel's caches bit-equal to the plain version's, ``out``
    within K1's tolerance of it, on strided q / k / v views of one fused
    projection, with rows at 0, T - 1, past the cache and on both edges of
    one of the split's key ranges (its last key, the next range's first)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _, (tq, tk, tv, tb) = _inputs(cache, "bf16", L=n_layers, b=16, h=4, t=t, hd=256)
    tk, tv, tb = tk.cuda(), tv.cuda(), tb.cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(16, 1, 3 * 4 * 256, generator=g, device="cuda").to(torch.bfloat16)
    q, kn, vn = (x.reshape(16, 4, 256) for x in qkv.chunk(3, dim=-1))
    per = tda.split_len(16 * 4, t, tda.SPLIT_BLOCKS_PER_SM * tda._sm_count(tk.device))
    edge = per * max(1, -(-t // per) // 2)
    pos = torch.randint(0, t, (16,), generator=g, device="cuda")
    pos[0], pos[1], pos[2], pos[3], pos[4] = 0, t - 1, t, edge - 1, min(edge, t - 1)
    tol = CACHE[cache][2]
    before = tda.decode_attention_update_layer.launches
    for layer in (0, n_layers - 1):
        ck, cv = tk.clone(), tv.clone()
        got = tda.decode_attention_update_layer(q, kn, vn, tk, tv, tb, pos, layer)
        want = tda.decode_attention_update_layer_plain(q, kn, vn, ck, cv, tb, pos, layer)
        torch.cuda.synchronize()
        assert torch.equal(tk.view(torch.uint8), ck.view(torch.uint8))
        assert torch.equal(tv.view(torch.uint8), cv.view(torch.uint8))
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   atol=tol, rtol=tol)
    assert tda.decode_attention_update_layer.launches == before + 2
