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


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
def test_torch_cuda_kernel_matches_plain(cache):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _, (tq, tk, tv, tb) = _inputs(cache, "bf16", L=30, b=16, h=4, t=384, hd=256)
    tq, tk, tv, tb = (x.cuda() for x in (tq, tk, tv, tb))
    tol = CACHE[cache][2]
    before = tda.decode_attention_layer.launches
    for layer in (0, 29):
        got = tda.decode_attention_layer(tq, tk, tv, tb, layer).float().cpu()
        want = tda.decode_attention_layer_plain(tq, tk, tv, tb, layer).float().cpu()
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol, rtol=tol)
    assert tda.decode_attention_layer.launches == before + 2


# ---- K3: the per-row cache write + attention (decode_attention_update_layer)

UPDATE_TOL = {"bf16": 4e-3, "e4m3": 2e-2}


def _update_inputs(cache, qd, positions, seed=0):
    """JAX test_decode_attention.py:84's case (L=3, B=4, H=2, T=64, hd=128):
    the same values on both sides, q / k_new / v_new exact in ``qd``."""
    rng = np.random.default_rng(seed)
    jc, tc, _ = CACHE[cache]
    jq, tq = QD[qd]
    L, B, H, T, hd = 3, 4, 2, 64, 128

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
@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
def test_torch_cuda_update_kernel_matches_plain(cache):
    """On a card: the kernel's caches bit-equal to the plain version's, ``out``
    within K1's tolerance of it, on strided q / k / v views of one fused
    projection, with rows at 0, T - 1 and past the cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _, (tq, tk, tv, tb) = _inputs(cache, "bf16", L=30, b=16, h=4, t=384, hd=256)
    tk, tv, tb = tk.cuda(), tv.cuda(), tb.cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(16, 1, 3 * 4 * 256, generator=g, device="cuda").to(torch.bfloat16)
    q, kn, vn = (x.reshape(16, 4, 256) for x in qkv.chunk(3, dim=-1))
    pos = torch.randint(0, 384, (16,), generator=g, device="cuda")
    pos[0], pos[1], pos[2] = 0, 383, 384
    tol = CACHE[cache][2]
    before = tda.decode_attention_update_layer.launches
    for layer in (0, 29):
        ck, cv = tk.clone(), tv.clone()
        got = tda.decode_attention_update_layer(q, kn, vn, tk, tv, tb, pos, layer)
        want = tda.decode_attention_update_layer_plain(q, kn, vn, ck, cv, tb, pos, layer)
        torch.cuda.synchronize()
        assert torch.equal(tk.view(torch.uint8), ck.view(torch.uint8))
        assert torch.equal(tv.view(torch.uint8), cv.view(torch.uint8))
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   atol=tol, rtol=tol)
    assert tda.decode_attention_update_layer.launches == before + 2
