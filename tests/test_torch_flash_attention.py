"""Flash-attention forward parity: the port's plain version (what its wrapper
runs on CPU tensors) against the JAX Pallas kernel ``_pallas_attention`` in
interpret mode, on O and LSE; and the CUDA kernel against the plain version
on a card.

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


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_torch_cuda_flash_kernel_matches_plain(dt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _, cpu_in = _inputs(dt, b=1, h=4, t=308, hd=256, tail=50)
    tq, tk, tv, tvalid = (x.cuda() for x in cpu_in)
    before = tfa.flash_attention.launches
    got_o, got_lse = tfa.flash_attention_fwd(tq, tk, tv, tvalid)
    want_o, want_lse = tfa.flash_attention_plain(tq, tk, tv, tvalid)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    np.testing.assert_allclose(got_o.float().cpu().numpy(), want_o.float().cpu().numpy(),
                               atol=DT[dt][2], rtol=0)
    np.testing.assert_allclose(got_lse.cpu().numpy(), want_lse.cpu().numpy(),
                               atol=2e-5, rtol=0)
