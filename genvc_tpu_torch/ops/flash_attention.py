"""Causal, key-masked attention forward (O and LSE) over whole sequences.

Replaces the Pallas kernel of ``genvc_tpu/ops/flash_attention.py``:
``_pallas_attention`` (body ``_attn_fwd_kernel``). The kernel is
``csrc/flash_attention.cu``, hand-written for ``sm_90a``, built with ``nvcc``
into a C-ABI library at first use and called through ``ctypes``. Its backward
(the Pallas dq and dk/dv kernels) is not ported yet: this module runs in
inference only.

Shapes (JAX's layout):
  q, k, v    (B, H, T, hd)  bf16 or f32, one dtype; hd a multiple of 8 <= 256
  kv_valid   (B, T)         bool key mask
  -> O       (B, H, T, hd)  q's dtype
  -> LSE     (B, H, T)      f32

Numerics (those of the Pallas body, not of the dense ``ops.nn.attention``):
q, k, v widened to f32; s = (q.k^T) * scale; s SET to -1e9 where the key is
invalid or, under ``causal``, col > row; m = rowmax, p = exp(s - m), l = sum p
over the Pallas kernel's key width (T padded to a multiple of 128 with invalid
keys); O = (p.v) / l in f32 with no rounding of p, cast to q's dtype;
LSE = m + log(l).

Bound on the card: bytes (q, k, v read and O written once: 2.5 MB at the
latent pass's B = 1, H = 4, T = 308, hd = 256, bf16); see the source for the
tiling.

``flash_attention_fwd`` runs the kernel for CUDA tensors and the plain PyTorch
version (:func:`flash_attention_plain`) only for CPU tensors; anything the
kernel does not take raises. Each kernel launch adds one to
``flash_attention.launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from genvc_tpu_torch.ops.nn import NEG_INF

MAX_HD = 256
PAD_TO = 128  # the Pallas kernel's query/key tile (its ``BQ``)


def flash_attention_plain(q, k, v, kv_valid, scale=None, causal=True):
    """Plain PyTorch version with the Pallas body's arithmetic: the keys are
    padded to a multiple of 128 with invalid ones, as that kernel pads them.
    Returns (O in q's dtype, LSE f32)."""
    t, hd = q.shape[2], q.shape[3]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    pad = -t % PAD_TO
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    ok = torch.nn.functional.pad(kv_valid, (0, pad), value=False)[:, None, None, :]
    if causal:
        col = torch.arange(t + pad, device=q.device)
        ok = ok & (col[None, :] <= torch.arange(t, device=q.device)[:, None])
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, vf) / denom
    return out.to(q.dtype), (m + torch.log(denom))[..., 0]


def _check(q, k, v, kv_valid):
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                         "takes q, k and v all bf16 or all f32")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: must be equal (B, H, T, hd)")
    b, _, t, hd = q.shape
    if kv_valid.dtype != torch.bool or tuple(kv_valid.shape) != (b, t):
        raise ValueError(f"kv_valid {kv_valid.dtype} {tuple(kv_valid.shape)}: "
                         f"must be bool ({b}, {t})")
    if hd % 8 or hd > MAX_HD or b == 0 or t == 0:
        raise ValueError(f"head dim {hd}: the kernel takes multiples of 8 up "
                         f"to {MAX_HD}, with B, T >= 1")
    devs = {x.device for x in (q, k, v, kv_valid)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _strides(x):
    """(B, H, T) element strides; those of dims longer than 1 must keep each
    row 16-byte aligned (multiples of 8 elements)."""
    st = x.stride()
    if st[3] != 1:
        raise ValueError("the head dim must be contiguous")
    if any(n > 1 and s % 8 for n, s in zip(x.shape[:3], st[:3])):
        raise ValueError(f"strides {st}: rows must start 16-byte aligned")
    return st[:3]


def flash_attention_fwd(q, k, v, kv_valid, scale=None, causal=True):
    """Attention forward; returns (O (B, H, T, hd) in q's dtype, LSE (B, H, T)
    f32). CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch
    the kernel (no fallback). On the card q, k and v may be strided views
    (those of a fused qkv projection) sharing one set of strides; O comes
    back as a (B, H, T, hd) view of a (B, T, H, hd) buffer, so merging the
    heads afterwards is free."""
    _check(q, k, v, kv_valid)
    b, h, t, hd = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_valid, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    sb, sh, st = _strides(q)
    if k.stride() != q.stride() or v.stride() != q.stride():
        raise ValueError("q, k and v must share one set of strides")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    if b * h > 65535:
        raise ValueError(f"B * H = {b * h}: the kernel's grid takes at most 65535")
    lib = _lib()
    out = torch.empty(b, t, h, hd, dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    valid = kv_valid.contiguous()
    ob, oh, ot = out.stride()[:3]
    err = lib.genvc_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, h, t, hd, float(scale), int(causal),
        int(q.dtype == torch.bfloat16), sb, sh, st, ob, oh, ot,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out, lse


def flash_attention(q, k, v, kv_valid, scale=None, causal=True):
    """(B, H, T, hd) causal, key-masked attention; returns O only (the JAX
    package's ``flash_attention``, forward)."""
    return flash_attention_fwd(q, k, v, kv_valid, scale, causal)[0]


flash_attention.launches = 0


def _lib():
    from genvc_tpu_torch import _build

    lib = _build.load("flash_attention")
    fn = lib.genvc_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float]
                       + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib
