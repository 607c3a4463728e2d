"""Causal, key-masked attention over whole sequences: forward (O and LSE)
and backward (dq, dk, dv), differentiable through :class:`FlashAttention`.

Replaces the Pallas kernels of ``genvc_tpu/ops/flash_attention.py``:
``_pallas_attention`` (body ``_attn_fwd_kernel``, K4) and ``_pallas_backward``
(bodies ``_attn_dq_kernel``, K5, and ``_attn_dkdv_kernel``, K6). The kernels
are ``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu``
(dq; dk and dv), hand-written for ``sm_90a``, each built with ``nvcc`` into a
C-ABI library at first use and called through ``ctypes``.

Shapes (JAX's layout):
  q, k, v    (B, H, T, hd)  bf16 or f32, one dtype; hd a multiple of 8 <= 256
  kv_valid   (B, T)         bool key mask
  -> O       (B, H, T, hd)  q's dtype
  -> LSE     (B, H, T)      f32

Forward numerics (those of the Pallas body, not of the dense
``ops.nn.attention``): q, k, v widened to f32; s = (q.k^T) * scale; s SET to
-1e9 where the key is invalid or, under ``causal``, col > row; m = rowmax,
p = exp(s - m), l = sum p over the Pallas kernel's key width (T padded to a
multiple of 128 with invalid keys); O = (p.v) / l in f32 with no rounding of
p, cast to q's dtype; LSE = m + log(l). One deliberate difference on the
card: the bf16 kernel runs both products on the tensor cores and rounds p to
bf16 before P.V (l and LSE still from the f32 p), an error under the bf16
output's own rounding; the f32 kernel and the plain version do not round p.

Backward numerics (the Pallas dq and dk/dv bodies): the same masked s,
p = exp(s - LSE) from the saved LSE, dp = dO.v^T, ds = p * (dp - D) with
D = rowsum(dO * O) computed here in plain torch from the saved O, as the JAX
package computes it in XLA; dq = (ds.k) * scale, dk = (ds^T.q) * scale,
dv = p^T.dO, all in f32, cast to q's dtype. One deliberate difference on the
card: the bf16 kernels run every product on the tensor cores, so p and ds
are rounded to bf16 before the second products (p^T.dO, ds.k, ds^T.q);
every sum stays f32, and D and the LSE are unchanged. Where a row sees no
valid key (p = 1 on every key, ds unnormalised), ds goes in as two bf16
parts, bf16(ds) + bf16(ds - bf16(ds)), for the K5 group (16 rows) or K6
query tile (64 rows) holding it. The f32 kernels and the plain version
round nothing.

Bound on the card: bytes, for the forward at the latent pass's shape and for
the backward at the training step's; see the sources for the tiling.

The wrappers run the kernels for CUDA tensors and the plain PyTorch versions
(:func:`flash_attention_plain`, :func:`flash_attention_bwd_plain`) only for
CPU tensors; anything a kernel does not take raises. Each launch adds one to
its wrapper's count: ``flash_attention.launches`` (K4),
``flash_attention_dq.launches`` (K5), ``flash_attention_dkdv.launches`` (K6).
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


def flash_attention_bwd_plain(q, k, v, kv_valid, out, lse, g, scale=None,
                              causal=True):
    """Plain PyTorch version of the backward, a transcription of the Pallas
    ``_attn_dq_kernel`` and ``_attn_dkdv_kernel``. ``out`` and ``lse`` are the
    forward's; ``g`` is dO. Keys are not padded: a padded key is a zero row
    (no term in dq, its dk / dv dropped) and a padded query row has dO = 0,
    so the padding only shows through the LSE. Returns (dq, dk, dv) in q's
    dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    t = q.shape[2]
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    dd = (gf * out.float()).sum(dim=-1, keepdim=True)
    ok = kv_valid[:, None, None, :]
    if causal:
        col = torch.arange(t, device=q.device)
        ok = ok & (col[None, :] <= col[:, None])
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse[..., None])
    dv = torch.matmul(p.transpose(-1, -2), gf)
    ds = p * (torch.matmul(gf, vf.transpose(-1, -2)) - dd)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _row_strides(x):
    """``x`` itself when its head dim is contiguous and its rows 16-byte
    aligned, else a contiguous copy (a gradient may arrive expanded)."""
    try:
        _strides(x)
        if x.data_ptr() % 16 == 0:
            return x
    except ValueError:
        pass
    return x.contiguous()


def _bwd_args(q, k, v, kv_valid, out, lse, g):
    """Checks and the kernels' shared arguments: (lse, D, dO, valid, strides
    of q/k/v, strides of dO)."""
    if out.shape != q.shape or g.shape != q.shape or out.dtype != q.dtype \
            or g.dtype != q.dtype:
        raise ValueError(f"out {out.dtype} {tuple(out.shape)}, dO {g.dtype} "
                         f"{tuple(g.shape)}: must match q {q.dtype} {tuple(q.shape)}")
    if lse.dtype != torch.float32 or lse.shape != q.shape[:3]:
        raise ValueError(f"lse {lse.dtype} {tuple(lse.shape)}: must be f32 "
                         f"{tuple(q.shape[:3])}")
    sb, sh, st = _strides(q)
    if k.stride() != q.stride() or v.stride() != q.stride():
        raise ValueError("q, k and v must share one set of strides")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    b, h = q.shape[:2]
    if b * h > 65535:
        raise ValueError(f"B * H = {b * h}: the kernels' grid takes at most 65535")
    g = _row_strides(g)
    dd = (g.float() * out.float()).sum(dim=-1).contiguous()
    return (lse.contiguous(), dd, g, kv_valid.contiguous(), (sb, sh, st),
            _strides(g))


def _grad_buffer(q):
    """(B, H, T, hd) view of a (B, T, H, hd) buffer: the head merge of the
    qkv projection's gradient is then free."""
    b, h, t, hd = q.shape
    return torch.empty(b, t, h, hd, dtype=q.dtype, device=q.device).transpose(1, 2)


def flash_attention_dq(q, k, v, kv_valid, lse, dd, g, scale, causal, qkv_st, g_st):
    """K5: dq. Arguments as :func:`_bwd_args` prepares them."""
    b, h, t, hd = q.shape
    dq = _grad_buffer(q)
    err = _lib_bwd().genvc_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(), g.data_ptr(),
        lse.data_ptr(), dd.data_ptr(), dq.data_ptr(), b, h, t, hd, float(scale),
        int(causal), int(q.dtype == torch.bfloat16), *qkv_st, *g_st,
        *dq.stride()[:3], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention dq kernel launch failed: CUDA error {err}")
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkdv(q, k, v, kv_valid, lse, dd, g, scale, causal, qkv_st, g_st):
    """K6: dk and dv. Arguments as :func:`_bwd_args` prepares them."""
    b, h, t, hd = q.shape
    dk, dv = _grad_buffer(q), _grad_buffer(q)
    err = _lib_bwd().genvc_flash_attention_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(), g.data_ptr(),
        lse.data_ptr(), dd.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, t, hd,
        float(scale), int(causal), int(q.dtype == torch.bfloat16), *qkv_st, *g_st,
        *dk.stride()[:3], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention dk/dv kernel launch failed: CUDA error {err}")
    flash_attention_dkdv.launches += 1
    return dk, dv


flash_attention_dq.launches = 0
flash_attention_dkdv.launches = 0


def flash_attention_bwd(q, k, v, kv_valid, out, lse, g, scale=None, causal=True):
    """Attention backward from the forward's O and LSE and dO (``g``);
    returns (dq, dk, dv) in q's dtype. CPU tensors take
    :func:`flash_attention_bwd_plain`; CUDA tensors launch K5 and K6 (no
    fallback); on the card dq, dk and dv come back as (B, H, T, hd) views of
    (B, T, H, hd) buffers."""
    _check(q, k, v, kv_valid)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, kv_valid, out, lse, g, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    lse, dd, g, valid, qkv_st, g_st = _bwd_args(q, k, v, kv_valid, out, lse, g)
    args = (q, k, v, valid, lse, dd, g, scale, causal, qkv_st, g_st)
    dq = flash_attention_dq(*args)
    dk, dv = flash_attention_dkdv(*args)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The JAX package's ``flash_attention`` custom VJP: forward K4 (O and LSE
    saved), backward K5 + K6."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, scale, causal):
        out, lse = flash_attention_fwd(q, k, v, kv_valid, scale, causal)
        ctx.save_for_backward(q, k, v, kv_valid, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_valid, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_valid, out, lse, g,
                                         ctx.scale, ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, kv_valid, scale=None, causal=True):
    """(B, H, T, hd) causal, key-masked attention; returns O, differentiable
    in q, k and v (the JAX package's ``flash_attention``)."""
    return FlashAttention.apply(q, k, v, kv_valid, scale, causal)


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


def _lib_bwd():
    from genvc_tpu_torch import _build

    lib = _build.load("flash_attention_bwd")
    for name, n_out in (("genvc_flash_attention_bwd_dq", 1),
                        ("genvc_flash_attention_bwd_dkdv", 2)):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * (7 + n_out) + [ctypes.c_int] * 4
                           + [ctypes.c_float] + [ctypes.c_int] * 2
                           + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    sm = lib.genvc_flash_attention_bwd_smem_bytes
    if sm.argtypes is None:
        sm.argtypes = [ctypes.c_int] * 6
        sm.restype = ctypes.c_size_t
    return lib


def bwd_smem_bytes(b, h, t, hd, dkdv, bf16=True):
    """Dynamic shared memory of one block of K5 (``dkdv`` False) or K6 at
    this shape, as the launch picks its tiles."""
    return int(_lib_bwd().genvc_flash_attention_bwd_smem_bytes(b, h, t, hd, int(dkdv),
                                                                int(bf16)))
