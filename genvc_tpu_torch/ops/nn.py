"""Core NN primitives: plain functions on tensors plus thin ``nn.Module``s
holding parameters in the JAX package's layout (``genvc_tpu/ops/nn.py``).

Conventions kept from the JAX side so converted trees load without change:
* linear weights are stored (in_features, out_features) — ``x @ w + b`` —
  at the port's public boundary too (``Linear.w``), not torch's (out, in);
* a linear computes in the INPUT's dtype (weights cast to ``x.dtype``), like
  ``jnp.dot(x, w.astype(x.dtype))``: bf16 weights applied to f32 activations
  run in f32;
* LayerNorm computes in f32 and returns the input dtype; eps = 1e-5. On the
  card it is one launch of ``csrc/layer_norm.cu`` (:func:`layer_norm`), and
  so is RMSNorm (:func:`rms_norm`, the kernel's RMS mode).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch import nn

from genvc_tpu_torch import tracing

NEG_INF = -1e9  # additive mask value; finite to keep softmax NaN-free


def _empty(*shape):
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


def linear(x, w, b=None):
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def layer_norm_plain(x, scale, bias, eps: float = 1e-5):
    """LayerNorm in PyTorch ops: statistics and affine in f32, x's dtype out."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def layer_norm_backward(gy, x, scale, mean, rstd, needs=(True, True, True)):
    """Gradients of :func:`layer_norm_plain` in PyTorch ops, from the
    forward's per-row f32 ``mean`` and ``rstd`` (``x.shape[:-1] + (1,)``):
    (dx in x's dtype, dscale and dbias in scale's dtype and shape), None
    where ``needs`` says no."""
    g = gy.float()
    n = (x.float() - mean) * rstd
    d = x.shape[-1]
    gx = gscale = gbias = None
    if needs[0]:
        gn = g * scale.float()
        gx = rstd * (gn - gn.mean(dim=-1, keepdim=True)
                     - n * (gn * n).mean(dim=-1, keepdim=True))
        gx = gx.to(x.dtype)
    if needs[1]:
        gscale = (g * n).reshape(-1, d).sum(0).to(scale.dtype).view(scale.shape)
    if needs[2]:
        gbias = g.reshape(-1, d).sum(0).to(scale.dtype).view(scale.shape)
    return gx, gscale, gbias


# the kernel's 16-byte vector of x, in elements; it holds at most 8 vectors a
# lane of its warp, so widths up to 8 * 32 vectors (csrc/layer_norm.cu)
_LN_VEC = {torch.bfloat16: 8, torch.float32: 4}


def layer_norm_kernel_takes(x, scale, bias) -> bool:
    """Whether ``csrc/layer_norm.cu`` takes this call, x contiguous: x bf16
    or f32, its width ``d`` a multiple of the kernel's vector up to 256
    vectors and its pointer 16-byte aligned; scale and bias of one type, bf16
    or f32, ``d`` contiguous elements each, on x's device (at any element:
    the kernel reads them one element at a time where they are not
    16-byte aligned, as views of one weight buffer can be)."""
    vec = _LN_VEC.get(x.dtype)
    d = x.shape[-1]
    dev = x.get_device()
    return (vec is not None and scale.dtype in _LN_VEC and bias.dtype == scale.dtype
            and d % vec == 0 and 0 < d <= 256 * vec
            and scale.numel() == d and bias.numel() == d
            and scale.is_contiguous() and bias.is_contiguous()
            and scale.get_device() == dev and bias.get_device() == dev
            and not x.data_ptr() & 15)


@functools.cache
def _layer_norm_fn():
    from genvc_tpu_torch import _build

    fn = _build.load("layer_norm").genvc_layer_norm
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _layer_norm_launch(x, scale, bias, eps, stats=False):
    """One launch of the kernel on a call it takes: y, and with ``stats`` the
    per-row f32 mean and rstd (``x.shape[:-1] + (1,)``), else None."""
    y = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    err = _layer_norm_fn()(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        mean.data_ptr() if stats else None, rstd.data_ptr() if stats else None,
        x.numel() // x.shape[-1], x.shape[-1], int(x.dtype == torch.bfloat16),
        int(scale.dtype == torch.bfloat16), eps,
        # the current stream's handle; torch.cuda.current_stream() builds a
        # Stream object, 40 times the host time on an H100 host
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: CUDA error {err}")
    layer_norm.launches += 1
    tracing.count("ops.layer_norm.kernel")
    return y, mean, rstd


class _LayerNormKernel(torch.autograd.Function):
    """The kernel's forward under autograd; the backward in PyTorch ops from
    the mean and rstd the forward wrote (:func:`layer_norm_backward`)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, rstd = _layer_norm_launch(x, scale, bias, eps, stats=True)
        ctx.save_for_backward(x, scale, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, scale, mean, rstd = ctx.saved_tensors
        return (*layer_norm_backward(gy, x, scale, mean, rstd, ctx.needs_input_grad[:3]),
                None)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last dimension: f32 statistics, x's dtype out
    (:func:`layer_norm_plain`'s arithmetic). CPU tensors take the plain ops;
    on the card it is one launch of ``csrc/layer_norm.cu`` (built at its
    first use) on x made contiguous, under autograd with the backward of
    :func:`layer_norm_backward`. A CUDA call the kernel does not take
    (:func:`layer_norm_kernel_takes`) raises. Each launch adds one to
    ``layer_norm.launches`` and, while the recorder is on, to the counter
    ``ops.layer_norm.kernel``."""
    if not x.is_cuda:
        if x.is_cpu:
            return layer_norm_plain(x, scale, bias, eps)
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    if not layer_norm_kernel_takes(x, scale, bias):
        raise ValueError(
            f"layer_norm kernel: x {x.dtype} {tuple(x.shape)} at byte "
            f"{x.data_ptr() % 16} of 16, scale {scale.dtype} {tuple(scale.shape)} on "
            f"{scale.device}, bias {bias.dtype} {tuple(bias.shape)} on {bias.device}: it "
            "takes x bf16 (f32) of a width that is a multiple of 8 (4) up to 2048 "
            "(1024), 16-byte aligned, and scale and bias of that width, one type "
            "(bf16 or f32), contiguous, on x's device")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _LayerNormKernel.apply(x, scale, bias, eps)
    return _layer_norm_launch(x, scale, bias, eps)[0]


layer_norm.launches = 0


def rms_norm_plain(x, scale, eps: float = 1e-5):
    """RMSNorm in PyTorch ops: x * rsqrt(mean(x^2) + eps) * scale, in f32,
    x's dtype out."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
            * scale.float()).to(x.dtype)


def _rows_view(x):
    """x as (rows, d) rows one stride apart, without a copy, or None."""
    try:
        rows = x.view(-1, x.shape[-1])
    except RuntimeError:
        return None
    return rows if rows.stride(-1) == 1 else None


@functools.cache
def _rms_norm_fn():
    from genvc_tpu_torch import _build

    fn = _build.load("layer_norm").genvc_rms_norm
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def rms_norm(x, scale, eps: float = 1e-5):
    """RMSNorm over the last dimension (:func:`rms_norm_plain`'s arithmetic).
    CPU tensors take the plain ops; on the card it is one launch of the RMS
    mode of ``csrc/layer_norm.cu``, which reads rows of x that lie a fixed
    stride apart (a column slice of a wider tensor, no copy) and writes a
    contiguous result. The kernel takes what :func:`layer_norm_kernel_takes`
    says of x's width, types and alignment (scale standing for both
    parameters); anything else raises. No autograd. Each launch adds one to
    ``rms_norm.launches`` and, with the recorder on, to the counter
    ``ops.rms_norm.kernel``."""
    if not x.is_cuda:
        if x.is_cpu:
            return rms_norm_plain(x, scale, eps)
        raise ValueError(f"unsupported device {x.device}")
    d = x.shape[-1]
    rows = _rows_view(x)
    if rows is None:
        rows = x.contiguous().view(-1, d)
    ld = rows.stride(0) if rows.shape[0] > 1 else d
    vec = _LN_VEC.get(x.dtype)
    if vec is None or ld % vec or not layer_norm_kernel_takes(rows, scale, scale):
        raise ValueError(
            f"rms_norm kernel: x {x.dtype} {tuple(x.shape)} strides {x.stride()} at byte "
            f"{x.data_ptr() % 16} of 16, scale {scale.dtype} {tuple(scale.shape)} on "
            f"{scale.device}: it takes x bf16 (f32) of a width that is a multiple of 8 (4) "
            "up to 2048 (1024), rows a multiple of that apart, 16-byte aligned, and a "
            "contiguous bf16 or f32 scale of that width on x's device")
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    err = _rms_norm_fn()(
        rows.data_ptr(), scale.data_ptr(), y.data_ptr(), rows.shape[0], d, ld,
        int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16), eps,
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error {err}")
    rms_norm.launches += 1
    tracing.count("ops.rms_norm.kernel")
    return y


rms_norm.launches = 0


def rms_norm_l2(x, gamma):
    """torch ``F.normalize(x, dim=-1) * sqrt(d) * gamma`` (reference perceiver
    RMSNorm)."""
    xf = x.float()
    norm = xf.square().sum(dim=-1, keepdim=True).sqrt()
    out = xf / norm.clamp_min(1e-12) * math.sqrt(x.shape[-1])
    return (out * gamma.float()).to(x.dtype)


def gelu_new(x):
    """GPT-2 'gelu_new' (tanh approximation)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def gelu_exact(x):
    return torch.nn.functional.gelu(x)


def split_heads(x, n_heads: int):
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads).transpose(1, 2)


def merge_heads(x):
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def attention(q, k, v, bias=None):
    """(B, H, Tq, hd) x (B, H, Tk, hd) softmax attention: logits accumulate in
    f32, softmax in f32, probabilities cast to q's dtype for P.V."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v.to(q.dtype))


def causal_bias(t: int, device=None):
    i = torch.arange(t, device=device)
    allowed = i[None, :] <= i[:, None]
    return torch.where(allowed, 0.0, NEG_INF).float()[None, None]


def key_padding_bias(key_valid):
    """(B, Tk) bool -> (B, 1, 1, Tk) additive f32 bias."""
    return torch.where(key_valid, 0.0, NEG_INF).float()[:, None, None, :]


class Linear(nn.Module):
    """Parameters ``w`` (in, out) and optional ``b`` (out,)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.w = _empty(d_in, d_out)
        self.b = _empty(d_out) if bias else None

    def forward(self, x):
        return linear(x, self.w, self.b)


class LayerNorm(nn.Module):
    """Parameters ``scale`` and ``bias`` (d,)."""

    def __init__(self, d: int):
        super().__init__()
        self.scale = _empty(d)
        self.bias = _empty(d)

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias)


class RMSNorm(nn.Module):
    """Parameter ``scale`` (d,); eps 1e-5 unless given."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.scale = _empty(d)
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.scale, self.eps)


# ---------------------------------------------------------------------------
# Random initialisers with the JAX package's distributions (genvc_tpu/ops/nn.py
# init_*), for seeded random-weight runs. Each returns a tree of tensors.


def init_linear(gen, d_in, d_out, std: float | None = None, bias: bool = True):
    dev = gen.device
    if std is None:  # torch nn.Linear default: U(-1/sqrt(in), 1/sqrt(in))
        lim = 1.0 / math.sqrt(d_in)
        w = (torch.rand(d_in, d_out, generator=gen, device=dev) * 2 - 1) * lim
        b = (torch.rand(d_out, generator=gen, device=dev) * 2 - 1) * lim
    else:
        w = torch.randn(d_in, d_out, generator=gen, device=dev) * std
        b = torch.zeros(d_out, device=dev)
    p = {"w": w}
    if bias:
        p["b"] = b
    return p


def init_layer_norm(gen, d):
    return {"scale": torch.ones(d, device=gen.device),
            "bias": torch.zeros(d, device=gen.device)}


def init_embedding(gen, n, d, std=0.02):
    return torch.randn(n, d, generator=gen, device=gen.device) * std
