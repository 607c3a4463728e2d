"""1-D / 2-D convolution helpers in torch weight layout (``genvc_tpu/ops/conv.py``).

Weights keep the torch layout — Conv1d (O, I, K), ConvTranspose1d (I, O, K),
Conv2d (O, I, Kh, Kw) — as the JAX package does. For inference weight norm is
folded when a checkpoint is converted (``checkpoint.fold_weight_norm``), so
those convs hold a plain ``w``. The training forms keep the reparametrization
the reference trains: torch ``weight_norm`` as (``g``, ``v``), the norm over
every axis but 0 (also for a transposed conv's (I, O, K) weight, as torch's
default ``dim=0``), and torch ``spectral_norm`` as the trainable ``w_orig``
with the power-iteration buffers ``u`` and ``pv``.
Convolutions run in full f32 on the card (cuDNN TF32 is switched off by
``genvc_tpu_torch.resolve_device``): dVAE codes and vocoder audio are
parity-sensitive.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def weight_norm(g, v):
    """torch ``weight_norm``'s effective weight ``g * v / ||v||`` (the norm
    over every axis but 0, clamped at 1e-12 as the JAX package's ``_wn``)."""
    norm = v.square().sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()
    return g * v / norm.clamp_min(1e-12)


def _l2n(x, eps=1e-12):
    return x / x.norm().clamp_min(eps)


def conv1d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    """x: (B, C, T), weight (O, I/groups, K) -> (B, O, T_out)."""
    return F.conv1d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                    stride=stride, padding=padding, dilation=dilation,
                    groups=groups)


def conv_transpose1d(x, w, b=None, stride=1, padding=0):
    """torch ConvTranspose1d semantics; weight (I, O, K)."""
    return F.conv_transpose1d(x, w.to(x.dtype),
                              None if b is None else b.to(x.dtype),
                              stride=stride, padding=padding)


def conv2d(x, w, b=None, stride=(1, 1), padding=(0, 0), dilation=(1, 1), groups=1):
    """x: (B, C, H, W), weight (O, I/groups, Kh, Kw)."""
    return F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                    stride=stride, padding=padding, dilation=dilation, groups=groups)


def leaky_relu(x, slope=0.1):
    return torch.where(x >= 0, x, x * slope)


def nearest_upsample1d(x, factor: int):
    """(B, C, T) -> (B, C, T*factor), torch F.interpolate mode='nearest'."""
    return torch.repeat_interleave(x, factor, dim=-1)


def linear_interp_x4(x, factor: int = 4, valid_len=None):
    """torch ``F.interpolate(mode='linear', align_corners=False)`` for integer
    upscale factors — the latent x4 upsampler. x: (B, C, T) -> (B, C, T*factor).

    ``valid_len`` (int) clamps the sampled indices to the true length so a
    zero-padded input reproduces the exact-length result at valid outputs."""
    t = x.shape[-1]
    out_t = t * factor
    pos = (np.arange(out_t) + 0.5) / factor - 0.5
    lo = np.floor(pos).astype(np.int64)
    frac = torch.as_tensor((pos - lo).astype(np.float32), device=x.device)
    hi_lim = (t if valid_len is None else int(valid_len)) - 1
    lo_c = torch.as_tensor(np.clip(lo, 0, hi_lim), device=x.device)
    hi_c = torch.as_tensor(np.clip(lo + 1, 0, hi_lim), device=x.device)
    xl = x[..., lo_c]
    xh = x[..., hi_c]
    return xl + (xh - xl) * frac.to(x.dtype)


class NormConv(nn.Module):
    """A conv's parameters in one of three forms (``norm``): ``None`` holds
    ``w``; ``"weight"`` holds ``g`` (O, 1, ...) and ``v``; ``"spectral"`` holds
    ``w_orig`` and the buffers ``u`` (O,) and ``pv`` (the other axes,
    flattened). ``b`` (O,) is optional in each."""

    def _make(self, shape, c_out, bias, norm):
        def param(*s):
            return nn.Parameter(torch.empty(*s), requires_grad=False)

        self.norm = norm
        if norm is None:
            self.w = param(*shape)
        elif norm == "weight":
            self.g = param(shape[0], *([1] * (len(shape) - 1)))
            self.v = param(*shape)
        elif norm == "spectral":
            self.w_orig = param(*shape)
            self.register_buffer("u", torch.empty(shape[0]))
            self.register_buffer("pv", torch.empty(math.prod(shape[1:])))
        else:
            raise ValueError(f"norm {norm!r}: None, 'weight' or 'spectral'")
        self.b = param(c_out) if bias else None

    def weight(self, sn_update: bool = False):
        """The effective weight. Under spectral norm, ``sn_update`` first runs
        one power iteration (torch's train-mode forward: v = normalize(W^T u),
        u = normalize(W v)) and stores the new ``u`` / ``pv``; sigma =
        u . (W v) with u and v constants, so the gradient reaches ``w_orig``
        through W and sigma alone."""
        if self.norm is None:
            return self.w
        if self.norm == "weight":
            return weight_norm(self.g, self.v)
        w = self.w_orig
        m = w.reshape(w.shape[0], -1)
        if sn_update:
            with torch.no_grad():
                # new tensors, not in-place writes: a sigma of an earlier
                # sub-forward keeps the vectors its backward saved
                self.pv = _l2n(m.T @ self.u)
                self.u = _l2n(m @ self.pv)
        return w / torch.dot(self.u, m @ self.pv)

    @torch.no_grad()
    def reset_parameters(self, gen):
        """The JAX package's init of an unnormed conv (``init_conv1d`` /
        ``init_conv2d``: w and b uniform in +-1/sqrt(fan_in)), then split into
        this conv's form like ``to_weight_norm`` / ``to_spectral_norm``."""
        shape = (self.w if self.norm is None else
                 self.v if self.norm == "weight" else self.w_orig).shape
        dev = gen.device
        lim = 1.0 / math.sqrt(math.prod(shape[1:]))
        w = (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * lim
        p = {"w": w}
        if self.b is not None:
            p["b"] = (torch.rand(shape[0], generator=gen, device=dev) * 2 - 1) * lim
        if self.norm == "weight":
            p = to_weight_norm(p)
        elif self.norm == "spectral":
            p = to_spectral_norm(p, gen)
        for k, val in p.items():
            if k in ("u", "pv"):
                setattr(self, k, val)
            else:
                setattr(self, k, nn.Parameter(val, requires_grad=False))


class Conv1d(NormConv):
    """Parameters ``w`` (O, I/groups, K) (or their normed form, see
    :class:`NormConv`) and optional ``b`` (O,)."""

    def __init__(self, c_in, c_out, kernel, bias=True, groups=1, transpose=False,
                 norm=None):
        super().__init__()
        shape = (c_in, c_out, kernel) if transpose else (c_out, c_in // groups, kernel)
        self._make(shape, c_out, bias, norm)
        self.groups = groups
        self.transpose = transpose

    def forward(self, x, stride=1, padding=0, dilation=1, sn_update=False):
        w = self.weight(sn_update)
        if self.transpose:
            return conv_transpose1d(x, w, self.b, stride, padding)
        return conv1d(x, w, self.b, stride, padding, dilation, self.groups)


class Conv2d(NormConv):
    """Parameters ``w`` (O, I, Kh, Kw) (or their normed form) and ``b`` (O,)."""

    def __init__(self, c_in, c_out, kh, kw, bias=True, norm=None):
        super().__init__()
        self._make((c_out, c_in, kh, kw), c_out, bias, norm)

    def forward(self, x, stride=(1, 1), padding=(0, 0), dilation=(1, 1), sn_update=False):
        return conv2d(x, self.weight(sn_update), self.b, stride, padding, dilation)


def init_conv1d(gen, out_ch, in_ch, kernel, std: float | None = None,
                bias: bool = True):
    """Random conv params with the JAX package's distributions."""
    dev = gen.device
    shape = (out_ch, in_ch, kernel)
    fan_in = in_ch * kernel
    lim = 1.0 / math.sqrt(fan_in)
    if std is None:
        w = (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * lim
    else:
        w = torch.randn(*shape, generator=gen, device=dev) * std
    p = {"w": w}
    if bias:
        p["b"] = (torch.rand(out_ch, generator=gen, device=dev) * 2 - 1) * lim
    return p


@torch.no_grad()
def reset_convs(module: nn.Module, gen) -> nn.Module:
    """Draw every :class:`NormConv` of ``module`` from ``gen`` with the JAX
    package's distributions (the draws themselves differ from JAX's)."""
    for m in module.modules():
        if isinstance(m, NormConv):
            m.reset_parameters(gen)
    return module


def to_weight_norm(p):
    """Split a folded conv weight into torch ``weight_norm``'s (g, v)."""
    w = p["w"]
    g = w.square().sum(dim=tuple(range(1, w.ndim)), keepdim=True).sqrt()
    out = {"g": g, "v": w}
    if "b" in p:
        out["b"] = p["b"]
    return out


def to_spectral_norm(p, gen):
    """Split a folded conv weight into torch ``spectral_norm``'s trainable
    ``w_orig`` and its buffers ``u`` (dim-0 size) and ``pv`` (the other dims
    flattened), drawn as normalized gaussians like torch's."""
    w = p["w"]
    out = {"w_orig": w,
           "u": _l2n(torch.randn(w.shape[0], generator=gen, device=gen.device)),
           "pv": _l2n(torch.randn(math.prod(w.shape[1:]), generator=gen,
                                  device=gen.device))}
    if "b" in p:
        out["b"] = p["b"]
    return out
