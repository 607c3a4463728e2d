"""int8 W8A8 linears of the GPT's decode path (``genvc_tpu/ops/quant.py``).

Weights: symmetric per-output-channel int8, ``scale[o] = max(max|w[:, o]| /
127, 1e-12)``, ``w_q = clip(round(w / scale), -127, 127)``, quantized once
from the f32 weights. Activations: one symmetric scale per row of the
product, ``sx = max(max|x|, 1e-12) / 127``, ``x_q = round(x / sx)`` in int8,
computed at every call. The product accumulates in int32 and is rescaled in
f32 as ``(acc * sx) * scale``, then the f32 bias is added and the result
cast to x's dtype. Every step keeps the JAX package's order of operations
(``torch.round`` rounds half to even, as ``jnp.round`` does), so on the same
inputs the int32 accumulators are equal and the outputs agree to f32
rounding.

:func:`quantize_gpt` swaps :class:`QLinear` in for the GPT's block
projections (``c_attn``, ``c_proj``, ``c_fc``, ``c_proj``) and its
``mel_head`` / ``text_head``, as ``quantize_gpt_params`` does; the Perceiver,
the embeddings, the positional tables and every LayerNorm are not quantized
(the core's LayerNorms are set to the f32 tree's values, as the JAX
package's ``build_pipeline`` keeps them).
Every path that reads the GPT through its modules (prefill, the lockstep and
per-row decode steps, the searches, the latent pass) then runs the int8
products.

The product: :func:`int8_matmul`. On CUDA tensors it is ``torch._int_mm``
(cuBLASLt's int8 GEMM on the tensor cores; the JAX package computes it as an
XLA ``dot_general``, not a Pallas kernel); on CPU tensors the plain version,
an exact int32 product. A shape ``_int_mm`` refuses raises: there is no
fallback to a float product.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

# torch._int_mm's shape rules on CUDA: more than 16 rows (decode runs 1-16:
# one stream, the beams, the server's slots; such a product runs on rows
# padded with zeros to 17), and the inner and output widths multiples of 8
INT_MM_MIN_ROWS = 17
INT_MM_ALIGN = 8


def _div127(t):
    """``t / 127`` as a true division on every device: CUDA multiplies by the
    reciprocal of a CPU scalar divisor, one ulp away from JAX's quotient, so
    the divisor is a tensor on t's device."""
    return t / torch.full((), 127.0, device=t.device)


def quantize_linear(w, b=None):
    """``(..., in, out)`` f32 weights -> ``(w_q int8 (..., in, out), scale f32
    (..., out))``, symmetric per output channel; leading axes (a stacked
    layer axis) are kept. ``b`` is returned in f32 (or None)."""
    w = torch.as_tensor(w).float()
    s = _div127(w.abs().amax(dim=-2, keepdim=True)).clamp_min(1e-12)
    w_q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return w_q, s.squeeze(-2), (None if b is None else torch.as_tensor(b).float())


def int8_matmul_plain(x_q, w_q):
    """(m, k) int8 x (k, n) int8 -> (m, n) int32, exact."""
    return torch.matmul(x_q.to(torch.int32), w_q.to(torch.int32))


def int8_matmul(x_q, w_q):
    """(m, k) int8 x (k, n) int8 -> (m, n) int32. CPU tensors take
    :func:`int8_matmul_plain`; CUDA tensors ``torch._int_mm``, with m padded
    with zero rows to ``INT_MM_MIN_ROWS`` where it is below.
    k and n must be multiples of 8 (:class:`QLinear` pads n when it
    quantizes); anything else raises. Each CUDA call adds one to
    ``int8_matmul.launches``."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"int8 operands expected, got {x_q.dtype} / {w_q.dtype}")
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"shapes {tuple(x_q.shape)} x {tuple(w_q.shape)}")
    if x_q.device != w_q.device:
        raise ValueError(f"operands on {x_q.device} and {w_q.device}")
    if x_q.device.type == "cpu":
        return int8_matmul_plain(x_q, w_q)
    m, k = x_q.shape
    n = w_q.shape[1]
    if k % INT_MM_ALIGN or n % INT_MM_ALIGN:
        raise ValueError(f"torch._int_mm needs k and n multiples of {INT_MM_ALIGN}: "
                         f"k={k}, n={n}")
    if m < INT_MM_MIN_ROWS:
        x_q = torch.nn.functional.pad(x_q, (0, 0, 0, INT_MM_MIN_ROWS - m))
    acc = torch._int_mm(x_q, w_q)
    int8_matmul.launches += 1
    return acc[:m]


int8_matmul.launches = 0


def quantize_rows(x):
    """``x`` (..., k) -> (x_q int8 (..., k), sx f32 (..., 1)): one symmetric
    scale per row."""
    xf = x.float()
    sx = _div127(xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12))
    return torch.round(xf / sx).to(torch.int8), sx  # |xf / sx| <= 127


def linear_q8(x, w_q, scale, b=None):
    """``x @ w + b`` from int8 weights ``w_q`` (in, n_pad) and their f32
    ``scale`` (out,), ``out <= n_pad`` (the columns past ``out`` are padding),
    with x quantized per row to int8. Returns x's dtype."""
    x_q, sx = quantize_rows(x)
    n = scale.shape[-1]
    acc = int8_matmul(x_q.reshape(-1, x.shape[-1]), w_q)[:, :n]
    y = acc.reshape(*x.shape[:-1], n).float() * sx * scale.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


class QLinear(nn.Module):
    """An int8 linear: buffers ``w_q`` (int8, (in, n_pad)), ``scale`` (f32,
    (out,)) and ``b`` (f32, (out,), or None). ``n_pad`` is ``out`` rounded up
    to a multiple of 8 (``torch._int_mm``'s rule for the output width; the
    padded columns are zero and are sliced off). ``w_q`` is stored column-
    major (its transpose contiguous), each column's k values adjacent: the
    operand layout of cuBLASLt's int8 GEMM."""

    def __init__(self, w_q, scale, b=None):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("scale", scale)
        self.register_buffer("b", b)

    @classmethod
    def from_float(cls, w, b=None):
        """Quantize f32 weights ``w`` (in, out) and bias ``b`` (out,)."""
        w_q, scale, b = quantize_linear(w, b)
        pad = -w_q.shape[1] % INT_MM_ALIGN
        if pad:
            w_q = torch.nn.functional.pad(w_q, (0, pad))
        return cls(w_q.t().contiguous().t(), scale,
                   None if b is None else b.to(w_q.device))

    def forward(self, x):
        return linear_q8(x, self.w_q, self.scale, self.b)


def quantize_gpt(model: nn.Module, tree: dict) -> None:
    """Replace the GPT ``model``'s block projections and its ``mel_head`` /
    ``text_head`` with :class:`QLinear`s quantized from ``tree``, the GPT's
    f32 parameters in the JAX package's layout (blocks stacked on a leading
    axis, or a list), on the model's device, and set the core's LayerNorms
    (``ln_1``, ``ln_2``, ``ln_f``) to the tree's f32 values: the JAX
    package's ``build_pipeline`` quantizes its f32 core, so under a bf16 GPT
    they stay f32. In place."""
    device = model.mel_embedding.device

    def pick(x, i):
        return x if i is None else x[i]

    def qlinear(p, i=None):
        b = p.get("b")
        return QLinear.from_float(_f32(pick(p["w"], i), device),
                                  None if b is None else _f32(pick(b, i), device))

    def f32_norm(ln, p, i=None):
        for key in ("scale", "bias"):
            setattr(ln, key, nn.Parameter(_f32(pick(p[key], i), device), requires_grad=False))

    blocks = tree["core"]["blocks"]
    for i, block in enumerate(model.core.blocks):
        bt, idx = (blocks, i) if isinstance(blocks, dict) else (blocks[i], None)
        f32_norm(block.ln_1, bt["ln_1"], idx)
        f32_norm(block.ln_2, bt["ln_2"], idx)
        for sub, names in (("attn", ("c_attn", "c_proj")), ("mlp", ("c_fc", "c_proj"))):
            for name in names:
                setattr(getattr(block, sub), name, qlinear(bt[sub][name], idx))
    f32_norm(model.core.ln_f, tree["core"]["ln_f"])
    model.mel_head = qlinear(tree["mel_head"])
    model.text_head = qlinear(tree["text_head"])


def _f32(x, device):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(
        device=device, dtype=torch.float32)
