"""The routed experts of a DeepSeek-V3 mixture-of-experts layer.

Not a TPU kernel of the JAX package (it has no experts): added for the
DeepSeek-V3 backbone (``models/mla_moe.py``). The kernel is
``csrc/moe_experts.cu``, built with ``nvcc`` at first use and called
through ``ctypes``.

  x    (M, D)       the rows, in the model's type
  idx  (M, K)       int expert ids, distinct in a row (device data: the
                    router's top-k, never read on the host)
  w    (M, K)       f32 combine weights
  w1   (E, 2F, D)   each expert's gate rows, then its up rows (out x in)
  w2   (E, D, F)    each expert's down rows (out x in)
  -> y (M, D)       sum_k w[m, k] * down(silu(gate x) * up x), x's type

Numerics (:func:`moe_experts_plain`): f32 sums; the gate and up outputs,
silu, their product and the down output each rounded to x's type, as the
PyTorch ops of a bf16 model round them; the weighted sum over k in f32, then
x's type.

:func:`moe_experts` launches the kernel for CUDA tensors (three launches a
call, counted once in ``moe_experts.launches`` and, with the recorder on, in
``ops.moe_experts.kernel``); CPU tensors take the plain version; anything
the kernel does not take raises. With the recorder on, each call also adds
the number of distinct experts its rows chose to a counter kept on the
device; :func:`flush_touched` moves it to the recorder's
``moe.experts_touched`` (one read of a device scalar: a caller that wants
the count flushes once, after it has synchronised, before it takes the
recorder's snapshot).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from genvc_tpu_torch import tracing

_touched: dict = {}  # device -> int32 (1,) tensor: chosen experts since the last flush


def moe_experts_plain(x, idx, w, w1, w2):
    """Plain PyTorch version: the assignments grouped by expert (a host loop
    over the experts some row chose), with the kernel's roundings."""
    m, k = idx.shape
    n_exp, f2, d = w1.shape
    f = f2 // 2
    flat = idx.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=n_exp).tolist()
    z = torch.zeros(m * k, d, dtype=x.dtype, device=x.device)
    start = 0
    for e, c in enumerate(counts):
        if c == 0:
            continue
        a = order[start: start + c]
        start += c
        gu = x[a // k].float() @ w1[e].float().T
        g, u = gu[:, :f].to(x.dtype).float(), gu[:, f:].to(x.dtype).float()
        h = (torch.nn.functional.silu(g).to(x.dtype).float() * u).to(x.dtype)
        z[a] = (h.float() @ w2[e].float().T).to(x.dtype)
    return (z.view(m, k, d).float() * w.float()[..., None]).sum(1).to(x.dtype)


def _counter(device):
    t = _touched.get(device)
    if t is None:
        t = _touched[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


def flush_touched():
    """Add the experts chosen since the last flush to the recorder's counter
    ``moe.experts_touched`` (one read of a device scalar each device that
    ran a call; nothing while the recorder is off)."""
    if not tracing.enabled():
        return
    with torch.inference_mode():  # the counter may have been made under it
        for t in _touched.values():
            tracing.count("moe.experts_touched", int(t.item()))
            t.zero_()


def _check(x, idx, w, w1, w2):
    m, d = x.shape
    if idx.dim() != 2 or idx.shape[0] != m or w.shape != idx.shape:
        raise ValueError(f"idx {tuple(idx.shape)} / w {tuple(w.shape)} do not match x "
                         f"{tuple(x.shape)}")
    if w1.dim() != 3 or w1.shape[2] != d or w2.dim() != 3 or w2.shape[:2] != (w1.shape[0], d) \
            or w1.shape[1] != 2 * w2.shape[2]:
        raise ValueError(f"w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)}: (E, 2F, D) and "
                         "(E, D, F)")
    if len({t.device for t in (x, idx, w, w1, w2)}) != 1:
        raise ValueError("tensors on several devices")


def moe_experts(x, idx, w, w1, w2):
    """The routed experts' weighted sum for each row of ``x`` (see above)."""
    _check(x, idx, w, w1, w2)
    if x.device.type == "cpu":
        if tracing.enabled():
            chosen = torch.zeros(w1.shape[0], dtype=torch.bool)
            chosen[idx.reshape(-1).long()] = True
            _counter(x.device).add_(chosen.sum().to(torch.int32))
        return moe_experts_plain(x, idx, w, w1, w2)
    m, d = x.shape
    n_exp, f2, _ = w1.shape
    f = f2 // 2
    tensors = (x, w1, w2)
    if (any(t.dtype != torch.bfloat16 for t in tensors) or d % 8 or d > 2048 or f % 8
            or f > 1536 or any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors)):
        raise ValueError(
            f"moe_experts kernel: x {x.dtype} {tuple(x.shape)}, w1 {w1.dtype} "
            f"{tuple(w1.shape)}, w2 {w2.dtype} {tuple(w2.shape)}: it takes bf16, D a multiple "
            "of 8 up to 2048, F a multiple of 8 up to 1536, contiguous and 16-byte aligned")
    k = idx.shape[1]
    idx = idx.to(torch.int32).contiguous()
    w = w.to(torch.float32).contiguous()
    h = torch.empty(m * k, f, dtype=torch.bfloat16, device=x.device)
    z = torch.empty(m * k, d, dtype=torch.bfloat16, device=x.device)
    y = torch.empty(m, d, dtype=torch.bfloat16, device=x.device)
    touched = _counter(x.device).data_ptr() if tracing.enabled() else None
    err = _lib().genvc_moe_experts(
        x.data_ptr(), idx.data_ptr(), w.data_ptr(), w1.data_ptr(), w2.data_ptr(), h.data_ptr(),
        z.data_ptr(), y.data_ptr(), touched, m, k, n_exp, d, f,
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err != 0:
        raise RuntimeError(f"moe_experts kernel launch failed: CUDA error {err}")
    moe_experts.launches += 1
    tracing.count("ops.moe_experts.kernel")
    return y


moe_experts.launches = 0


@functools.cache
def _lib():
    from genvc_tpu_torch import _build

    lib = _build.load("moe_experts")
    lib.genvc_moe_experts.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.genvc_moe_experts.restype = ctypes.c_int
    return lib
