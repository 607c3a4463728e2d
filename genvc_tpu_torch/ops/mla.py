"""Latent (MLA) single-token decode attention over the latent cache, in the
absorbed form (DeepSeek-V3).

Not a TPU kernel of the JAX package (it has no latent attention): added for
the DeepSeek-V3 backbone (``models/mla_moe.py``). The kernel is
``csrc/mla_decode.cu``, built with ``nvcc`` at first use and called through
``ctypes``.

Shapes (one layer of the decode stack):
  q       (B, H, R + P)     bf16 -- [W_UK,h^T q_nope | q_pe] per head
  cache   (L, B, T, R + P)  bf16 -- [RMSNorm(c) | RoPE(k_pe)] per position
  bias    (B, T)            f32 additive key-padding bias (0 / -1e9)
  -> out  (B, H, R)         bf16 -- softmax(q . cache^T * scale + bias) . c

Numerics: f32 logits over bf16 operands, scaled then biased, an f32
softmax, f32 P.C sums, bf16 out (:func:`mla_decode_plain`). The caller
applies W_UV,h to ``out``.

:func:`mla_decode` launches the kernel for CUDA tensors (two launches a call,
counted once in ``mla_decode.launches`` and, with the recorder on, in the
counter ``ops.mla_decode.kernel``); CPU tensors take the plain version;
anything the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from genvc_tpu_torch import tracing

MAX_HEADS = 16
MAX_KEYS_A_BLOCK = 128
BLOCKS_PER_SM = 2  # the split's target


def mla_decode_plain(q, cache, bias, layer_idx: int, r: int, scale: float):
    """Plain PyTorch version with the kernel's arithmetic."""
    c = cache[layer_idx].float()                               # (B, T, R + P)
    logits = torch.einsum("bhw,btw->bht", q.float(), c) * scale + bias.float()[:, None, :]
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bht,btr->bhr", p, c[..., :r]).to(q.dtype)


def split_len(b: int, t: int, n_blocks: int) -> int:
    """Keys a block: at most ``MAX_KEYS_A_BLOCK``, and few enough that the
    ``b * ceil(t / per)`` blocks are about ``n_blocks``."""
    want = max(1, -(-n_blocks // b))
    return max(1, min(MAX_KEYS_A_BLOCK, -(-t // want)))


def _check(q, cache, bias, layer_idx, r):
    if cache.dim() != 4 or q.dim() != 3:
        raise ValueError("the cache must be (L, B, T, R + P) and q (B, H, R + P)")
    n_layers, b, t, w = cache.shape
    if q.shape[0] != b or q.shape[2] != w or bias.shape != (b, t):
        raise ValueError(f"q {tuple(q.shape)} / bias {tuple(bias.shape)} do not match the "
                         f"cache {tuple(cache.shape)}")
    if not 0 < r <= w:
        raise ValueError(f"latent width {r} outside the cache's row of {w}")
    if not 0 <= int(layer_idx) < n_layers:
        raise IndexError(f"layer {layer_idx} outside 0..{n_layers - 1}")
    if len({x.device for x in (q, cache, bias)}) != 1:
        raise ValueError("tensors on several devices")


def mla_decode(q, cache, bias, layer_idx: int, r: int, scale: float):
    """Absorbed MLA attention of ``q`` over layer ``layer_idx`` of the latent
    cache, whose rows are ``r`` latent values then the rotated key."""
    _check(q, cache, bias, layer_idx, r)
    if q.device.type == "cpu":
        return mla_decode_plain(q, cache, bias, layer_idx, r, scale)
    n_layers, b, t, w = cache.shape
    h = q.shape[1]
    if (q.dtype != torch.bfloat16 or cache.dtype != torch.bfloat16 or h > MAX_HEADS
            or r % 8 or (w - r) % 8 or r > 512 or w > 576 or not cache.is_contiguous()
            or cache.data_ptr() % 16):
        raise ValueError(
            f"mla_decode kernel: q {q.dtype} {tuple(q.shape)}, cache {cache.dtype} "
            f"{tuple(cache.shape)}: it takes bf16, at most {MAX_HEADS} heads, R and P "
            "multiples of 8 with R <= 512 and R + P <= 576, a contiguous 16-byte aligned cache")
    per = split_len(b, t, BLOCKS_PER_SM * _sm_count(q.device))
    splits = -(-t // per)
    lib = _lib()
    scratch = torch.empty(lib.genvc_mla_decode_scratch_bytes(b, h, r, splits) // 4,
                          dtype=torch.float32, device=q.device)
    q = q.contiguous()
    bias = bias.to(torch.float32).contiguous()
    out = torch.empty(b, h, r, dtype=torch.bfloat16, device=q.device)
    err = lib.genvc_mla_decode(q.data_ptr(), cache.data_ptr(), bias.data_ptr(), out.data_ptr(),
                               scratch.data_ptr(), n_layers, b, t, h, r, w - r, int(layer_idx),
                               per, scale, torch._C._cuda_getCurrentRawStream(q.get_device()))
    if err != 0:
        raise RuntimeError(f"mla_decode kernel launch failed: CUDA error {err}")
    mla_decode.launches += 1
    tracing.count("ops.mla_decode.kernel")
    return out


mla_decode.launches = 0


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _lib():
    from genvc_tpu_torch import _build

    lib = _build.load("mla_decode")
    lib.genvc_mla_decode.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                                     + [ctypes.c_float, ctypes.c_void_p])
    lib.genvc_mla_decode.restype = ctypes.c_int
    lib.genvc_mla_decode_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.genvc_mla_decode_scratch_bytes.restype = ctypes.c_size_t
    return lib
