"""Fused single-token decode attention over the stacked KV cache.

Replaces the Pallas kernels of ``genvc_tpu/ops/decode_attention.py``:
``decode_attention_layer`` (body ``_decode_attn_layer_kernel``),
``decode_attention`` (body ``_decode_attn_kernel``, here the same CUDA kernel
with L = 1) and ``decode_attention_update_layer`` (body
``_decode_attn_update_kernel``: each row's new K/V written at its own
position, then the same attention). The kernels are in
``csrc/decode_attention.cu``, hand-written for ``sm_90a``, built with ``nvcc``
into a C-ABI library at first use and called through ``ctypes``.

Shapes (one layer of the decode stack, ``engine._attend_cached``):
  q         (B, H, hd)        bf16 or f32 — the new token's queries
  cache_k   (L, B, H, T, hd)  bf16 or float8_e4m3fn
  cache_v   (L, B, H, T, hd)  same dtype as cache_k
  bias      (B, T)            f32 additive key-padding bias (0 / -1e9)
  -> out    (B, H, hd)        q's dtype

Numerics (those of the Pallas body): q rounded to bf16, K/V widened from
their storage type, logits in f32 scaled by 1/sqrt(hd) then biased, softmax
in f32, probabilities rounded to bf16 before P.V, which accumulates in f32.

The e4m3 cache follows the JAX package's kernel path, not the running
torch's conversion (:func:`to_e4m3`, :func:`from_e4m3`): a write rounds to
the nearest even e4m3 value and stores a magnitude that rounds past 448
(|x| > 464; 464 is a tie and rounds to 448) as 0x7F / 0xFF, as
``jnp.astype(float8_e4m3fn)`` does; a read takes those two codes as +480 /
-480, as the Pallas kernels' bit-field upcast ``_f8e4m3_bits_to_bf16`` does.
Every other code reads as its e4m3 value.

Bound on the card: bytes. A call must read one layer of K and V,
``2 * B * H * T * hd * sizeof(cache)`` bytes — 1.57 MB at the streaming shape
(B=1, H=4, T=384, hd=256, bf16), 0.47 us at 3.35 TB/s — for 4*B*H*T*hd flops.
Both kernels split the cache length across blocks so that B*H*S blocks fill
the SMs (:func:`split_len`): a logits pass and a P.V pass with a fixed-order
combine, two CUDA launches per call, normalising by the global max and sum
before the bf16 rounding as the reference does. The update kernel stores
each row's new K/V in its logits pass, from the block whose key range holds
the row's position; see the source.

``decode_attention_layer`` runs the kernels for CUDA tensors and the plain
PyTorch version (:func:`decode_attention_layer_plain`, same casts) only for
CPU tensors; anything the kernels do not take raises. Each call that
launches them adds one to ``decode_attention_layer.launches``;
``decode_attention_update_layer`` likewise, with its own count.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

_F8 = torch.float8_e4m3fn
MAX_HD = 256
MIN_SPLIT_KEYS = 16  # keys per range of K1's split, at least (but the last)
SPLIT_BLOCKS_PER_SM = 4  # K1's blocks (4 warps each) per SM the split aims at


E4M3_LAST_TO_448 = 464.0  # larger magnitudes round past 448, e4m3's largest finite


def to_e4m3(x):
    """``x`` as float8_e4m3fn with ``jnp.astype``'s bits: round to the nearest
    even; a magnitude above 464 (and NaN, inf) becomes 0x7F / 0xFF by sign.
    Torch versions differ there (saturate to 448, or NaN), so the overflow
    is set here rather than taken from the conversion."""
    xf = x.float()
    bits = xf.to(_F8).view(torch.uint8)
    over = ~(xf.abs() <= E4M3_LAST_TO_448)  # NaN too
    return torch.where(over, bits | 0x7F, bits).view(_F8)


def from_e4m3(x):
    """An e4m3 tensor widened to bf16 (exact) as the reference's kernels read
    it: 0x7F / 0xFF, the codes an overflow stores, are +480 / -480."""
    bits = x.view(torch.uint8)
    sign = 1 - 2 * (bits >> 7).to(torch.bfloat16)
    return torch.where((bits & 0x7F) == 0x7F, sign * 480, x.to(torch.bfloat16))


def to_cache(x, dtype):
    """``x`` in a cache's storage type: :func:`to_e4m3` for an e4m3 cache."""
    if x.dtype == dtype:
        return x
    return to_e4m3(x) if dtype == _F8 else x.to(dtype)


def widen(cache):
    """A cache's values in bf16 (the kernels' operand type)."""
    return from_e4m3(cache) if cache.dtype == _F8 else cache.to(torch.bfloat16)


def decode_attention_layer_plain(q, cache_k, cache_v, bias, layer_idx):
    """Plain PyTorch version with the kernel's casts: bf16 q, f32 logits,
    f32 softmax, bf16 probabilities, f32 P.V accumulation, q's dtype out."""
    hd = q.shape[-1]
    k = widen(cache_k[layer_idx]).float()    # (B, H, T, hd)
    v = widen(cache_v[layer_idx]).float()
    qf = q.to(torch.bfloat16).float()
    logits = torch.einsum("bhd,bhtd->bht", qf, k) * (1.0 / math.sqrt(hd))
    logits = logits + bias.float()[:, None, :]
    probs = torch.softmax(logits, dim=-1).to(torch.bfloat16).float()
    out = torch.einsum("bht,bhtd->bhd", probs, v)
    return out.to(q.dtype)


def decode_attention_plain(q, k_cache, v_cache, bias):
    """Single-layer (B, H, T, hd) cache form of the plain version."""
    return decode_attention_layer_plain(q, k_cache[None], v_cache[None], bias, 0)


def write_rows(cache, new, pos):
    """``cache[b, :, pos[b]] = new[b]`` for each row of one layer's (B, H, T,
    hd) cache, in place; rows with ``pos`` outside [0, T) are left as they
    are (as JAX drops an out-of-range scatter). No position is read back to
    the host: an out-of-range row rewrites its clamped row unchanged."""
    t = cache.shape[2]
    new = to_cache(new, cache.dtype)
    if cache.dtype == _F8:  # index_put and where on the bits
        cache, new = cache.view(torch.uint8), new.view(torch.uint8)
    rows = torch.arange(cache.shape[0], device=cache.device)
    pos = pos.long()
    idx = pos.clamp(0, t - 1)
    keep = ((pos >= 0) & (pos < t))[:, None, None]
    cache[rows, :, idx] = torch.where(keep, new, cache[rows, :, idx])


def decode_attention_update_layer_plain(q, k_new, v_new, cache_k, cache_v, bias,
                                        pos, layer_idx):
    """Plain version of the update kernel: write ``k_new``/``v_new`` (B, H, hd)
    at row ``pos[b]`` of layer ``layer_idx`` (in place, dropping ``pos >= T``),
    then :func:`decode_attention_layer_plain` over the updated layer."""
    write_rows(cache_k[layer_idx], k_new, pos)
    write_rows(cache_v[layer_idx], v_new, pos)
    return decode_attention_layer_plain(q, cache_k, cache_v, bias, layer_idx)


def _check(q, cache_k, cache_v, bias, layer_idx):
    if cache_k.dtype not in (torch.bfloat16, _F8) or cache_v.dtype != cache_k.dtype:
        raise ValueError(f"cache dtype {cache_k.dtype}/{cache_v.dtype}: the "
                         "kernel takes bf16 or float8_e4m3fn caches")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q dtype {q.dtype}: the kernel takes bf16 or f32")
    if cache_k.dim() != 5 or cache_k.shape != cache_v.shape:
        raise ValueError("caches must be (L, B, H, T, hd) and equal in shape")
    n_layers, b, h, t, hd = cache_k.shape
    if q.shape != (b, h, hd) or bias.shape != (b, t):
        raise ValueError(f"q {tuple(q.shape)} / bias {tuple(bias.shape)} do "
                         f"not match cache {tuple(cache_k.shape)}")
    if hd % 8 or hd > MAX_HD:
        raise ValueError(f"head dim {hd}: the kernel takes multiples of 8 up "
                         f"to {MAX_HD}")
    if not 0 <= int(layer_idx) < n_layers:
        raise IndexError(f"layer {layer_idx} outside 0..{n_layers - 1}")
    devs = {x.device for x in (q, cache_k, cache_v, bias)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def decode_attention_layer(q, cache_k, cache_v, bias, layer_idx):
    """Attention of ``q`` over layer ``layer_idx`` of the stacked cache.

    CPU tensors take :func:`decode_attention_layer_plain`; CUDA tensors launch
    the kernel (no fallback)."""
    _check(q, cache_k, cache_v, bias, layer_idx)
    if q.device.type == "cpu":
        return decode_attention_layer_plain(q, cache_k, cache_v, bias, layer_idx)
    _check_cuda(q, cache_k, cache_v)
    lib = _lib()
    n_layers, b, h, t, hd = cache_k.shape
    per, scratch = _split_scratch(lib, b, h, t, hd, q.device)
    q = q.contiguous()
    bias = bias.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    err = lib.genvc_decode_attention_layer(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), n_layers, b, h, t, hd, int(layer_idx),
        int(q.dtype == torch.bfloat16), int(cache_k.dtype == _F8), per,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention_layer.launches += 1
    return out


decode_attention_layer.launches = 0


def split_len(bh, t, n_blocks):
    """K1's split of the cache length: keys per range, at least
    ``MIN_SPLIT_KEYS``, so that the ``bh * ceil(t / len)`` blocks are about
    ``n_blocks`` (one range once ``bh`` reaches it)."""
    return max(MIN_SPLIT_KEYS, -(-t // -(-n_blocks // bh)))


def _split_scratch(lib, b, h, t, hd, device):
    """The split of :func:`split_len` for this card, and its scratch."""
    per = split_len(b * h, t, SPLIT_BLOCKS_PER_SM * _sm_count(device))
    return per, torch.empty(lib.genvc_decode_attention_scratch_bytes(b, h, t, hd, per),
                            dtype=torch.uint8, device=device)


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_cuda(q, cache_k, cache_v):
    """What the kernels need beyond :func:`_check`: a CUDA device, and
    contiguous, 16-byte aligned caches (read with vector loads and, by the
    update kernel, written in place)."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not (cache_k.is_contiguous() and cache_v.is_contiguous()):
        raise ValueError("caches must be contiguous")
    for x in (cache_k, cache_v):
        if x.data_ptr() % 16:
            raise ValueError("caches must be 16-byte aligned")


def _check_update(q, k_new, v_new, pos):
    if k_new.shape != q.shape or v_new.shape != q.shape:
        raise ValueError(f"k_new {tuple(k_new.shape)} / v_new {tuple(v_new.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise ValueError("k_new and v_new must have q's dtype")
    if pos.shape != q.shape[:1] or pos.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"pos must be ({q.shape[0]},) int32 or int64, got "
                         f"{tuple(pos.shape)} {pos.dtype}")
    if len({x.device for x in (q, k_new, v_new, pos)}) != 1:
        raise ValueError("tensors on several devices")


def _row_stride(*xs):
    """The one row stride of (B, H, hd) views with packed heads (the chunks
    of the fused qkv projection), else None."""
    _, h, hd = xs[0].shape
    if any(x.stride(2) != 1 or x.stride(1) != hd for x in xs):
        return None
    strides = {x.stride(0) for x in xs}
    stride = strides.pop()
    return stride if not strides and stride >= h * hd else None


def decode_attention_update_layer(q, k_new, v_new, cache_k, cache_v, bias, pos,
                                  layer_idx):
    """Write each row's new K/V at its own position ``pos[b]`` of layer
    ``layer_idx`` (in place; ``pos[b] >= T`` writes nothing), then attend
    with ``q`` over the updated layer. ``bias`` (B, T) must already mark each
    ``pos[b]`` valid. q, k_new, v_new (B, H, hd) bf16 or f32, all one dtype;
    pos (B,) int32/int64 on the same device. Returns out (B, H, hd).

    CPU tensors take :func:`decode_attention_update_layer_plain`; CUDA
    tensors launch the kernel (no fallback)."""
    _check(q, cache_k, cache_v, bias, layer_idx)
    _check_update(q, k_new, v_new, pos)
    if q.device.type == "cpu":
        return decode_attention_update_layer_plain(q, k_new, v_new, cache_k, cache_v,
                                                   bias, pos, layer_idx)
    _check_cuda(q, cache_k, cache_v)
    lib = _lib()
    n_layers, b, h, t, hd = cache_k.shape
    per, scratch = _split_scratch(lib, b, h, t, hd, q.device)
    stride = _row_stride(q, k_new, v_new)
    if stride is None:
        q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
        stride = h * hd
    bias = bias.to(torch.float32).contiguous()
    pos = pos.contiguous()
    out = torch.empty(b, h, hd, dtype=q.dtype, device=q.device)
    err = lib.genvc_decode_attention_update_layer(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), bias.data_ptr(), pos.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), n_layers, b, h, t, hd, int(layer_idx), stride,
        int(q.dtype == torch.bfloat16), int(cache_k.dtype == _F8),
        int(pos.dtype == torch.int64), per,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_update kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention_update_layer.launches += 1
    return out


decode_attention_update_layer.launches = 0


def decode_attention(q, k_cache, v_cache, bias):
    """Single-layer (B, H, T, hd) cache form: the same kernel with L = 1
    (``unsqueeze`` is a view, no copy)."""
    return decode_attention_layer(q, k_cache.unsqueeze(0), v_cache.unsqueeze(0),
                                  bias, 0)


def _lib():
    from genvc_tpu_torch import _build

    lib = _build.load("decode_attention")
    fn = lib.genvc_decode_attention_layer
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        scratch = lib.genvc_decode_attention_scratch_bytes
        scratch.argtypes = [ctypes.c_int] * 5
        scratch.restype = ctypes.c_size_t
        up = lib.genvc_decode_attention_update_layer
        up.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        up.restype = ctypes.c_int
    return lib
