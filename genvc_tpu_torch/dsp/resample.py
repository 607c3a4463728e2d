"""Sample-rate conversion (``genvc_tpu/dsp/resample.py``).

Reproduces ``torchaudio.functional.resample`` numerics (hann / kaiser windowed
sinc, polyphase) with the kernel precomputed on the host by
:func:`genvc_tpu_torch.dsp.filters.resample_kernel`: :func:`resample` applies
it to tensors as one strided f32 convolution, :func:`resample_np` to numpy
arrays for host-side audio loading.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from genvc_tpu_torch.dsp import filters


def resample(x, orig_freq: int, new_freq: int, *, lowpass_filter_width: int = 6,
             rolloff: float = 0.99, beta: float | None = None, window: str = "hann"):
    """Resample (..., T) -> (..., ceil(T * new/orig)) matching torchaudio;
    ``window`` "hann" or "kaiser" (with ``beta``)."""
    if orig_freq == new_freq:
        return x
    kernels, width, orig_r, _ = filters.resample_kernel(
        orig_freq, new_freq, lowpass_filter_width, rolloff, beta, window)
    t = x.shape[-1]
    batch_shape = x.shape[:-1]
    xb = F.pad(x.reshape(-1, 1, t).float(), (width, width + orig_r))
    k = torch.as_tensor(kernels, device=x.device)[:, None, :]
    y = F.conv1d(xb, k, stride=orig_r)                 # (B, new_r, blocks)
    y = y.transpose(1, 2).reshape(xb.shape[0], -1)     # interleave phases
    target_len = filters.resample_output_length(t, orig_freq, new_freq)
    return y[:, :target_len].reshape(*batch_shape, target_len)


def resample_np(x: np.ndarray, orig_freq: int, new_freq: int, *,
                lowpass_filter_width: int = 6, rolloff: float = 0.99,
                beta: float | None = None, window: str = "hann"):
    """Host (numpy) version with identical numerics."""
    if orig_freq == new_freq:
        return x
    kernels, width, orig_r, _ = filters.resample_kernel(
        orig_freq, new_freq, lowpass_filter_width, rolloff, beta, window)
    t = x.shape[-1]
    batch_shape = x.shape[:-1]
    xb = np.pad(x.reshape(-1, t).astype(np.float32), ((0, 0), (width, width + orig_r)))
    n_blocks = (t + orig_r - 1) // orig_r
    idx = (np.arange(n_blocks) * orig_r)[:, None] + np.arange(kernels.shape[1])[None, :]
    y = np.einsum("bnk,pk->bnp", xb[:, idx], kernels).reshape(xb.shape[0], -1)
    target_len = filters.resample_output_length(t, orig_freq, new_freq)
    return y[:, :target_len].reshape(batch_shape + (target_len,))
