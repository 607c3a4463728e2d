"""Constant-Q transform, CQT2010-style octave cascade, for the MS-SB-CQT
discriminator (``genvc_tpu/dsp/cqt.py``; reference layers/hifigan.py:623-759
via nnAudio CQT2010v2).

The complex kernels of the top octave are computed once on the host (numpy)
and applied to frames of the signal as one f32 matmul; each lower octave
reuses them on the signal resampled 2x down (the port's torchaudio-matching
resampler) with the hop halved.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from genvc_tpu_torch.dsp.mel import frame_signal
from genvc_tpu_torch.dsp.resample import resample


@functools.lru_cache(maxsize=None)
def top_octave_kernels(sr: int, fmax: float, bins_per_octave: int):
    """Complex CQT kernels of the top octave at rate ``sr``: (real, imag),
    each (bins_per_octave, kernel_len), frequencies low to high."""
    q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    freqs = fmax / 2.0 * 2.0 ** (np.arange(1, bins_per_octave + 1)
                                 / bins_per_octave)  # (fmax/2, fmax]
    lengths = np.ceil(q * sr / freqs).astype(int)
    klen = int(2 ** np.ceil(np.log2(lengths.max())))
    re = np.zeros((bins_per_octave, klen), np.float32)
    im = np.zeros((bins_per_octave, klen), np.float32)
    for i, (f, n) in enumerate(zip(freqs, lengths)):
        start = (klen - n) // 2
        t = np.arange(n)
        window = 0.5 - 0.5 * np.cos(2 * np.pi * (t + 0.5) / n)
        phase = 2 * np.pi * f * (t - n / 2) / sr
        re[i, start : start + n] = np.cos(phase) * window / n
        im[i, start : start + n] = np.sin(phase) * window / n
    return re, im


def cqt2010(x, sr: int, hop_length: int, n_octaves: int, bins_per_octave: int,
            fmin: float = 32.703195662574764):
    """(B, T) -> (B, n_octaves * bins_per_octave, frames, 2) complex CQT; bin 0
    is the lowest frequency (nnAudio's order, which the discriminator's
    per-octave pre-convs rely on)."""
    fmax = fmin * 2.0 ** n_octaves
    re_k, im_k = top_octave_kernels(sr, fmax, bins_per_octave)
    klen = re_k.shape[1]
    kern = torch.as_tensor(np.stack([re_k.T, im_k.T], axis=-1).reshape(klen, -1),
                           device=x.device)  # (klen, bins * 2)
    outs = []
    sig = x.float()
    for octave in range(n_octaves):  # octave 0 = top
        hop = hop_length // (2 ** octave)
        frames = frame_signal(F.pad(sig, (klen // 2, klen // 2)), klen, hop)
        z = frames @ kern
        z = z.reshape(z.shape[0], z.shape[1], bins_per_octave, 2)
        outs.append(z.transpose(1, 2))  # (B, bins, n_frames, 2)
        if octave < n_octaves - 1:
            sig = resample(sig, 2, 1)
    n_frames = min(o.shape[2] for o in outs)
    return torch.cat([o[:, :, :n_frames] for o in reversed(outs)], dim=1)
