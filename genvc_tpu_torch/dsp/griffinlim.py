"""Mel inversion for the GPT stage's listening samples
(``genvc_tpu/dsp/griffinlim.py``).

The reference's ``TorchMelSpectrogram.invert`` (utils.py:164-172):
de-normalize, exp, the least-squares inverse mel scale, then 64 Griffin-Lim
iterations. Runs on the caller's device in float64, as the JAX package's
numpy version does, with the module's own STFT pair (reflect-padded Hann
frames; overlap-add divided by the summed squared window, floored at 1e-8),
so the edges are normalised exactly as there. The initial phases are numpy's
``default_rng(0).random``, as there: Griffin-Lim settles on another
waveform from another start.
"""

from __future__ import annotations

import numpy as np
import torch

from genvc_tpu_torch.dsp import filters


def invert_mel(mel, mel_norms, sample_rate: int = 24000, n_fft: int = 1024,
               hop_length: int = 256, win_length: int = 1024,
               fmin: float = 0.0, fmax: float = 8000.0, n_iter: int = 64) -> np.ndarray:
    """(n_mels, T) normalized log-mel (a tensor on any device, or numpy) ->
    waveform (T * hop - hop,) float32 numpy."""
    mel = torch.as_tensor(mel).to(torch.float64)
    if mel_norms is not None:
        mel = mel * torch.as_tensor(mel_norms, device=mel.device).to(torch.float64)[:, None]
    power = torch.exp(mel)  # power spectrogram in mel bins
    fb = filters.mel_filterbank(sample_rate, n_fft, mel.shape[0], fmin, fmax,
                                scale="htk", norm="slaney").astype(np.float64)
    # the minimum-norm least-squares solution of fb.T @ spec = power, as
    # np.linalg.lstsq gives it (torchaudio's InverseMelScale semantics)
    inv = torch.as_tensor(np.linalg.pinv(fb.T), device=mel.device)
    mag = torch.sqrt(torch.clamp(inv @ power, min=0.0))
    return griffin_lim(mag, n_fft, hop_length, win_length, n_iter)


def _window(n_fft, win, device):
    w = filters.hann_window(win).astype(np.float64)
    if win < n_fft:
        pad = (n_fft - win) // 2
        w = np.pad(w, (pad, n_fft - win - pad))
    return torch.as_tensor(w, device=device)


def _stft(x, w, n_fft, hop):
    pad = n_fft // 2
    xp = torch.nn.functional.pad(x[None, None], (pad, pad), mode="reflect")[0, 0]
    frames = xp.unfold(0, n_fft, hop)  # (n_frames, n_fft)
    return torch.fft.rfft(frames * w, dim=-1).T  # (F, T)


def _istft(spec, w, n_fft, hop, length):
    n = spec.shape[1]
    frames = torch.fft.irfft(spec.T, n=n_fft, dim=-1) * w  # (T, n_fft)
    idx = (torch.arange(n, device=w.device)[:, None] * hop
           + torch.arange(n_fft, device=w.device)[None, :]).reshape(-1)
    size = hop * (n - 1) + n_fft
    out = torch.zeros(size, dtype=w.dtype, device=w.device).index_add_(0, idx, frames.reshape(-1))
    norm = torch.zeros_like(out).index_add_(0, idx, (w * w).repeat(n))
    out = out / torch.clamp(norm, min=1e-8)
    pad = n_fft // 2
    return out[pad: pad + length]


def griffin_lim(mag, n_fft: int, hop: int, win: int, n_iter: int = 64) -> np.ndarray:
    """Griffin-Lim phase reconstruction from a magnitude (F, T) tensor;
    returns the waveform as float32 numpy."""
    mag = torch.as_tensor(mag).to(torch.float64)
    w = _window(n_fft, win, mag.device)
    phase = np.random.default_rng(0).random(tuple(mag.shape))
    angles = torch.polar(torch.ones_like(mag), torch.as_tensor(2 * np.pi * phase,
                                                               device=mag.device))
    length = hop * (mag.shape[1] - 1)
    x = _istft(mag * angles, w, n_fft, hop, length)
    for _ in range(n_iter):
        spec = _stft(x, w, n_fft, hop)[:, : mag.shape[1]]
        angles = torch.polar(torch.ones_like(mag), torch.angle(spec))
        x = _istft(mag * angles, w, n_fft, hop, length)
    return x.to(torch.float32).cpu().numpy()
