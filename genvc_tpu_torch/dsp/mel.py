"""STFT -> mel -> log -> norm as dense f32 matmuls (``genvc_tpu/dsp/mel.py``).

The windowed real DFT is two matmuls with precomputed (n_fft, n_freqs)
matrices, as in the JAX package; on the card these run in full f32 (TF32 off):
mel values feed frozen VQ codebooks, where one rounding can flip a code.

:func:`mel_torchaudio` reproduces ``torchaudio.transforms.MelSpectrogram(
power=2, norm='slaney', mel_scale='htk')`` + log-clamp + per-bin mel-norm
division — the reference's ``TorchMelSpectrogram``. :func:`mel_vocoder_loss`
is the vocoder loss's librosa-mel magnitude features (center=False after a
(n_fft - hop) / 2 reflect pad) and :func:`stft_complex` the MS-STFT
discriminator's normalized complex STFT (center=False, no padding).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from genvc_tpu_torch.dsp import filters


def frame_signal(x, n_fft: int, hop_length: int):
    """(B, T) -> (B, n_frames, n_fft) sliding windows; no padding applied."""
    return x.unfold(-1, n_fft, hop_length)


def _dft(frames, n_fft: int, win_length: int, normalized: bool = False):
    """(re, im) of the windowed real DFT of (..., n_frames, n_fft) frames."""
    cos_mat, sin_mat = filters.windowed_dft(n_fft, win_length, normalized)
    frames = frames.float()
    return (frames @ torch.as_tensor(cos_mat, device=frames.device),
            frames @ torch.as_tensor(sin_mat, device=frames.device))


def _power_spectrum(frames, n_fft: int, win_length: int):
    re, im = _dft(frames, n_fft, win_length)
    return re * re + im * im


@dataclasses.dataclass(frozen=True)
class MelSpec:
    """Static mel-extraction parameters."""

    sample_rate: int = 24000
    n_fft: int = 1024
    win_length: int = 1024
    hop_length: int = 256
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float | None = 8000.0
    scale: str = "htk"  # 'htk' == torchaudio default; 'slaney' == librosa default

    def fbank(self) -> np.ndarray:
        return filters.mel_filterbank(
            self.sample_rate, self.n_fft, self.n_mels, self.fmin, self.fmax,
            scale=self.scale, norm="slaney")


def mel_torchaudio(x, spec: MelSpec, mel_norms=None, pre_padded: bool = False):
    """(B, T) waveform -> (B, n_mels, 1 + T//hop) normalized log-mel.

    ``pre_padded=True`` means the caller already applied the center reflect
    padding of n_fft//2 on each side (the inference path reflects the
    true-length signal on the host, then zero-pads to a static width)."""
    if not pre_padded:
        pad = spec.n_fft // 2
        x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = frame_signal(x, spec.n_fft, spec.hop_length)
    power = _power_spectrum(frames, spec.n_fft, spec.win_length)
    mel = power @ torch.as_tensor(spec.fbank(), device=x.device)
    mel = torch.log(mel.clamp_min(1e-5))
    if mel_norms is not None:
        mel = mel / mel_norms[None, None, :]
    return mel.transpose(-1, -2)


def mel_vocoder_loss(x, spec: MelSpec):
    """(B, T) -> (B, n_mels, frames): the reference vocoder loss's mel (reflect
    pad (n_fft - hop) / 2, center=False, magnitude sqrt(re^2 + im^2 + 1e-9),
    the spec's mel scale, log-clamp 1e-5)."""
    pad = (spec.n_fft - spec.hop_length) // 2
    x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = frame_signal(x, spec.n_fft, spec.hop_length)
    mag = torch.sqrt(_power_spectrum(frames, spec.n_fft, spec.win_length) + 1e-9)
    mel = mag @ torch.as_tensor(spec.fbank(), device=x.device)
    return torch.log(mel.clamp_min(1e-5)).transpose(-1, -2)


def stft_complex(x, n_fft: int, hop_length: int, win_length: int):
    """Normalized complex STFT, center=False, no padding: (B, T) -> (re, im),
    each (B, n_freqs, n_frames); torch ``Spectrogram(normalized=True,
    center=False, power=None)``."""
    re, im = _dft(frame_signal(x, n_fft, hop_length), n_fft, win_length, normalized=True)
    return re.transpose(-1, -2), im.transpose(-1, -2)


def num_frames_center(t: int, hop_length: int) -> int:
    return 1 + t // hop_length
