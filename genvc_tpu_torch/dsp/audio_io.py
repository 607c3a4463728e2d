"""Host audio IO (``genvc_tpu/dsp/audio_io.py``).

Mirrors the reference ``load_audio`` contract (reference utils.py:49-75):
mono-ize, resample to the requested rate, sanity-check the value range
(``None`` is the corrupt-file sentinel the datasets skip on), clip to
[-1, 1]. The native C++ decoder / resampler
(:mod:`genvc_tpu_torch.data.native_audio`) is tried first; numpy otherwise.
"""

from __future__ import annotations

import wave

import numpy as np

from genvc_tpu_torch.dsp.resample import resample_np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a PCM wav file -> (float32 array (channels, T), sample_rate);
    scipy's reader first, the stdlib ``wave`` module (16-bit PCM) when it
    fails."""
    from scipy.io import wavfile

    try:
        sr, data = wavfile.read(path)
    except Exception:
        with wave.open(path, "rb") as wf:
            sr, ch = wf.getframerate(), wf.getnchannels()
            raw = wf.readframes(wf.getnframes())
        audio = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
        return audio.reshape(-1, ch).T, sr
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    audio = audio[None, :] if audio.ndim == 1 else audio.T
    return audio, int(sr)


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    audio = np.asarray(audio)
    if audio.ndim == 2:
        audio = audio[0]
    pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(pcm.tobytes())


def load_audio(path: str, sampling_rate: int) -> np.ndarray | None:
    """Reference-compatible loader: returns (1, T) float32, or None for a
    file that does not load (missing, cut short, not a wav, too short, out
    of range): any failure of the reader or the resampler is the sentinel.
    The native path comes first; a file it rejects is read again in numpy,
    as the JAX package's loader does."""
    from genvc_tpu_torch.data import native_audio

    try:
        out = native_audio.load_audio_native(path, sampling_rate)
    except Exception:  # the numpy path decides
        out = None
    if out is not None:
        return out
    try:
        audio, sr = read_wav(path)
        if audio.shape[0] != 1:
            audio = audio.mean(axis=0, keepdims=True)
        if audio.shape[1] <= 10:
            return None
        if sr != sampling_rate:
            audio = resample_np(audio, sr, sampling_rate)
    except Exception:
        return None
    # same out-of-range sentinel as the reference (utils.py:69-72)
    if np.any(audio > 10) or not np.any(audio < 0):
        return None
    return np.clip(audio, -1.0, 1.0).astype(np.float32)
