"""Speech inputs: the repo's two sample recordings (96 kHz, 24-bit, copied
under ``perfbench/data``), resampled and tiled.

Both sides of every comparison get the same arrays. Samples are 16-bit PCM
values over 32768, so the program's own PCM quantization leaves them as they
are.
"""

from __future__ import annotations

import functools
import os
import wave

import numpy as np

SAMPLES = ("perfbench/data/EF4_ENG_0112_1.wav", "perfbench/data/EM1_ENG_0037_1.wav")


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Mono float64 samples in [-1, 1) and the rate, from 16- or 24-bit PCM."""
    with wave.open(path, "rb") as w:
        rate, width, ch = w.getframerate(), w.getsampwidth(), w.getnchannels()
        raw = np.frombuffer(w.readframes(w.getnframes()), np.uint8)
    if width == 2:
        x = raw.view("<i2").astype(np.float64) / 32768.0
    elif width == 3:
        b = raw.reshape(-1, 3).astype(np.int32)
        v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        x = np.where(v >= 1 << 23, v - (1 << 24), v).astype(np.float64) / float(1 << 23)
    else:
        raise ValueError(f"{path}: {8 * width}-bit PCM is not read here")
    return x.reshape(-1, ch).mean(axis=1), rate


def decimate(x: np.ndarray, factor: int, taps: int = 255) -> np.ndarray:
    """Low-pass (Blackman-windowed sinc at 0.45 of the new rate) and keep
    every ``factor``-th sample."""
    n = np.arange(taps) - (taps - 1) / 2
    cut = 0.45 / factor
    h = 2 * cut * np.sinc(2 * cut * n) * np.blackman(taps)
    y = np.convolve(x, h / h.sum(), mode="same")
    return y[::factor]


def pcm16(x: np.ndarray) -> np.ndarray:
    return (np.clip(np.rint(x * 32768.0), -32768, 32767) / 32768.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def corpus(root: str, rate: int) -> tuple[np.ndarray, ...]:
    """The sample recordings at ``rate`` (a divisor of theirs), as 16-bit
    values."""
    out = []
    for rel in SAMPLES:
        x, sr = read_wav(os.path.join(root, rel))
        if sr % rate:
            raise ValueError(f"{rel}: {sr} Hz is not a multiple of {rate} Hz")
        out.append(pcm16(decimate(x, sr // rate) if sr != rate else x))
    return tuple(out)


def clip(root: str, rate: int, seconds: float, which: int, offset: float) -> np.ndarray:
    """(1, n) samples: recording ``which`` tiled end to end, cut at ``offset``
    (a share of its length) for ``seconds``."""
    src = corpus(root, rate)[which % len(SAMPLES)]
    n = int(round(seconds * rate))
    start = int(offset * src.size)
    reps = -(-(start + n) // src.size)
    return np.tile(src, reps)[start: start + n][None, :]
