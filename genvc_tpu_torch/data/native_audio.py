"""ctypes binding of the repo's native audio-IO library (``native/audioio.cpp``;
``genvc_tpu/data/native_audio.py``).

The host data pipeline's fast path: wav decode and polyphase resampling in
C++ (the reference does both in torchaudio's C++ kernels inside its
DataLoader workers). The resampling filters come from
:mod:`genvc_tpu_torch.dsp.filters`, so the C++ side and the numpy fallback
share one filter design.

The library is built with ``g++`` and ``native/Makefile``'s flags at first
use, never at import, into ``genvc_tpu_torch/_build/libaudioio-<hash>.so``,
named by a digest of the source: the compiler writes a temporary file that
is then renamed into place, so concurrent builds (test workers) never load
a half-written library. When it cannot be built, :func:`available` is false
and :func:`genvc_tpu_torch.dsp.audio_io.load_audio` takes its numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

from genvc_tpu_torch.dsp import filters

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(PKG_DIR), "native", "audioio.cpp")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]  # native/Makefile

_lock = threading.Lock()
_lib = None  # the loaded library, False once a build or load failed


def lib_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libaudioio-{digest}.so")


def _build(dst: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, SOURCE],
                       check=True, capture_output=True)
        os.replace(tmp, dst)  # atomic: a reader never sees a half-written .so
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            path = lib_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.CalledProcessError):
            _lib = False
            return _lib
        lib.audioio_load_wav.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
        lib.audioio_load_wav.restype = ctypes.c_int
        lib.audioio_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.audioio_free.restype = None
        f32 = np.ctypeslib.ndpointer(np.float32, flags="C")
        lib.audioio_resample.argtypes = [
            f32, ctypes.c_int64, f32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, f32, ctypes.c_int64]
        lib.audioio_resample.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built (building it on the first call)."""
    return bool(_load())


def read_wav_native(path: str):
    """(mono float32 (T,), sample_rate), or None when the file does not
    decode or the library is unavailable."""
    lib = _load()
    if not lib:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    sr = ctypes.c_int32()
    if lib.audioio_load_wav(path.encode(), ctypes.byref(out), ctypes.byref(n),
                            ctypes.byref(sr)) != 0:
        return None
    try:
        arr = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        lib.audioio_free(out)
    return arr, int(sr.value)


def resample_native(x: np.ndarray, orig_freq: int, new_freq: int, *,
                    lowpass_filter_width: int = 6, rolloff: float = 0.99,
                    beta: float | None = None, window: str = "hann"):
    """Polyphase resampling in C++ with the numerics of
    :func:`genvc_tpu_torch.dsp.resample.resample_np`; None when the library
    is unavailable."""
    lib = _load()
    if not lib:
        return None
    kernels, width, orig_r, new_r = filters.resample_kernel(
        orig_freq, new_freq, lowpass_filter_width, rolloff, beta, window)
    x1 = np.ascontiguousarray(x.reshape(-1), np.float32)
    out_len = filters.resample_output_length(x1.shape[0], orig_freq, new_freq)
    out = np.empty(out_len, np.float32)
    kern = np.ascontiguousarray(kernels, np.float32)
    if lib.audioio_resample(x1, x1.shape[0], kern, kern.shape[0], kern.shape[1],
                            orig_r, width, out, out_len) != 0:
        return None
    return out


def load_audio_native(path: str, sampling_rate: int):
    """The native path of :func:`genvc_tpu_torch.dsp.audio_io.load_audio`,
    with its contract: (1, T) float32 clipped to [-1, 1], or None."""
    res = read_wav_native(path)
    if res is None:
        return None
    audio, sr = res
    if audio.shape[0] <= 10:
        return None
    if sr != sampling_rate:
        audio = resample_native(audio, sr, sampling_rate)
        if audio is None:
            return None
    if np.any(audio > 10) or not np.any(audio < 0):
        return None
    return np.clip(audio, -1.0, 1.0).astype(np.float32)[None, :]
