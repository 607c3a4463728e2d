"""Host audio IO of the port against the JAX package: ``load_audio`` on the
repo's sample wavs (96 kHz PCM32) and on a 24 kHz stereo int16 wav, whole
and cut to 6, 20 and 40 bytes (inside the header) and to half their bytes
(inside the data chunk), at 16 and 24 kHz; the native binding
(``data/native_audio.py``) against the JAX package's; and the input edge
cases of ``tests/test_edge_cases.py`` on the port's pipeline (the synthetic
bundle, f32, CPU).

Tolerances: the same ``None`` sentinels and shapes; values within 1e-6 (the
native resampler and the numpy one sum the same f32 products in other
orders: 6e-8 to 1.2e-7 apart on the samples); the native decode and
resample of both bindings, which run one library's code, bit-equal.
"""

import os
import wave

import numpy as np
import pytest
import torch

from genvc_tpu.data import native_audio as jnative
from genvc_tpu.dsp import audio_io as jaudio
from genvc_tpu_torch.data import native_audio as tnative
from genvc_tpu_torch.dsp import audio_io as taudio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = [os.path.join(ROOT, "samples", f)
           for f in ("EF4_ENG_0112_1.wav", "EM1_ENG_0037_1.wav")]
CUTS = (6, 20, 40, "half")


def _write_pcm16(path, data, sr, channels):
    with wave.open(path, "wb") as wf:
        wf.setnchannels(channels)
        wf.setsampwidth(2)
        wf.setframerate(sr)
        wf.writeframes(data.tobytes())


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """{name: path}: the samples and a 1 s 24 kHz stereo int16 wav (96044
    bytes), each whole and cut."""
    d = tmp_path_factory.mktemp("audio_io")
    rng = np.random.default_rng(0)
    stereo = str(d / "stereo24k.wav")
    _write_pcm16(stereo, (rng.standard_normal((24000, 2)) * 0.2 * 32767).clip(
        -32767, 32767).astype(np.int16), 24000, 2)
    out = {}
    for src in SAMPLES + [stereo]:
        data = open(src, "rb").read()
        name = os.path.basename(src)[:-4]
        out[name] = src
        for cut in CUTS:
            n = len(data) // 2 if cut == "half" else cut
            path = str(d / f"{name}_cut{n}.wav")
            with open(path, "wb") as f:
                f.write(data[:n])
            out[f"{name}_cut{cut}"] = path
    return out


def _hold(name, got, want):
    if want is None:
        assert got is None, name
        return
    assert got is not None and got.shape == want.shape and got.dtype == np.float32, name
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("sr", [16000, 24000])
def test_torch_load_audio_matches_jax(wavs, sr):
    """Whole files and header cuts: the same arrays or ``None`` as the JAX
    package's loader (native first on both sides where built, else numpy)."""
    for name, path in wavs.items():
        if name.endswith("_cuthalf"):
            continue
        _hold((name, sr), taudio.load_audio(path, sr), jaudio.load_audio(path, sr))
        if "_cut" in name:
            assert taudio.load_audio(path, sr) is None, (name, sr)


def test_torch_load_audio_numpy_path_matches_jax(wavs, monkeypatch):
    """Without the native library both loaders take numpy: the same arrays
    or ``None`` on every file and cut (a data chunk cut short is ``None`` on
    this path: scipy and ``wave`` both refuse it)."""
    monkeypatch.setattr(tnative, "_lib", False)
    monkeypatch.setattr(jnative, "_lib", False)
    for name, path in wavs.items():
        for sr in (16000, 24000):
            _hold((name, sr), taudio.load_audio(path, sr), jaudio.load_audio(path, sr))


def test_torch_read_wav_falls_back_to_wave(wavs, monkeypatch):
    """scipy's reader failing, ``read_wav`` reads 16-bit PCM with the stdlib
    ``wave`` module, as the JAX package's does."""
    from scipy.io import wavfile

    path = wavs["stereo24k"]
    want = jaudio.read_wav(path)

    def refuse(*a, **k):
        raise ValueError("refused")

    monkeypatch.setattr(wavfile, "read", refuse)
    got, sr = taudio.read_wav(path)
    assert sr == want[1] == 24000 and got.shape == (2, 24000)
    np.testing.assert_array_equal(got, jaudio.read_wav(path)[0])
    np.testing.assert_array_equal(got, want[0])


def _native_or_skip():
    """Both bindings' libraries, built here in the test (never at
    collection); skip when either does not build."""
    if not (tnative.available() and jnative.available()):
        pytest.skip("the native audio library does not build here")


def test_torch_native_load_audio_of_cut_data_chunk_matches_jax(wavs):
    """Fault C.6's input: a data chunk cut in half loads through the native
    path in both packages, (1, 7996) at 16 kHz and (1, 11994) at 24 kHz for
    the stereo wav; the header cuts are ``None`` on the native path too."""
    _native_or_skip()
    for sr, n in ((16000, 7996), (24000, 11994)):
        got = taudio.load_audio(wavs["stereo24k_cuthalf"], sr)
        assert got is not None and got.shape == (1, n), (sr, got)
    for name, path in wavs.items():
        for sr in (16000, 24000):
            want = jaudio.load_audio(path, sr)
            _hold((name, sr), taudio.load_audio(path, sr), want)
            _hold((name, sr, "native"), tnative.load_audio_native(path, sr),
                  jnative.load_audio_native(path, sr))
            if name.endswith(("_cut6", "_cut20", "_cut40")):
                assert tnative.load_audio_native(path, sr) is None


def test_torch_native_read_and_resample_match_jax(wavs):
    """``read_wav_native`` and ``resample_native`` bit-equal to the JAX
    binding's (one C++ source); the resampler within 1e-6 of numpy's; the
    library named by a digest of its source under the port's ``_build``."""
    _native_or_skip()
    from genvc_tpu_torch.dsp.resample import resample_np

    for name in ("EF4_ENG_0112_1", "stereo24k", "stereo24k_cuthalf"):
        got, want = tnative.read_wav_native(wavs[name]), jnative.read_wav_native(wavs[name])
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
    x = np.random.default_rng(1).standard_normal(9601).astype(np.float32)
    for orig, new in ((24000, 16000), (96000, 24000), (16000, 24000)):
        got = tnative.resample_native(x, orig, new)
        np.testing.assert_array_equal(got, jnative.resample_native(x, orig, new))
        np.testing.assert_allclose(got, resample_np(x[None], orig, new)[0], rtol=0, atol=1e-6)
    kaiser = dict(lowpass_filter_width=64, rolloff=0.9475937167399596,
                  beta=14.769656459379492, window="kaiser")
    np.testing.assert_array_equal(tnative.resample_native(x, 24000, 16000, **kaiser),
                                  jnative.resample_native(x, 24000, 16000, **kaiser))
    path = tnative.lib_path()
    assert os.path.dirname(path) == tnative.BUILD_DIR and os.path.exists(path)


# ------------------------------------------------------ the input edge cases


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    from synthetic_bundle import write_bundle
    from genvc_tpu_torch.inference import pipeline as tpipe

    path = str(tmp_path_factory.mktemp("edge") / "tiny.pth")
    write_bundle(path)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    p = tpipe.model_init(path, device="cpu")
    p.gen_cap_tokens_per_code = 1.0
    yield p
    torch.set_num_threads(n)


def test_torch_sub_min_chunk_source(pipe):
    """A 0.1 s source (below the 0.32 s minimum chunk) synthesizes finite
    audio, offline and streaming."""
    rng = np.random.default_rng(31)
    src = (rng.standard_normal((1, 1600)) * 0.1).astype(np.float32)
    ref = (rng.standard_normal((1, 24000)) * 0.1).astype(np.float32)
    wav = pipe.synthesize(src, ref)
    assert wav.ndim == 1 and np.all(np.isfinite(wav))
    wav_s, latency, rtf = pipe.synthesize_streaming(src, ref, verbose=False)
    assert np.all(np.isfinite(wav_s)) and latency > 0 and rtf > 0


@pytest.mark.parametrize("seconds,kept", [(40.0, 30.0), (6.1, 6.0)])
def test_torch_reference_cut_to_its_chunks(pipe, seconds, kept):
    """A 40 s reference gives the latents of its first 30 s (the 30 s cap);
    6.1 s those of its first 6 s (a chunk under 0.33 s is skipped)."""
    rng = np.random.default_rng(32)
    sr = pipe.sample_rate
    ref = (rng.standard_normal((1, int(sr * seconds))) * 0.1).astype(np.float32)
    lat = np.asarray(pipe.get_gpt_cond_latents(ref).cpu())
    lat_kept = np.asarray(pipe.get_gpt_cond_latents(ref[:, : int(sr * kept)]).cpu())
    assert lat.shape == (1, 32, 64)
    np.testing.assert_allclose(lat, lat_kept, rtol=1e-5, atol=1e-5)


def test_torch_load_audio_stereo_monoizes_and_missing_is_none(tmp_path):
    rng = np.random.default_rng(34)
    sr = 24000
    left = (rng.standard_normal(sr) * 3000).astype(np.int16)
    right = (rng.standard_normal(sr) * 3000).astype(np.int16)
    inter = np.empty((sr * 2,), np.int16)
    inter[0::2], inter[1::2] = left, right
    path = str(tmp_path / "stereo.wav")
    _write_pcm16(path, inter, sr, channels=2)
    wav = taudio.load_audio(path, sr)
    assert wav is not None and wav.shape == (1, sr)
    want = (left.astype(np.float32) + right.astype(np.float32)) / 2 / 32768.0
    np.testing.assert_allclose(wav[0], want, atol=1e-4)
    assert taudio.load_audio(str(tmp_path / "missing.wav"), sr) is None
