"""Mel inversion of the listening samples, port vs JAX package on the CPU:
``invert_mel`` on a seeded normalized log-mel, and ``griffin_lim`` on a
seeded magnitude with a window shorter than the FFT (zero-padded, as there).

Both sides compute in float64 from the same initial phases (numpy's
``default_rng(0)``) and return float32: the waveforms agree within 1e-6
absolute (measured 1.5e-8, the output's f32 rounding; the overlap-add sums
in other orders)."""

import numpy as np
import pytest
import torch

from genvc_tpu.dsp import griffinlim as jgl
from genvc_tpu_torch.dsp import griffinlim as tgl


@pytest.mark.parametrize("n_iter", [0, 64])
def test_torch_invert_mel_matches_jax(n_iter):
    rng = np.random.default_rng(0)
    mel = (rng.standard_normal((80, 40)) * 0.5 - 2).astype(np.float32)
    norms = rng.uniform(0.5, 1.5, 80).astype(np.float32)
    want = jgl.invert_mel(mel, norms, n_iter=n_iter)
    got = tgl.invert_mel(torch.from_numpy(mel), torch.from_numpy(norms), n_iter=n_iter)
    assert got.dtype == np.float32 and got.shape == want.shape == (39 * 256,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_torch_griffin_lim_short_window_matches_jax():
    rng = np.random.default_rng(1)
    mag = np.abs(rng.standard_normal((257, 12)))
    want = jgl.griffin_lim(mag, 512, 128, 400, n_iter=8)
    got = tgl.griffin_lim(torch.from_numpy(mag), 512, 128, 400, n_iter=8)
    assert got.shape == want.shape == (11 * 128,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
