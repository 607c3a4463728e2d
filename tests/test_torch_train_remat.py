"""Activation checkpointing (``remat``) and the bf16 ContentVec
(``content_dtype``) of the port's GPT step, on the CPU at the small size of
``tests/test_torch_train.py`` (GPT 2 x 64 on the synthetic stage
checkpoints), and the training CLI's ``--remat`` / ``--content_bf16``.

Tolerances: with ``remat`` True or ``"dots"`` the loss, every gradient and
two whole steps' parameters are EQUAL to the step without it (the recompute
runs the same CPU arithmetic); against JAX's ``loss_fn(remat=...)`` (dense
attention) the loss within 3e-7 relative and every gradient within 3e-7
absolute (measured 2.0e-7 and 1.8e-7). The bf16 ContentVec's content codes
differ from JAX's bf16 path in no more places than JAX's bf16 codes differ
from its own f32 codes (measured 0 and 0 of 160; the features themselves
move ~1e-2 relative from f32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from genvc_tpu.models import gpt as jgpt
from genvc_tpu.train import gpt_stage as jstage
from genvc_tpu_torch.train import gpt_stage as tstage
from test_torch_train import GCFG, _batch, _frozen, _j, _leaf, _t, _torch_state, assets  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loss_and_grads(assets, feats, impl, remat):
    state = _torch_state(assets)
    loss, metrics = tstage.loss_fn(state.model, state.params.tensors(), feats, 0.01, 1.0,
                                   True, impl, remat)
    loss.backward()
    return float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, \
        state.params.flat.grad.clone(), state


@pytest.mark.parametrize("remat", [True, "dots"])
def test_torch_remat_equals_no_remat_and_matches_jax(assets, remat):
    _, tf = _frozen(assets)
    feats = tstage.prepare_features(tf, _t(_batch()))
    for impl in ("flash", "xla"):
        base = _loss_and_grads(assets, feats, impl, False)
        got = _loss_and_grads(assets, feats, impl, remat)
        assert got[0] == base[0] and got[1] == base[1], impl
        assert torch.equal(got[2], base[2]), impl
    jfeats = {k: jnp.asarray(v.numpy()) for k, v in feats.items()}
    params = jax.tree.map(jnp.asarray, assets[2])
    gcfg = jgpt.GPTConfig(**GCFG)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, f: jstage.loss_fn(p, gcfg, f, 0.01, 1.0, True, remat=remat,
                                    attn_impl="xla"), has_aux=True))(params, jfeats)
    assert abs(got[0] - float(jloss)) <= 3e-7 * abs(float(jloss))
    state = got[3]
    for n, g in state.params.views(got[2]).items():
        np.testing.assert_allclose(g.numpy(), _leaf(jgrads, n), rtol=0, atol=3e-7, err_msg=n)


@pytest.mark.parametrize("remat", [True, "dots"])
def test_torch_remat_train_steps_equal_no_remat(assets, remat):
    """Two whole steps (bf16 on f32 masters, the kernels' path): metrics and
    parameters equal to the steps without remat."""
    _, tf = _frozen(assets)
    batch = _t(_batch())
    runs = []
    for r in (False, remat):
        state = _torch_state(assets)
        step, _ = tstage.make_train_step(compute_dtype=torch.bfloat16, remat=r)
        metrics = []
        for _ in range(2):
            state, m = step(state, batch, tf)
            metrics.append({k: float(v) for k, v in m.items()})
        runs.append((metrics, state.params.flat.detach().clone()))
    assert runs[1][0] == runs[0][0]
    assert torch.equal(runs[1][1], runs[0][1])


def test_torch_content_bf16_code_flips_within_jax_own(assets):
    """``prepare_features(content_dtype=bf16)`` on a batch of 4 rows of 40
    content tokens: the codes' flips against JAX's bf16 path are no more
    than JAX's own bf16-vs-f32 flips; the acoustic labels stay f32 (equal to
    the f32 path's); the ContentVec really ran in bf16."""
    jf, tf = _frozen(assets)
    rng = np.random.default_rng(5)
    n = 40 * 1920
    batch = {"wav": (rng.standard_normal((4, 1, n)) * 0.1).astype(np.float32),
             "wav_lengths": np.full(4, n), "cond_lens": np.full(4, 24000),
             "conditioning": (rng.standard_normal((4, 1, 1, 24000)) * 0.1).astype(np.float32),
             "text_lengths": np.full(4, 40)}
    want16 = jax.jit(lambda f, b: jstage.prepare_features(f, b, jnp.bfloat16))(jf, _j(batch))
    want32 = jax.jit(jstage.prepare_features)(jf, _j(batch))
    got16 = tstage.prepare_features(tf, _t(batch), content_dtype=torch.bfloat16)
    got32 = tstage.prepare_features(tf, _t(batch))
    jax_flips = int((np.asarray(want16["text_inputs"]) != np.asarray(want32["text_inputs"])).sum())
    flips = int((got16["text_inputs"].numpy() != np.asarray(want16["text_inputs"])).sum())
    assert got16["text_inputs"].shape == (4, 40)
    assert flips <= jax_flips, (flips, jax_flips)
    assert torch.equal(got16["audio_codes"], got32["audio_codes"])
    np.testing.assert_array_equal(got16["audio_codes"].numpy(), np.asarray(want16["audio_codes"]))
    wav = torch.nn.functional.pad(torch.randn(2, 16000, generator=torch.Generator().manual_seed(0))
                                  * 0.1, (0, 320))
    f16, f32 = (tf.contentvec(wav, compute_dtype=dt) for dt in (torch.bfloat16, None))
    assert f16.dtype == f32.dtype == torch.float32
    rel = float((f16 - f32).abs().max() / f32.abs().max())
    assert 1e-4 < rel < 5e-2, rel
    assert tf.contentvec.final_proj.w.dtype == torch.float32  # the module stays f32


def test_torch_train_cli_runs_remat_and_content_bf16(tmp_path, monkeypatch, capsys):
    """``--remat 1`` and ``--remat dots --content_bf16`` train the 2-step
    smoke and exit 0 (they exited 2 before they were ported)."""
    from genvc_tpu_torch import train_genVC

    monkeypatch.chdir(tmp_path)
    for flags in (["--remat", "1"], ["--remat", "dots", "--content_bf16"]):
        assert train_genVC.main(["--smoke", "--device", "cpu", *flags]) == 0, flags
        assert "trained to step 2" in capsys.readouterr().out
        assert (tmp_path / "exp/smoke_gpt_torch/ckpt/2.pt").exists()
        (tmp_path / "exp/smoke_gpt_torch/ckpt/2.pt").unlink()
