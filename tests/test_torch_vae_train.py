"""dVAE training stage parity (stages 1-2), port vs JAX package on the CPU in
f32, at small size: ``forward_train`` (losses, reconstruction, codes, the
EMA codebook), two steps of each side's ``make_train_step`` for the Mel and
the ContentVec feature types, ``WaveformDVAEDataset.collate`` under one
``random.Random`` seed, the runner with its epoch-end plots and a resume,
and the two CLIs.

Both sides start from the port's init (``dvae.init_tree(trainable=True)``,
handed to JAX as numpy: JAX's own init compiles a program per random draw).

Tolerances (f32 on both sides, sums in other orders), relative to the
reference array's largest magnitude: codes identical; features 1e-5;
losses 1e-5 relative; reconstruction 1e-4; the EMA codebook 1e-5. After two
steps, with Adam's eps at EPS on both sides (see ``test_torch_train.py``):
metrics 1e-5 relative, parameters 2e-6 absolute (1 % of the 2e-4 two steps
of lr 1e-4 can move one), the codebook buffers 1e-5, moments 1e-2 of each
leaf's largest.
"""

import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from genvc_tpu.config import VAEConfig as JVAEConfig
from genvc_tpu.data.dataset import WaveformDVAEDataset as JDataset
from genvc_tpu.models import dvae as jdvae
from genvc_tpu.train import vae_stage as jvae
from genvc_tpu.train.runner import _load_contentvec
from genvc_tpu_torch import checkpoint as tck
from genvc_tpu_torch.config import VAEConfig
from genvc_tpu_torch.data.dataset import WaveformDVAEDataset
from genvc_tpu_torch.models import contentvec as tcv, dvae as tdvae
from genvc_tpu_torch.testing_synthetic import make_sine_dataset, write_stage_ckpts
from genvc_tpu_torch.train import loop, optim as toptim, vae_stage as tvae

EPS = 1e-3
SMALL = dict(num_tokens=32, codebook_dim=16, hidden_dim=8, num_resnet_blocks=1,
             num_layers=2, lr=1e-4, opt_betas=[0.5, 0.9], grad_clip_norm=0.5)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file's tests: the suite runs several files
    at once, one per core's worth of workers, and torch's thread pool spinning
    on a shared core slows every file far more than it speeds this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _assert_close(got, want, rel, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-30)
    assert err <= rel * scale, f"{name}: max |err| {err:.3e} > {rel} x {scale:.3e}"


def _model(channels, seed=0):
    """(port dVAE, its tree as numpy) from the port's init."""
    cfg = tdvae.DVAEConfig(channels=channels, **{k: SMALL[k] for k in (
        "num_tokens", "codebook_dim", "hidden_dim", "num_resnet_blocks", "num_layers")})
    tree = tdvae.init_tree(torch.Generator().manual_seed(seed), cfg, trainable=True)
    with torch.device("meta"):
        model = tdvae.DVAE(cfg, trainable=True)
    tck.assign(model, tree, "cpu")
    # a codebook that has seen data: the EMA's cluster sizes are not all zero
    model.codebook.cluster_size = torch.linspace(0.0, 3.0, cfg.num_tokens)
    return model, tck.export_tree(model)


def test_torch_dvae_forward_train_matches_jax():
    """Losses, reconstruction, codes and the EMA codebook (cluster sizes,
    sums, the Laplace-smoothed embedding)."""
    model, tree = _model(13)
    x = np.random.default_rng(0).standard_normal((3, 13, 32)).astype(np.float32)
    dcfg = jdvae.DVAEConfig(channels=13, **{k: SMALL[k] for k in (
        "num_tokens", "codebook_dim", "hidden_dim", "num_resnet_blocks", "num_layers")})
    jr, jc, jrec, jcb, jcodes = jax.jit(lambda p, v: jdvae.forward_train(p, v, dcfg))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    r, c, rec, cb, codes = model.forward_train(torch.from_numpy(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert float(r) == pytest.approx(float(jr), rel=1e-5)
    assert float(c) == pytest.approx(float(jc), rel=1e-5)
    _assert_close(rec.detach().numpy(), jrec, 1e-4, "recon")
    for k in ("embed", "cluster_size", "embed_avg"):
        _assert_close(cb[k].numpy(), jcb[k], 1e-5, k)
    # the decoder's inference form: codes -> reconstruction at 4x the rate
    want = np.asarray(jdvae.decode(jax.tree.map(jnp.asarray, tree), jcodes, dcfg))
    _assert_close(model.decode(codes).detach().numpy(), want, 1e-4, "decode")


@pytest.fixture(scope="module")
def contentvec_tree(tmp_path_factory):
    return _load_contentvec(write_stage_ckpts(str(tmp_path_factory.mktemp("cv")))
                            ["contentvec"])


def _feature_params(feat_type, cv_tree):
    """(JAX feat_params, port feat_params, channels)."""
    if feat_type == "Mel-spectrogram":
        norms = np.linspace(0.5, 1.5, 80).astype(np.float32)
        return jnp.asarray(norms), torch.from_numpy(norms), 80
    with torch.device("meta"):
        cv = tcv.ContentVec(n_layers=1)
    tck.assign(cv, jax.tree.map(np.asarray, cv_tree), "cpu")
    return cv_tree, cv.eval(), 256


@pytest.mark.parametrize("feat_type, rate, seconds", [("Mel-spectrogram", 24000, 0.5),
                                                      ("ContentVec", 16000, 0.6)])
def test_torch_vae_steps_match_jax(contentvec_tree, feat_type, rate, seconds):
    """Two steps of the port's ``make_train_step`` against JAX's on one
    batch (features identical in length, trimmed to a multiple of 4):
    metrics, every parameter, the codebook buffers (the EMA value, no
    gradient step) and Adam's moments; the eval step's losses."""
    jfp, tfp, ch = _feature_params(feat_type, contentvec_tree)
    audio = dict(sample_rate=rate, dvae_sample_rate=rate)
    jcfg = JVAEConfig(feat_type=feat_type, num_channels=ch, **SMALL)
    jcfg.audio.sample_rate = rate
    cfg = VAEConfig(feat_type=feat_type, num_channels=ch, **SMALL)
    for k, v in audio.items():
        setattr(cfg.audio, k, v)
    wav = (np.random.default_rng(1).standard_normal((2, 1, int(rate * seconds)))
           * 0.1).astype(np.float32)
    jfeat = np.asarray(jvae.make_feature_fn(jcfg)(jfp, jnp.asarray(wav)))
    feat = tvae.make_feature_fn(cfg)(tfp, torch.from_numpy(wav))
    assert feat.shape == jfeat.shape and feat.shape[-1] % 4 == 0
    _assert_close(feat.numpy(), jfeat, 1e-5, "features")

    model, tree = _model(ch, seed=3)
    tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip_norm),
                     optax.adam(cfg.lr, b1=cfg.opt_betas[0], b2=cfg.opt_betas[1], eps=EPS))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jvae.VAETrainState(jparams, tx.init(jparams), jnp.int32(0))
    jstep, jeval = jvae.make_train_step(jcfg, jvae.make_feature_fn(jcfg), tx)
    jstep = jax.jit(jstep)
    params = toptim.FlatParams(model)
    opt = toptim.AdamW(cfg.lr, tuple(cfg.opt_betas), EPS, 0.0, cfg.grad_clip_norm)
    state = tvae.VAETrainState(model, params, opt.init(params.flat))
    tstep, teval = tvae.make_train_step(tvae.make_feature_fn(cfg))
    batch = {"wav": wav}
    for _ in range(2):
        jstate, jm = jstep(jstate, {"wav": jnp.asarray(wav)}, jfp)
        state, m = tstep(state, {"wav": torch.from_numpy(wav)}, tfp)
        for k in jm:
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    assert state.step == 2 and opt.count == 2
    want = dict(_leaves(jax.tree.map(np.asarray, jstate.params)))
    got = dict(_leaves(tck.export_tree(model)))
    assert set(got) == set(want)
    for k, v in got.items():
        if k.startswith("codebook."):
            _assert_close(v, want[k], 1e-5, k)
        else:
            np.testing.assert_allclose(v, want[k], rtol=0, atol=2e-6, err_msg=k)
    adam = jstate.opt_state[1][0]
    for moment, jmom in ((opt.mu, adam.mu), (opt.nu, adam.nu)):
        jmom = dict(_leaves(jax.tree.map(np.asarray, jmom)))
        for k, v in params.views(moment).items():
            _assert_close(v.numpy(), jmom[k], 1e-2, k)
    em, jem = teval(state, {"wav": torch.from_numpy(wav)}, tfp), jeval(
        jstate.params, {"wav": jnp.asarray(wav)}, jfp)
    for k in jem:
        assert float(em[k]) == pytest.approx(float(jem[k]), rel=1e-5), k
    assert batch["wav"] is wav  # the step reads the batch, never writes it


def test_torch_vae_optimizer_is_the_recipe():
    """``make_optimizer``: clip at ``grad_clip_norm``, then plain Adam (no
    weight decay, eps 1e-8) at the config's lr and betas."""
    model, _ = _model(13)
    opt = tvae.make_optimizer(VAEConfig(num_channels=13, **SMALL), toptim.FlatParams(model))
    assert (opt.lr_schedule(0), (opt.b1, opt.b2), opt.eps, opt.weight_decay,
            opt.max_grad_norm) == (1e-4, (0.5, 0.9), 1e-8, 0.0, 0.5)
    assert opt.mu.shape == opt.nu.shape == (sum(p.numel() for p in model.parameters()),)


def test_torch_waveform_dvae_dataset_collate_matches_jax(tmp_path):
    """Shuffle, crop starts and the bucketed length under one seed; a short
    max length crops, a long one pads."""
    meta = make_sine_dataset(str(tmp_path), n=5, sr=16000, dur=1.2)
    for max_len in (16000, 48000):
        ds = WaveformDVAEDataset(meta, False, 16000, max_len, len_bucket=8000)
        jds = JDataset(meta, False, 16000, max_len, len_bucket=8000)
        assert ds.samples == jds.samples
        got = ds.collate([0, 2, 4], random.Random(3))
        want = jds.collate([0, 2, 4], random.Random(3))
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    assert got["wav"].shape == (3, 1, 24000)


# ------------------------------------------------------- runner and CLIs


def _cfg(out, content=False):
    """The CLI's ``--smoke`` configuration, run from the directory ``out``."""
    from genvc_tpu_torch.testing_synthetic import smoke_vae_overrides

    if content:
        from genvc_tpu_torch.train_content_dvae import recipe_config

        cfg = recipe_config("", "", "", output_path=os.path.join(
            out, "exp/smoke_content_dvae_torch"))
        smoke_vae_overrides(cfg, os.path.join(out, "exp/smoke_assets_cdvae_torch"))
    else:
        from genvc_tpu_torch.train_audio_dvae import recipe_config

        cfg = recipe_config("", "", None, output_path=os.path.join(
            out, "exp/smoke_audio_dvae_torch"))
        smoke_vae_overrides(cfg, os.path.join(out, "exp/smoke_assets_advae_torch"))
    return cfg


def _cli(module, out, argv):
    cwd = os.getcwd()
    os.chdir(out)
    try:
        return module.main(argv)
    finally:
        os.chdir(cwd)


def _run(cfg, **kw):
    from genvc_tpu_torch.train.runner import run_vae_training

    return run_vae_training(cfg, device="cpu", **kw)


@pytest.mark.parametrize("content", [False, True], ids=["audio", "content"])
def test_torch_dvae_cli_smoke_and_resume(tmp_path, content):
    """``python -m genvc_tpu_torch.train_audio_dvae | train_content_dvae
    --smoke --device cpu``: 2 steps and a checkpoint at step 2; the runner on
    the same configuration resumes there and trains no further, and with
    max_steps 3 takes one more step from the restored state."""
    from genvc_tpu_torch import train_audio_dvae, train_content_dvae

    module = train_content_dvae if content else train_audio_dvae
    assert _cli(module, str(tmp_path), ["--smoke", "--device", "cpu"]) == 0
    cfg = _cfg(str(tmp_path), content)
    ckpt = loop.CheckpointManager(os.path.join(cfg.output_path, "ckpt"))
    assert ckpt.steps() == [2]
    saved, _ = ckpt.restore()
    assert sorted(saved["params"]["codebook"]) == ["cluster_size", "embed", "embed_avg"]
    again = _run(cfg, max_steps=2)
    assert again.step == 2 and again.opt.count == 2
    np.testing.assert_array_equal(tck.export_tree(again.model)["codebook"]["embed"],
                                  saved["params"]["codebook"]["embed"])
    more = _run(cfg, max_steps=3)
    assert more.step == 3 and ckpt.steps() == [2, 3]
    assert not torch.equal(more.params.flat, again.params.flat)
    assert not torch.equal(more.model.codebook.cluster_size, again.model.codebook.cluster_size)


def test_torch_vae_runner_epoch_end_plots(tmp_path):
    """A whole epoch (4 steps of 2 of the 8 wavs): the eval pass is logged
    and the first eval batch's input and reconstruction are plotted."""
    pytest.importorskip("matplotlib")
    cfg = _cfg(str(tmp_path))
    state = _run(cfg)
    assert state.step == 4
    with open(os.path.join(cfg.output_path, "train_log.jsonl")) as f:
        assert "Eval_avg_recon_loss" in f.read().splitlines()[-1]
    for name in ("e0_input.png", "e0_recon.png"):
        assert os.path.getsize(os.path.join(cfg.output_path, "eval_plots", name)) > 0


def test_torch_dvae_clis_need_a_card(tmp_path):
    """Without ``--device cpu`` each CLI asks for CUDA and, with no card,
    stops with a message; neither falls back to the CPU."""
    from genvc_tpu_torch import train_audio_dvae, train_content_dvae

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for module in (train_audio_dvae, train_content_dvae):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _cli(module, str(tmp_path), ["--smoke"])
