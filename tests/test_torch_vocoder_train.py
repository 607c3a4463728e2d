"""Vocoder (HiFi-GAN) training stage parity, port vs JAX package on the CPU
in f32, at small size: the vocoder-loss mel, the MS-STFT front end and the
CQT; each discriminator family's logits, feature maps, gradients on y and
y_hat and spectral-norm buffers; the GAN losses; ``prepare_vocoder_batch``;
two GAN steps over MSD + MPD against JAX's ``make_split_steps(families=...)``
(its fused-update program, equal to the fused step by construction); the
runner with a resume, the CLI, and the export of a trained generator into
the inference pipeline.

The JAX side is jitted and compiled once per function in module-scoped
fixtures. MSD and MPD run at their fixed reference widths; the STFT and CQT
families at ``VocoderConfig``'s smallest filters (4) and one CQT scale of 5
octaves x 12 bins, as the JAX package's own GAN-step test.

Tolerances (f32 on both sides, sums in other orders), each relative to the
largest magnitude of the reference array unless stated: front ends 2e-5;
discriminator logits and feature maps 1e-4; their input gradients 5e-3: against
a float64 run of the port, the JAX package's f32 gradients on this CPU lie
1.7e-3 off (MPD; the port's own f32 6e-7) and the port's 9e-4 (MSD), through
eight stacked convolutions and their transposes; spectral-norm buffers 1e-5.
After two GAN steps, with Adam's eps at EPS on both sides (see
``test_torch_train.py``): metrics 1e-5 relative (measured 1.2e-7);
parameters 4e-6 absolute, 1 % of the 4e-4 that two steps of lr 2e-4 can
move one (measured 3.1e-7 generator, 6.9e-7 discriminators); spectral-norm
buffers 2e-5 (2.7e-6); both optimizers' moments 1e-2 of each leaf's largest
(9.0e-4 generator, 3.2e-3 discriminators): the gradients run back through
up to eight stacked convolutions, and the port's own f32 generator gradient
lies 2.3e-3 off its float64 one.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from genvc_tpu.config import GenVCConfig as JConfig, VocoderConfig as JVocoderConfig
from genvc_tpu.dsp import cqt as jcqt, mel as jmel
from genvc_tpu.models import gpt as jgpt, hifigan as jhg
from genvc_tpu.train import gpt_stage as jstage, losses as jlosses, vocoder_stage as jvs
from genvc_tpu.train.runner import _load_contentvec, _load_dvae
from genvc_tpu_torch import checkpoint as tck
from genvc_tpu_torch.config import GenVCConfig as TConfig, VocoderConfig
from genvc_tpu_torch.dsp import cqt as tcqt, mel as tmel
from genvc_tpu_torch.models import hifigan as thg
from genvc_tpu_torch.ops.conv import linear_interp_x4, reset_convs
from genvc_tpu_torch.testing_synthetic import write_stage_ckpts
from genvc_tpu_torch.train import (gpt_stage as tstage, losses as tlosses, loop,
                                   optim as toptim, vocoder_stage as tvs)

EPS = 1e-3
SMALL = dict(input_feat_dim=64, upsample_initial_channel=16, msstftd_filters=4,
             mssbcqtd_filters=4, mssbcqtd_hop_lengths=[512], mssbcqtd_n_octavess=[5],
             mssbcqtd_bins_per_octave=[12])
MSD_MPD = ("MSD_Discriminator", "MPD_Discriminator")



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file's tests: the suite runs several files
    at once, one per core's worth of workers, and torch's thread pool spinning
    on a shared core slows every file far more than it speeds this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_close(got, want, rel, name=""):
    """|got - want| <= rel * max|want| (elementwise, over the whole array)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{name}: max |err| {err:.3e} > {rel} x {scale:.3e}"


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _wavs(seed=0, t=8192, b=2):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, 1, t)) * 0.1).astype(np.float32) for _ in range(2)]


# ----------------------------------------------------------------- front ends


def test_torch_mel_vocoder_loss_and_stft_match_jax():
    """100 mels up to 12 kHz (the vocoder loss's), and the MS-STFT
    discriminator's three resolutions."""
    x = _wavs(1, t=6000)[0][:, 0]
    cfg = VocoderConfig()
    spec = dict(sample_rate=cfg.sample_rate, n_fft=cfg.fft_size, win_length=cfg.win_length,
                hop_length=cfg.hop_length, n_mels=cfg.num_mels, fmin=cfg.mel_fmin,
                fmax=cfg.mel_fmax, scale="slaney")
    want = np.asarray(jax.jit(lambda v: jmel.mel_vocoder_loss(v, jmel.MelSpec(**spec)))(x))
    got = tmel.mel_vocoder_loss(torch.from_numpy(x), tmel.MelSpec(**spec)).numpy()
    assert got.shape == want.shape == (2, 100, 1 + (6000 + 768 - 1024) // 256)
    _assert_close(got, want, 2e-5, "mel_vocoder_loss")
    for s in thg.MSSTFTD_SPECS:
        jre, jim = jmel.stft_complex(jnp.asarray(x), s["n_fft"], s["hop"], s["win"])
        tre, tim = tmel.stft_complex(torch.from_numpy(x), s["n_fft"], s["hop"], s["win"])
        _assert_close(tre.numpy(), jre, 2e-5, f"stft re {s['n_fft']}")
        _assert_close(tim.numpy(), jim, 2e-5, f"stft im {s['n_fft']}")
    assert tmel.num_frames_center(6000, 256) == jmel.num_frames_center(6000, 256)


@pytest.mark.parametrize("hop, n_oct, bins", [(512, 5, 12), (256, 9, 24)])
def test_torch_cqt2010_matches_jax(hop, n_oct, bins):
    """The octave cascade at the small scale and at the recipe's second one
    (the reference's x2 resample first, as the discriminator does)."""
    x = np.repeat(_wavs(2, t=4096)[0][:, 0], 2, axis=-1)
    re, im = tcqt.top_octave_kernels(48000, 32.703195662574764 * 2 ** n_oct, bins)
    jre, jim = jcqt.top_octave_kernels(48000, 32.703195662574764 * 2 ** n_oct, bins)
    np.testing.assert_array_equal(re, jre)
    np.testing.assert_array_equal(im, jim)
    want = np.asarray(jax.jit(lambda v: jcqt.cqt2010(v, 48000, hop, n_oct, bins))(x))
    got = tcqt.cqt2010(torch.from_numpy(x), 48000, hop, n_oct, bins).numpy()
    assert got.shape == want.shape and got.shape[1] == n_oct * bins
    _assert_close(got, want, 2e-5, "cqt2010")


# ------------------------------------------------------------- discriminators


def _cqt_statics(cfg):
    """``hifigan.init_mssbcqtd``'s statics, without its random draws."""
    return [{"sample_rate": cfg.sample_rate, "hop": hop, "n_octaves": n_oct, "bins": bins,
             "dilations": tuple(cfg.mssbcqtd_dilations), "kernel": (3, 9)}
            for hop, n_oct, bins in zip(cfg.mssbcqtd_hop_lengths, cfg.mssbcqtd_n_octavess,
                                        cfg.mssbcqtd_bins_per_octave)]


def _family(name):
    """(JAX params, port module, JAX loss fn) of one family at small size."""
    jcfg, cfg = JVocoderConfig(**SMALL), VocoderConfig(**SMALL)
    if name == "msd":
        mod = thg.MultiScaleDiscriminator()
        fwd = lambda p, y, yh: jhg.msd_forward(p, y, yh, sn_update=True)
    elif name == "mpd":
        mod = thg.MultiPeriodDiscriminator(tuple(cfg.mpd_reshapes), use_spectral_norm=True)
        fwd = lambda p, y, yh: jhg.mpd_forward(p, y, yh, periods=tuple(jcfg.mpd_reshapes),
                                               sn_update=True)
    elif name == "msstftd":
        mod = thg.MultiScaleSTFTDiscriminator(cfg.msstftd_filters)
        fwd = lambda p, y, yh: (*jhg.msstftd_forward(p, y, yh), p)
    else:
        mod = thg.MultiScaleSubbandCQTDiscriminator(cfg)
        statics = _cqt_statics(jcfg)
        fwd = lambda p, y, yh: (*jhg.mssbcqtd_forward(p, statics, y, yh), p)
    # the parameters reach JAX as numpy: JAX's own init runs op by op and
    # compiles a program for each random draw, tens of seconds on a cold cache
    jp = jax.tree.map(jnp.asarray, tck.export_tree(reset_convs(mod, torch.Generator()
                                                                .manual_seed(7))))

    def loss(y, yh, p):
        lr, lg, fr, fg, newp = fwd(p, y, yh)
        total = (jlosses.discriminator_loss(lr, lg) + jlosses.feature_loss(fr, fg)
                 + jlosses.generator_adv_loss(lg))
        return total, (lr, lg, fr, fg, newp)

    return jp, mod, jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))


@pytest.mark.parametrize("name", ["msd", "mpd", "msstftd", "mssbcqtd"])
def test_torch_discriminator_family_matches_jax(name):
    """Logits and feature maps of both inputs, the gradients of the summed GAN
    losses on y and y_hat, and the spectral-norm buffers after one
    ``sn_update`` forward (MSD's first scale; MPD built spectral here). The
    families' lengths: MPD pads 4094 samples to each period by reflection."""
    y, yh = _wavs(3, t=4094)
    jp, mod, jfn = _family(name)
    (jloss, (jlr, jlg, jfr, jfg, jnew)), (jgy, jgyh) = jfn(y, yh, jp)
    ty, tyh = (torch.from_numpy(v).requires_grad_(True) for v in (y, yh))
    lr, lg, fr, fg = mod(ty, tyh, sn_update=True)
    loss = (tlosses.discriminator_loss(lr, lg) + tlosses.feature_loss(fr, fg)
            + tlosses.generator_adv_loss(lg))
    loss.backward()
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    for got, want, what in ((lr, jlr, "logits_r"), (lg, jlg, "logits_g")):
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_close(a.detach().numpy(), b, 1e-4, f"{name} {what}[{i}]")
    for got, want, what in ((fr, jfr, "fmap_r"), (fg, jfg, "fmap_g")):
        for i, (da, db) in enumerate(zip(got, want)):
            assert len(da) == len(db)
            for j, (a, b) in enumerate(zip(da, db)):
                _assert_close(a.detach().numpy(), b, 1e-4, f"{name} {what}[{i}][{j}]")
    _assert_close(ty.grad.numpy(), jgy, 5e-3, f"{name} dL/dy")
    _assert_close(tyh.grad.numpy(), jgyh, 5e-3, f"{name} dL/dy_hat")
    want_tree = dict(_leaves(_np(jnew)))
    got_tree = dict(_leaves(tck.export_tree(mod)))
    assert set(got_tree) == set(want_tree)
    n_sn = 0
    for k, v in got_tree.items():
        if k.endswith((".u", ".pv")):
            n_sn += 1
            _assert_close(v, want_tree[k], 1e-5, k)
    assert n_sn == {"msd": 16, "mpd": 60}.get(name, 0)


def test_torch_gan_losses_match_jax():
    rng = np.random.default_rng(5)
    lr = [rng.standard_normal((2, n)).astype(np.float32) for n in (7, 3)]
    lg = [rng.standard_normal((2, n)).astype(np.float32) for n in (7, 3)]
    fr = [[rng.standard_normal((2, 4, n)).astype(np.float32) for n in (9, 5)]]
    fg = [[rng.standard_normal((2, 4, n)).astype(np.float32) for n in (9, 5)]]
    t = lambda xs: jax.tree.map(torch.from_numpy, xs)
    for name, args in (("discriminator_loss", (lr, lg)), ("generator_adv_loss", (lg,)),
                       ("feature_loss", (fr, fg))):
        want = float(getattr(jlosses, name)(*args))
        assert float(getattr(tlosses, name)(*map(t, args))) == pytest.approx(want, rel=1e-6)
    y, yh = (v[:, 0] for v in _wavs(6, t=5000))
    want = float(jlosses.mel_loss(y, yh, JVocoderConfig()))
    got = float(tlosses.mel_loss(torch.from_numpy(y), torch.from_numpy(yh), VocoderConfig()))
    assert got == pytest.approx(want, rel=1e-5)


# ---------------------------------------------------------------- the step


GCFG = dict(layers=2, model_dim=64, heads=4)


def _shrink(cfg):
    for c, ch, nt in ((cfg.acoustic_dvae_config, 80, 64), (cfg.content_dvae_config, 256, 36)):
        c.num_channels, c.num_tokens, c.hidden_dim, c.codebook_dim = ch, nt, 16, 24
        c.num_resnet_blocks = 3
    return cfg


@pytest.fixture(scope="module")
def stage(tmp_path_factory):
    """The synthetic stage checkpoints through each side's loaders, both
    sides' frozen modules and GPT, and a batch of 2 (2 and 1 content tokens,
    the second row zero past its length; 4 audio codes)."""
    paths = write_stage_ckpts(str(tmp_path_factory.mktemp("stage")))
    ones = np.ones(80, np.float32)
    jf = jstage.make_frozen(_shrink(JConfig()), {
        "contentvec": _load_contentvec(paths["contentvec"]),
        "acoustic_dvae": _load_dvae(paths["acoustic_dvae"]),
        "content_dvae": _load_dvae(paths["content_dvae"])}, ones)
    tf = tstage.make_frozen(_shrink(TConfig()), {
        "contentvec": tck.load_contentvec(paths["contentvec"]),
        "acoustic_dvae": tck.load_dvae(paths["acoustic_dvae"]),
        "content_dvae": tck.load_dvae(paths["content_dvae"])}, ones, "cpu")
    gpt_tree = tck.load_gpt(paths["gpt"], GCFG["layers"])
    with torch.device("meta"):
        gpt = tstage.gpt_model.GPT(tstage.gpt_model.GPTConfig(**GCFG))
    tck.assign(gpt, gpt_tree, "cpu")
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((2, 1, 2 * 1920)) * 0.1).astype(np.float32)
    wav[1, :, 1920:] = 0
    batch = {"wav": wav, "wav_lengths": np.asarray([2 * 1920, 1920]),
             "conditioning": (rng.standard_normal((2, 1, 1, 24000)) * 0.1).astype(np.float32),
             "cond_lens": np.asarray([24000, 18000]), "text_lengths": np.asarray([2, 1])}
    return {"jf": jf, "tf": tf, "gpt_tree": gpt_tree, "gpt": gpt.eval(), "batch": batch,
            "jbatch": {k: jnp.asarray(v) for k, v in batch.items()},
            "tbatch": {k: torch.from_numpy(v) for k, v in batch.items()}}


def test_torch_prepare_vocoder_batch_matches_jax(stage):
    """The frozen GPT's latents (the ``+ stride // 2`` length fudge, trimmed
    to the code count) and the wav padded to codes x 1024."""
    jlat, jwav = jax.jit(lambda b, f, p: jvs.prepare_vocoder_batch(
        f, p, jgpt.GPTConfig(**GCFG), b))(stage["jbatch"], stage["jf"],
                                           jax.tree.map(jnp.asarray, stage["gpt_tree"]))
    lat, wav = tvs.prepare_vocoder_batch(stage["tf"], stage["gpt"], stage["tbatch"])
    assert lat.shape == jlat.shape and lat.shape[1] * 1024 == wav.shape[-1] == 4096
    _assert_close(lat.numpy(), jlat, 1e-5, "latents")
    np.testing.assert_array_equal(wav.numpy(), np.asarray(jwav))
    assert not wav[:, :, 2 * 1920:].any()  # padded past the 3840 samples


def _opt_leaves(opt_state):
    """mu and nu of an ``optax.adamw`` state (ScaleByAdamState first)."""
    adam = opt_state[0]
    return dict(_leaves(_np(adam.mu))), dict(_leaves(_np(adam.nu)))


def test_torch_gan_step_matches_jax_split_step(stage):
    """Two GAN steps over MSD + MPD from one state: the discriminators step
    on a detached prediction, the generator against the updated ones.
    Metrics, the generator's and every discriminator's parameters (STFT and
    CQT only decay, their gradients being zero), both optimizers' moments,
    and the spectral-norm buffers that both phases advance (four power
    iterations a step on each of MSD's first-scale convs)."""
    jcfg, cfg = JVocoderConfig(**SMALL), VocoderConfig(**SMALL)
    gen_tree = thg.generator_to_weight_norm(
        thg.init_tree(torch.Generator().manual_seed(4), cfg))
    disc_tree = tck.export_tree(tvs.init_discriminators(torch.Generator().manual_seed(5), cfg))
    gen_tree, disc_tree = (jax.tree.map(lambda t: jnp.asarray(np.asarray(t)), x)
                           for x in (gen_tree, disc_tree))
    statics = _cqt_statics(jcfg)
    tx = lambda: optax.adamw(2e-4, b1=0.8, b2=0.99, eps=EPS, weight_decay=0.01)
    gen_tx, disc_tx = tx(), tx()
    jstate = jvs.VocoderTrainState(gen_tree, disc_tree, gen_tx.init(gen_tree),
                                   disc_tx.init(disc_tree), jnp.int32(0))
    jstep, _ = jvs.make_split_steps(jgpt.GPTConfig(**GCFG), jcfg, statics, gen_tx, disc_tx,
                                    families=MSD_MPD)
    jgpt_params = jax.tree.map(jnp.asarray, stage["gpt_tree"])

    with torch.device("meta"):
        generator = thg.Generator(cfg, weight_norm=True)
        discs = thg.Discriminators(cfg)
    tck.assign(generator, _np(gen_tree), "cpu")
    tck.assign(discs, _np(disc_tree), "cpu")
    gp, dp = toptim.FlatParams(generator), toptim.FlatParams(discs)
    opt = lambda p: toptim.AdamW(2e-4, (0.8, 0.99), EPS, 0.01, None).init(p.flat)
    state = tvs.VocoderTrainState(generator, discs, gp, dp, opt(gp), opt(dp))
    tstep, teval = tvs.make_train_step(cfg, families=MSD_MPD)
    sn0 = discs.msd.discs[0].convs[0].u.clone()
    for _ in range(2):
        jstate, jm = jstep(jstate, stage["jbatch"], stage["jf"], jgpt_params)
        state, m = tstep(state, stage["tbatch"], stage["tf"], stage["gpt"])
        for k in ("loss_disc", "loss_gen", "mel_loss"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    assert state.step == 2 and state.gen_opt.count == state.disc_opt.count == 2
    assert not torch.equal(sn0, discs.msd.discs[0].convs[0].u)
    for mod, params, opt_, jtree, jopt in (
            (generator, gp, state.gen_opt, jstate.gen_params, jstate.gen_opt),
            (discs, dp, state.disc_opt, jstate.disc_params, jstate.disc_opt)):
        want = dict(_leaves(_np(jtree)))
        got = dict(_leaves(tck.export_tree(mod)))
        assert set(got) == set(want)
        for k, v in got.items():
            if k.endswith((".u", ".pv")):
                _assert_close(v, want[k], 2e-5, k)
            else:
                err = float(np.abs(v - want[k]).max())
                assert err <= 4e-6, f"{k}: max |err| {err:.3e} > 4e-6"
        jmu, jnu = _opt_leaves(jopt)
        for moment, jmom in ((opt_.mu, jmu), (opt_.nu, jnu)):
            for k, v in params.views(moment).items():
                _assert_close(v.numpy(), jmom[k], 1e-2, k)
        # the buffers' moments stay zero in optax's state: no gradient
        assert all(not jmu[k].any() for k in jmu if k.endswith((".u", ".pv")))
    em = teval(state, stage["tbatch"], stage["tf"], stage["gpt"])
    assert np.isfinite(float(em["loss_disc"])) and np.isfinite(float(em["mel_loss"]))


def test_torch_gan_step_refuses_unknown_families():
    with pytest.raises(ValueError, match="families"):
        tvs.make_train_step(VocoderConfig(**SMALL), families=("MSD",))


def test_torch_bf16_discriminators_run_near_f32(stage):
    """``disc_dtype=bf16`` (the CLI's ``--bf16_discs``): the masters stay
    f32, the step's losses are finite and within a few percent of the f32
    step's (here over the STFT and CQT families, whose f32 front ends feed
    bf16 conv stacks); MSD and MPD run their conv stacks in bf16 too."""
    cfg = VocoderConfig(**SMALL)
    families = ("MSTFT_Discriminator", "MSCQT_Discriminator")
    out = []
    for dt in (None, torch.bfloat16):
        gen = torch.Generator().manual_seed(0)
        with torch.device("meta"):
            generator = thg.Generator(cfg, weight_norm=True)
        tck.assign(generator, thg.generator_to_weight_norm(thg.init_tree(gen, cfg)), "cpu")
        discs = tvs.init_discriminators(gen, cfg)
        gp, dp = toptim.FlatParams(generator), toptim.FlatParams(discs)
        opts = [toptim.vocoder_adamw(2e-4).init(p.flat) for p in (gp, dp)]
        state = tvs.VocoderTrainState(generator, discs, gp, dp, *opts)
        step, _ = tvs.make_train_step(cfg, disc_dtype=dt, families=families)
        state, m = step(state, stage["tbatch"], stage["tf"], stage["gpt"])
        assert dp.flat.dtype == torch.float32
        out.append({k: float(v) for k, v in m.items()})
    for k in out[0]:
        assert np.isfinite(out[1][k]) and out[1][k] == pytest.approx(out[0][k], rel=5e-2), k
    y = torch.from_numpy(_wavs(8, t=660)[0])
    outs = discs(y, y, torch.bfloat16, False, MSD_MPD)
    assert all(f.dtype == torch.bfloat16 for _, _, fr, _ in outs.values()
               for fm in fr for f in fm)


# ------------------------------------------------ runner, CLI and export


def _voc_cfg(out):
    """The CLI's ``--smoke`` configuration, run from the directory ``out``."""
    from genvc_tpu_torch.testing_synthetic import smoke_overrides
    from genvc_tpu_torch.train_vocoder import recipe_config

    cfg = recipe_config("", "", None, "", "", "", None,
                        output_path=os.path.join(out, "exp/smoke_vocoder_torch"))
    smoke_overrides(cfg, os.path.join(out, "exp/smoke_assets_voc_torch"), need_gpt_ckpt=True)
    return cfg


def _run(cfg, **kw):
    from genvc_tpu_torch.train.runner import run_vocoder_training

    return run_vocoder_training(cfg, device="cpu", **kw)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``python -m genvc_tpu_torch.train_vocoder --smoke --device cpu`` (2
    steps on the synthetic assets, a checkpoint at step 2), then the runner
    on the same configuration with max_steps 3: it resumes at step 2 and
    takes one more step."""
    from genvc_tpu_torch import train_vocoder

    out = str(tmp_path_factory.mktemp("voc"))
    cwd = os.getcwd()
    os.chdir(out)
    try:
        rc = train_vocoder.main(["--smoke", "--device", "cpu"])
    finally:
        os.chdir(cwd)
    cfg = _voc_cfg(out)
    saved, _ = loop.CheckpointManager(os.path.join(cfg.output_path, "ckpt")).restore()
    return rc, cfg, saved, _run(cfg, max_steps=3)


def test_torch_vocoder_cli_smoke_on_cpu(trained):
    rc, cfg, _, _ = trained
    assert rc == 0
    with open(os.path.join(cfg.output_path, "train_log.jsonl")) as f:
        log = f.read().splitlines()
    assert len(log) >= 2 and "mel_loss" in log[0] and '"step": 2' in log[1]


def test_torch_vocoder_runner_end_to_end_and_resume(trained):
    """The CLI's checkpoint at step 2 holds both networks (the SN buffers
    too) and both optimizers; the runner restored it (the optimizers' counts
    go on from 2) and took a third step, checkpointed beside it."""
    _, cfg, saved, state = trained
    assert saved["step"] == 2 and saved["gen_opt"]["count"] == 2
    assert "u" in saved["disc_params"]["msd"]["discs"][0]["convs"][0]
    assert state.step == 3 and state.gen_opt.count == state.disc_opt.count == 3
    ckpt = loop.CheckpointManager(os.path.join(cfg.output_path, "ckpt"))
    assert ckpt.steps() == [2, 3]
    moved = tck.export_tree(state.discriminators)["msd"]["discs"][0]["conv_post"]
    before = saved["disc_params"]["msd"]["discs"][0]["conv_post"]
    assert not np.array_equal(moved["pv"], before["pv"])  # advanced by step 3
    assert not np.array_equal(moved["w_orig"], before["w_orig"])


def test_torch_trained_generator_exports_to_inference(tmp_path, trained):
    """The trained (g, v) generator through ``export_bundle`` /
    ``export_hifigan`` into a ``.pth`` that ``model_init`` loads (weight norm
    folded): its audio equals the training form's within 1e-5."""
    from genvc_tpu_torch.inference.pipeline import model_init
    from synthetic_bundle import write_bundle

    _, _, _, state = trained
    src = str(tmp_path / "bundle.pth")
    write_bundle(src)
    tree = tck.convert_bundle(src)
    tree["hifigan"] = tck.export_tree(state.generator)
    tree["config"]["vocoder_config"]["upsample_initial_channel"] = 16
    out = str(tmp_path / "trained.pth")
    tck.export_bundle(tree, out)
    pipe = model_init(out, device="cpu")
    lat = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 6, 64))
                           .astype(np.float32))
    got = pipe.vocode(lat)
    with torch.no_grad():
        want = state.generator(linear_interp_x4(lat.transpose(1, 2), 4))[:, 0]
    assert got.shape == want.shape == (2, 6 * 1024)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    # the runner's ``hifigan_checkpoint`` path: the .pth's weight_g / weight_v
    # back to the training form, unfolded
    sd, _ = tck.load_torch_bundle(out)
    back = tck.convert_hifigan(tck.strip_prefix(sd, "hifigan."), fold=False)
    for (k, v), (k2, w) in zip(_leaves(back), _leaves(tck.export_tree(state.generator))):
        assert k == k2
        np.testing.assert_array_equal(v, w, err_msg=k)


def test_torch_vocoder_cli_needs_a_card(tmp_path, monkeypatch):
    """Without ``--device cpu`` the CLI asks for CUDA and, with no card,
    stops with a message; it never falls back to the CPU."""
    from genvc_tpu_torch import train_vocoder

    monkeypatch.chdir(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vocoder.main(["--smoke"])
