"""GPT training stage parity, port vs JAX package on the CPU in f32: the
kaiser resampler, the optimizer (mask, schedule, AdamW with clipping against
optax), ``prepare_features`` on the synthetic stage checkpoints, and the
train step (loss, metrics, per-leaf gradients, parameters after 2 AdamW
steps) against JAX's ``make_train_step(attn_impl="xla")`` on the 2-layer x 64
synthetic GPT. The Pallas forward runs only in interpret mode here, so the
whole-step oracle is JAX's dense path; the kernels' oracle is
``test_torch_flash_attention.py``.

Tolerances: codes identical; mels 1e-5 (f32 DFT and log in other orders);
losses and gradients 1e-6 / 1e-6 relative (f32 sums in other orders, measured
<= 3e-7); optimizer states as the JAX package's own chain-vs-fused test
(rtol 2e-6, atol 1e-7) when both sides get the same gradients.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from genvc_tpu.config import GenVCConfig as JConfig
from genvc_tpu.dsp import resample as jres
from genvc_tpu.models import gpt as jgpt
from genvc_tpu.train import gpt_stage as jstage, optim as joptim
from genvc_tpu.train.runner import _load_contentvec, _load_dvae
from genvc_tpu_torch import checkpoint as tck
from genvc_tpu_torch.config import GenVCConfig as TConfig
from genvc_tpu_torch.dsp import resample as tres
from genvc_tpu_torch.models import gpt as tgpt
from genvc_tpu_torch.testing_synthetic import write_stage_ckpts
from genvc_tpu_torch.train import gpt_stage as tstage, optim as toptim

KAISER = dict(lowpass_filter_width=64, rolloff=0.9475937167399596,
              beta=14.769656459379492, window="kaiser")
GCFG = dict(layers=2, model_dim=64, heads=4)
# Adam's eps in the whole-step tests: Adam divides by sqrt(v), so with the
# recipe's 1e-8 an element whose gradient sits at the f32 noise floor of both
# sides (~1e-7; e.g. the key bias of c_attn, whose shift cancels in the
# softmax) takes a normalized update of a sizable fraction of lr that differs
# between them. 1e-3 keeps such updates tiny and leaves the others ~lr.
EPS = 1e-3


def _shrink(cfg, dvae_rate=24000):
    for c, ch, nt in ((cfg.acoustic_dvae_config, 80, 64), (cfg.content_dvae_config, 256, 36)):
        c.num_channels, c.num_tokens, c.hidden_dim, c.codebook_dim = ch, nt, 16, 24
        c.num_resnet_blocks = 3
    cfg.audio.dvae_sample_rate = dvae_rate
    return cfg


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The synthetic stage checkpoints, loaded by each side's own loaders."""
    paths = write_stage_ckpts(str(tmp_path_factory.mktemp("stage")))
    jtree = {"contentvec": _load_contentvec(paths["contentvec"]),
             "acoustic_dvae": _load_dvae(paths["acoustic_dvae"]),
             "content_dvae": _load_dvae(paths["content_dvae"])}
    ttree = {"contentvec": tck.load_contentvec(paths["contentvec"]),
             "acoustic_dvae": tck.load_dvae(paths["acoustic_dvae"]),
             "content_dvae": tck.load_dvae(paths["content_dvae"])}
    gpt_tree = tck.load_gpt(paths["gpt"], GCFG["layers"])
    return jtree, ttree, gpt_tree


def _frozen(assets, dvae_rate=24000):
    jtree, ttree, _ = assets
    ones = np.ones(80, np.float32)
    return (jstage.make_frozen(_shrink(JConfig(), dvae_rate), jtree, ones),
            tstage.make_frozen(_shrink(TConfig(), dvae_rate), ttree, ones, "cpu"))


def _batch(seed=0):
    """B = 2: 4 and 3 content tokens (the second row zero past its length),
    conditioning of 24000 and 18000 samples."""
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((2, 1, 4 * 1920)) * 0.1).astype(np.float32)
    wav[1, :, 3 * 1920:] = 0
    return {"wav": wav, "wav_lengths": np.asarray([4 * 1920, 3 * 1920]),
            "conditioning": (rng.standard_normal((2, 1, 1, 24000)) * 0.1).astype(np.float32),
            "cond_lens": np.asarray([24000, 18000]), "text_lengths": np.asarray([4, 3])}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaf(tree, name):
    """The JAX tree's leaf of a port parameter name (layer stacks indexed)."""
    idx, node = None, tree
    for p in name.split("."):
        if p.isdigit():
            idx = int(p)
        else:
            node = node[p]
    node = np.asarray(node)
    return node if idx is None or node.ndim == 0 else node[idx]


# ---------------------------------------------------------------- resample


def test_torch_resample_kaiser_parameters_match_jax():
    """The filter ``prepare_features`` uses when the dVAE rate differs."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 7680)) * 0.1).astype(np.float32)
    want = np.asarray(jres.resample(jnp.asarray(x), 24000, 16000, **KAISER))
    got = tres.resample(torch.from_numpy(x), 24000, 16000, **KAISER).numpy()
    assert got.shape == want.shape == (2, 5120)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(tres.resample_np(x, 24000, 16000, **KAISER),
                               jres.resample_np(x, 24000, 16000, **KAISER), atol=1e-5)


def test_torch_prepare_features_kaiser_resample_branch(assets):
    """dvae_sample_rate != sample_rate routes the acoustic-dVAE wav through
    the reference's kaiser resample; the codes equal the manual path."""
    from genvc_tpu_torch.dsp import mel as tmel

    _, frozen = _frozen(assets, dvae_rate=16000)
    assert frozen.dvae_sample_rate == 16000
    batch = _t(_batch(1))
    feats = tstage.prepare_features(frozen, batch)
    wav16 = tres.resample(batch["wav"][:, 0, :], 24000, 16000, **KAISER)
    mel = tmel.mel_torchaudio(wav16, frozen.dvae_spec, frozen.mel_norms)
    want = frozen.acoustic_dvae.get_codebook_indices(mel)
    np.testing.assert_array_equal(feats["audio_codes"][:, : want.shape[1]].numpy(),
                                  want.numpy())


# --------------------------------------------------------------- optimizer


def test_torch_weight_decay_mask_matches_jax(assets):
    params = assets[2]
    want = joptim.weight_decay_mask(params)
    assert toptim.weight_decay_mask(params) == want
    assert toptim.weight_decay_mask(params)["perceiver"]["latents"] is True
    # the flat layout puts exactly the masked-in leaves first
    with torch.device("meta"):
        model = tgpt.GPT(tgpt.GPTConfig(**GCFG))
    tck.assign(model, params, "cpu")
    flat = toptim.FlatParams(model)
    decayed = [n for n in flat.names if _leaf(want, n)]
    assert flat.names[: len(decayed)] == decayed
    assert flat.n_decay == sum(s for n, s in zip(flat.names, flat.sizes) if _leaf(want, n))


@pytest.mark.parametrize("count", [0, 1, 99, 100, 101, 150, 199, 200, 250])
def test_torch_multistep_schedule_matches_optax(count):
    """A milestone m applies from count m on (optax's piecewise constant
    schedule); the vocoder stage's per-epoch exponential decay too."""
    want = float(joptim.multistep_schedule(1e-4, [100, 200], 0.5)(count))
    assert toptim.multistep_schedule(1e-4, [100, 200], 0.5)(count) == pytest.approx(want, rel=1e-6)
    want = float(joptim.exponential_epoch_schedule(2e-4, 0.98, 37)(count))
    assert toptim.exponential_epoch_schedule(2e-4, 0.98, 37)(count) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("recipe,regime", [
    ("adamw_grouped", "clipped"), ("adamw_grouped", "unclipped"),
    ("adamw_clip_fused", "clipped"), ("adamw_clip_fused", "unclipped"),
    ("vocoder_adamw", "unclipped")])
def test_torch_adamw_matches_optax(assets, recipe, regime):
    """4 updates with the same gradients on both sides, across the milestone
    at count 2; the parameters after every update within rtol 2e-6 / atol
    1e-7 (tests/test_train.py's own tolerance)."""
    params = jax.tree.map(jnp.asarray, assets[2])
    sched = joptim.multistep_schedule(1e-3, [2], 0.5)
    tsched = toptim.multistep_schedule(1e-3, [2], 0.5)
    if recipe == "vocoder_adamw":
        tx = joptim.vocoder_adamw(sched)
    else:
        tx = getattr(joptim, recipe)(sched, weight_decay=0.1, params=params)
    st = tx.init(params)
    update = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
        *tx.update(g, s, p)))
    with torch.device("meta"):
        model = tgpt.GPT(tgpt.GPTConfig(**GCFG))
    tck.assign(model, jax.tree.map(np.asarray, params), "cpu")
    flat = toptim.FlatParams(model)
    topt = (toptim.vocoder_adamw(tsched) if recipe == "vocoder_adamw"
            else getattr(toptim, recipe)(tsched, weight_decay=0.1, params=flat))
    topt.init(flat.flat)

    scale = 1e-3 if regime == "unclipped" else 10.0
    rng = np.random.default_rng(0)
    for _ in range(4):
        grads = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32) * scale), params)
        gn = float(optax.global_norm(grads))
        assert (gn > 1.0) == (regime == "clipped")
        params, st = update(grads, st, params)
        flat_g = torch.cat([torch.from_numpy(_leaf(grads, n)).reshape(-1) for n in flat.names])
        topt.step(flat.flat, flat_g)
        got = tck.export_tree(model)
        for n in flat.names:
            np.testing.assert_allclose(_leaf(got, n), _leaf(params, n), rtol=2e-6,
                                       atol=1e-7, err_msg=n)


# -------------------------------------------------------------- the stage


def test_torch_prepare_features_matches_jax(assets):
    jf, tf = _frozen(assets)
    batch = _batch()
    want = jax.jit(jstage.prepare_features)(jf, _j(batch))
    got = tstage.prepare_features(tf, _t(batch))
    assert set(got) == set(want)
    for k in ("audio_codes", "text_inputs", "text_lengths", "wav_lengths", "cond_lens"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["audio_codes"].shape == (2, 12) and got["text_inputs"].shape == (2, 4)
    np.testing.assert_allclose(got["cond_mels"].numpy(), np.asarray(want["cond_mels"]),
                               atol=1e-5)


def _torch_state(assets, recipe="adamw_grouped", lr=1e-3):
    with torch.device("meta"):
        model = tgpt.GPT(tgpt.GPTConfig(**GCFG))
    tck.assign(model, assets[2], "cpu")
    flat = toptim.FlatParams(model)
    tx = getattr(toptim, recipe)(toptim.multistep_schedule(lr, [1], 0.5), eps=EPS,
                                 weight_decay=0.1, params=flat).init(flat.flat)
    return tstage.GPTTrainState(model, flat, tx)


def test_torch_loss_and_gradients_match_jax(assets):
    """Loss, metrics and every leaf's gradient against ``jax.value_and_grad``
    of JAX's ``loss_fn`` (dense attention) on the same features, with
    ``fix_condition_embeddings``: the Perceiver's gradients are zeros, and
    present, on both sides."""
    _, tf = _frozen(assets)
    feats = tstage.prepare_features(tf, _t(_batch()))
    jfeats = {k: jnp.asarray(v.numpy()) for k, v in feats.items()}
    params = jax.tree.map(jnp.asarray, assets[2])
    gcfg = jgpt.GPTConfig(**GCFG)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, f: jstage.loss_fn(p, gcfg, f, 0.01, 1.0, True, remat=False,
                                    attn_impl="xla"), has_aux=True))(params, jfeats)
    state = _torch_state(assets)
    loss, m = tstage.loss_fn(state.model, state.params.tensors(), feats, 0.01, 1.0,
                             True, "xla")
    loss.backward()
    for k in ("loss", "loss_text_ce", "loss_mel_ce", "top10acc"):
        assert float(m[k].detach()) == pytest.approx(float(jm[k]), rel=1e-6, abs=1e-6), k
    grads = state.params.views(state.params.flat.grad)
    for n, g in grads.items():
        want = _leaf(jgrads, n)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * max(np.abs(want).max(), 1e-3), err_msg=n)
    assert all(not g.any() for n, g in grads.items() if n.startswith("perceiver."))


@pytest.mark.parametrize("recipe", ["adamw_grouped", "adamw_clip_fused"])
def test_torch_train_step_matches_jax(assets, recipe):
    """Two steps of the port's ``make_train_step`` against JAX's
    ``make_train_step(attn_impl="xla")`` on the same batch, lr 1e-3 halved at
    the milestone 1, weight decay 0.1: per-step metrics, and every parameter
    after each step. The Perceiver gets zero gradients, yet AdamW decays its
    weights: they move by exactly lr * wd * p on both sides. Parameters at
    atol 1e-6 with Adam's eps at EPS on both sides (see there)."""
    jf, tf = _frozen(assets)
    batch = _batch()
    params = jax.tree.map(jnp.asarray, assets[2])
    tx = getattr(joptim, recipe)(joptim.multistep_schedule(1e-3, [1], 0.5), eps=EPS,
                                 weight_decay=0.1, params=params)
    jstate = jstage.GPTTrainState(params, tx.init(params), jnp.int32(0))
    jstep, _ = jstage.make_train_step(jgpt.GPTConfig(**GCFG), tx, attn_impl="xla")
    jstep = jax.jit(jstep)
    state = _torch_state(assets, recipe)
    tstep, teval = tstage.make_train_step(attn_impl="xla")
    p0 = tck.export_tree(state.model)
    for _ in range(2):
        jstate, jm = jstep(jstate, _j(batch), jf)
        state, m = tstep(state, _t(batch), tf)
        for k in jm:
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=2e-6, abs=1e-6), k
        got = tck.export_tree(state.model)
        for n in state.params.names:
            np.testing.assert_allclose(_leaf(got, n), _leaf(jstate.params, n), rtol=0,
                                       atol=1e-6, err_msg=n)
    assert state.step == 2
    # the Perceiver's weights decayed, its biases did not move
    lat0, lat = p0["perceiver"]["latents"], got["perceiver"]["latents"]
    np.testing.assert_allclose(lat, lat0 * (1 - 1e-3 * 0.1) * (1 - 5e-4 * 0.1), rtol=1e-6)
    np.testing.assert_array_equal(got["perceiver"]["layers"]["ff_in"]["b"],
                                  p0["perceiver"]["layers"]["ff_in"]["b"])
    em = teval(state, _t(batch), tf)
    assert np.isfinite(float(em["loss"])) and float(em["loss"]) < float(m["loss"])


def test_torch_train_step_flash_matches_xla(assets):
    """The kernels' path (their plain versions on the CPU) and the dense path
    give the same step: rows all see a valid key here."""
    _, tf = _frozen(assets)
    batch = _t(_batch())
    out = []
    for impl in ("flash", "xla"):
        state = _torch_state(assets)
        step, _ = tstage.make_train_step(attn_impl=impl, grad_norms=True)
        state, m = step(state, batch, tf)
        out.append((m, tck.export_tree(state.model), state))
    (mf, pf, _), (mx, px, sx) = out
    for k in mf:
        assert float(mf[k]) == pytest.approx(float(mx[k]), rel=1e-5, abs=1e-6), k
    assert float(mf["grad_norm/perceiver"]) == 0.0 and float(mf["grad_norm/total"]) > 0
    for n in sx.params.names:
        np.testing.assert_allclose(_leaf(pf, n), _leaf(px, n), rtol=0, atol=2e-6, err_msg=n)


def test_torch_bf16_step_runs_on_f32_masters(assets):
    """compute_dtype=bf16: the masters stay f32, the loss is finite and near
    the f32 step's (codes and targets are the same; bf16 rounding moves the
    loss by well under 1 %)."""
    _, tf = _frozen(assets)
    batch = _t(_batch())
    losses = []
    for dt in (None, torch.bfloat16):
        state = _torch_state(assets)
        step, _ = tstage.make_train_step(compute_dtype=dt)
        state, m = step(state, batch, tf)
        assert state.params.flat.dtype == torch.float32
        losses.append(float(m["loss"]))
    assert np.isfinite(losses[1]) and losses[1] == pytest.approx(losses[0], rel=1e-2)


def test_torch_topk_accuracy_counts_ties_as_hits():
    logits = np.zeros((2, 3, 20), np.float32)
    logits[0, 0, :12] = 1.0           # target tied with 11 others: a hit
    logits[0, 1, :11] = 2.0           # 11 above the target: a miss
    logits[1] = np.random.default_rng(0).standard_normal((3, 20))
    targets = np.asarray([[0, 15, 3], [1, 2, 3]])
    keep = np.asarray([[True, True, False], [True, True, True]])
    want = float(jgpt._topk_accuracy(jnp.asarray(logits), jnp.asarray(targets),
                                     jnp.asarray(keep), k=10))
    got = float(tgpt._topk_accuracy(torch.from_numpy(logits), torch.from_numpy(targets),
                                    torch.from_numpy(keep), k=10))
    assert got == pytest.approx(want)
    ce = jgpt._masked_ce(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(keep), 0.1)
    tce = tgpt._masked_ce(torch.from_numpy(logits), torch.from_numpy(targets),
                          torch.from_numpy(keep), 0.1)
    assert float(tce) == pytest.approx(float(ce), rel=1e-6)
