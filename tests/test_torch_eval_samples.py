"""The GPT stage's listening samples, port vs JAX package on the CPU in f32:
``generate_eval_samples`` on the synthetic stage checkpoints (GPT 2 x 64,
``max_mel_tokens`` cut to 24, so 21 tokens a generation) under the greedy
sampler, ``Logger.log_histograms`` on one parameter tree, and one
``on_epoch_end`` through ``run_gpt_training``.

Tolerances: the codes identical; the waveforms within 1e-5 (Griffin-Lim in
float64 on both sides from the same initial phases, the dVAE's mel in f32
sums of other orders: measured <= 4e-7); the histogram records equal.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from genvc_tpu.config import GenVCConfig as JConfig
from genvc_tpu.decode.engine import SamplerConfig as JSampler
from genvc_tpu.models import gpt as jgpt
from genvc_tpu.train import eval_samples as jes, gpt_stage as jstage, loop as jloop
from genvc_tpu.train.runner import _load_contentvec, _load_dvae
from genvc_tpu_torch import checkpoint as tck
from genvc_tpu_torch.config import GenVCConfig as TConfig
from genvc_tpu_torch.decode.engine import SamplerConfig as TSampler
from genvc_tpu_torch.models import gpt as tgpt
from genvc_tpu_torch.testing_synthetic import write_stage_ckpts
from genvc_tpu_torch.train import eval_samples as tes, gpt_stage as tstage, loop as tloop

GREEDY = dict(temperature=1.0, top_k=1, top_p=1.0, repetition_penalty=1.0, do_sample=False)
GCFG = dict(layers=2, model_dim=64, heads=4, max_mel_tokens=24)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shrink(cfg):
    for c, ch, nt in ((cfg.acoustic_dvae_config, 80, 64), (cfg.content_dvae_config, 256, 36)):
        c.num_channels, c.num_tokens, c.hidden_dim, c.codebook_dim = ch, nt, 16, 24
        c.num_resnet_blocks = 3
    return cfg


@pytest.fixture(scope="module")
def stage(tmp_path_factory):
    """Both sides' frozen modules and GPT (its mel positions cut to
    ``max_mel_tokens``), and the features of a batch of 2 rows."""
    paths = write_stage_ckpts(str(tmp_path_factory.mktemp("stage")))
    norms = np.random.default_rng(3).uniform(0.5, 1.5, 80).astype(np.float32)
    jf = jstage.make_frozen(_shrink(JConfig()), {
        "contentvec": _load_contentvec(paths["contentvec"]),
        "acoustic_dvae": _load_dvae(paths["acoustic_dvae"]),
        "content_dvae": _load_dvae(paths["content_dvae"])}, norms)
    tf = tstage.make_frozen(_shrink(TConfig()), {
        "contentvec": tck.load_contentvec(paths["contentvec"]),
        "acoustic_dvae": tck.load_dvae(paths["acoustic_dvae"]),
        "content_dvae": tck.load_dvae(paths["content_dvae"])}, norms, "cpu")
    cfg = tgpt.GPTConfig(**GCFG)
    tree = tck.load_gpt(paths["gpt"], cfg.layers)
    tree["mel_pos"] = tree["mel_pos"][: cfg.mel_positions]
    with torch.device("meta"):
        model = tgpt.GPT(cfg)
    tck.assign(model, tree, "cpu")
    rng = np.random.default_rng(0)
    batch = {"wav": torch.from_numpy((rng.standard_normal((2, 1, 4 * 1920)) * 0.1)
                                     .astype(np.float32)),
             "wav_lengths": torch.tensor([4 * 1920, 4 * 1920]),
             "conditioning": torch.from_numpy((rng.standard_normal((2, 1, 1, 24000)) * 0.1)
                                              .astype(np.float32)),
             "cond_lens": torch.tensor([24000, 24000]), "text_lengths": torch.tensor([4, 3])}
    feats = tstage.prepare_features(tf, batch)
    return jf, tf, tree, model, feats, norms


def test_torch_eval_samples_match_jax_greedy(stage, monkeypatch):
    """Self and cross samples: the generated tokens identical to JAX's, the
    codes handed to the dVAE identical (a code past the 64-entry codebook
    clamped on both sides), the waveforms within 1e-5, the target row drawn
    alike."""
    jf, tf, tree, model, feats, norms = stage
    rec = {"jax_tokens": [], "torch_tokens": [], "jax_codes": [], "torch_codes": []}

    def recording(fn, key, tokens):
        def wrapped(*args):
            out = fn(*args)
            rec[key].append(np.asarray(out[tokens]).tolist())
            return out
        return wrapped

    monkeypatch.setattr(jes.engine, "decode_all", recording(jes.engine.decode_all,
                                                            "jax_tokens", 1))
    monkeypatch.setattr(tes.engine, "decode_all", recording(tes.engine.decode_all,
                                                            "torch_tokens", 0))
    monkeypatch.setattr(jes.dvae, "decode", lambda p, c, cfg, f=jes.dvae.decode: (
        rec["jax_codes"].append(np.asarray(c).tolist()) or f(p, c, cfg)))
    monkeypatch.setattr(tf.acoustic_dvae, "decode", lambda c, f=tf.acoustic_dvae.decode: (
        rec["torch_codes"].append(c.tolist()) or f(c)))
    params = jax.tree.map(jnp.asarray, tree)
    jfeats = {k: jnp.asarray(v.numpy()) for k, v in feats.items()}
    want = jes.generate_eval_samples(params, jgpt.GPTConfig(**GCFG), jf.acoustic_dvae_params,
                                     jf.acoustic_dvae_cfg, jfeats, jf.mel_norms,
                                     jax.random.key(0), sampler=JSampler(**GREEDY))
    got = tes.generate_eval_samples(model, tf.acoustic_dvae, feats, tf.mel_norms,
                                    sampler=TSampler(**GREEDY))
    assert got[2] == want[2]
    assert len(rec["torch_tokens"]) == 2 and rec["torch_tokens"] == rec["jax_tokens"]
    clamped = [[[min(c, 63) for c in row] for row in codes] for codes in rec["jax_codes"]]
    assert rec["torch_codes"] == clamped and len(clamped[0][0]) == 21
    assert max(max(t[0]) for t in rec["torch_tokens"]) >= 64  # the clamp is exercised
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == np.float32 and g.shape == w.shape == ((21 * 4 - 1) * 256,)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_torch_log_histograms_match_jax(stage, tmp_path):
    """The same jsonl records as JAX's ``Logger.log_histograms`` on the
    same tree (per module: min, max, l2)."""
    tree = tck.export_tree(stage[3])
    recs = []
    for side, logger in (("jax", jloop.Logger(use_wandb=False, out_dir=str(tmp_path / "j"))),
                         ("torch", tloop.Logger(out_dir=str(tmp_path / "t")))):
        logger.log_histograms(tree, step=3, prefix="param")
        name = "j" if side == "jax" else "t"
        recs.append([json.loads(line) for line in
                     (tmp_path / name / "train_log.jsonl").read_text().splitlines()])
    assert len(recs[1]) == len(tree) and recs[1] == recs[0]
    assert {k.split("/")[1] for r in recs[1] for k in r if "/" in k} == set(tree)


def test_torch_on_epoch_end_writes_listening_samples(tmp_path):
    """One epoch (4 steps of the smoke data) through ``run_gpt_training``:
    the epoch's end writes ``e0_self.wav`` and ``e0_cross<row>.wav``."""
    from genvc_tpu_torch.config import GPTModelArgs
    from genvc_tpu_torch.dsp.audio_io import read_wav
    from genvc_tpu_torch.testing_synthetic import smoke_overrides
    from genvc_tpu_torch.train.runner import run_gpt_training

    cfg = TConfig(model_args=GPTModelArgs(
        gpt_number_text_tokens=258, gpt_start_text_token=256, gpt_stop_text_token=257,
        gpt_fix_condition_embeddings=True, gpt_use_masking_gt_prompt_approach=True),
        output_path=str(tmp_path / "exp"))
    smoke_overrides(cfg, str(tmp_path / "assets"))
    cfg.model_args.gpt_max_audio_tokens = 48
    state = run_gpt_training(cfg, max_eval_batches=1, device="cpu")
    assert state.step == 4
    names = sorted(os.listdir(tmp_path / "exp" / "eval_samples"))
    assert len(names) == 2 and names[1] == "e0_self.wav" and names[0].startswith("e0_cross")
    for name in names:
        audio, sr = read_wav(str(tmp_path / "exp" / "eval_samples" / name))
        # sampled codes: up to 45 (max_gen_mel_tokens), 4 mel frames each
        n = audio.shape[1]
        assert sr == 24000 and 0 < n <= (45 * 4 - 1) * 256 and n % 256 == 0
        assert np.isfinite(audio).all() and np.abs(audio).max() > 0
