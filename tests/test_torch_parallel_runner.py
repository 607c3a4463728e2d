"""The parallel runners of the port on CPU ranks over gloo
(``parallel.launch.run_ranks``), synthetic data and stage checkpoints:

* ``run_gpt_training(n_model=2)`` on 2 ranks for one epoch (4 steps, the
  eval batch and the listening samples, whose gather runs on both ranks),
  each rank's batches digested: the model group reads identical batches;
* its checkpoint holds the whole model and resumes in one process, and a
  one-process checkpoint resumes at ``n_model = 2``: the next step equals
  the one-process step from the same checkpoint (2e-6 absolute, the
  row-parallel sums in another order);
* the dVAE step data-parallel over 2 ranks against the one-process step on
  the whole batch (metrics 1e-5 relative, parameters and codebook 2e-6).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from genvc_tpu_torch import checkpoint as tck
from genvc_tpu_torch.config import GenVCConfig, GPTModelArgs, VAEConfig
from genvc_tpu_torch.models import dvae as tdvae
from genvc_tpu_torch.parallel import rank_checks
from genvc_tpu_torch.parallel.launch import run_ranks
from genvc_tpu_torch.testing_synthetic import smoke_overrides
from genvc_tpu_torch.train import loop, optim as toptim, vae_stage
from genvc_tpu_torch.train.runner import run_gpt_training


def _cfg(tmp_path, out):
    cfg = GenVCConfig(model_args=GPTModelArgs(
        gpt_number_text_tokens=258, gpt_start_text_token=256, gpt_stop_text_token=257,
        gpt_fix_condition_embeddings=True, gpt_use_masking_gt_prompt_approach=True),
        lr=1e-4, optimizer_params={"betas": [0.9, 0.96], "eps": 1e-3, "weight_decay": 1e-6},
        output_path=str(tmp_path / out))
    smoke_overrides(cfg, str(tmp_path / "assets"))
    cfg.model_args.max_conditioning_length = 48000
    return cfg


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def _assert_trees(got, want, atol, what):
    want = dict(_leaves(want))
    for path, g in _leaves(got):
        err = float(np.abs(g - want[path]).max()) if g.size else 0.0
        assert err <= atol, f"{what}{path}: max |err| {err:.3e} > {atol}"


def _dvae_spec():
    cfg = VAEConfig(feat_type="Mel-spectrogram", num_channels=80, num_tokens=32,
                    codebook_dim=8, hidden_dim=8, num_resnet_blocks=1, num_layers=2,
                    lr=1e-3, grad_clip_norm=0.5)
    tree = tdvae.init_tree(torch.Generator().manual_seed(0), tck.dvae_config(cfg),
                           trainable=True)
    wav = (np.random.default_rng(2).standard_normal((4, 1, 8192)) * 0.1).astype(np.float32)
    return {"vae_cfg": cfg, "tree": {k: _np_tree(v) for k, v in tree.items()},
            "batch": {"wav": wav}, "mel_norms": np.ones(80, np.float32), "steps": 2}


@pytest.fixture(scope="module")
def first_launch(tmp_path_factory):
    """The GPT runner at n_model = 2 for one epoch and the data-parallel
    dVAE steps, in one launch of 2 ranks (a spawned rank takes seconds to
    start)."""
    tmp = tmp_path_factory.mktemp("runner")
    cfg, dvae = _cfg(tmp, "tp"), _dvae_spec()
    outs = run_ranks(rank_checks.sequence, 2, args=([
        ("gpt_runner", {"cfg": cfg, "max_steps": None, "max_eval_batches": 1, "n_model": 2}),
        ("dvae_train", dvae)],))
    return tmp, cfg, [o[0] for o in outs], dvae, [o[1] for o in outs]


def test_torch_gpt_runner_tensor_parallel_and_checkpoints(first_launch):
    tmp_path, cfg, outs, _, _ = first_launch
    assert [o["step"] for o in outs] == [4, 4] and outs[0]["opt_count"] == 4
    # 4 training batches and the eval batch on both; rank 0 then features
    # the listening samples' batch
    assert outs[0]["digests"][:5] == outs[1]["digests"] and len(outs[0]["digests"]) == 6
    samples = os.listdir(os.path.join(cfg.output_path, "eval_samples"))
    assert "e0_self.wav" in samples and len(samples) == 2  # rank 0 alone wrote them

    # the checkpoint is the whole model (rank 0 wrote it once)
    ckpt = loop.CheckpointManager(os.path.join(cfg.output_path, "ckpt"))
    saved, step = ckpt.restore()
    assert step == 4 and ckpt.steps() == [4]
    _assert_trees(saved["params"], outs[0]["params"], 0.0, "checkpoint")
    with open(os.path.join(cfg.output_path, "train_log.jsonl")) as f:
        assert sum("steps_per_sec" in line for line in f) == 4  # logged once per step

    # it resumes in one process ...
    one = run_gpt_training(cfg, max_steps=5, device="cpu")
    assert one.step == 5 and one.opt.count == 5 and ckpt.steps() == [4, 5]
    # ... and that process's checkpoint resumes at n_model = 2: one more step
    # on both sides from step 5
    tp_cfg = _cfg(tmp_path, "tp_again")
    shutil.copytree(os.path.join(cfg.output_path, "ckpt"), os.path.join(tp_cfg.output_path,
                                                                         "ckpt"))
    outs = run_ranks(rank_checks.gpt_runner, 2, args=(
        {"cfg": tp_cfg, "max_steps": 6, "n_model": 2},))
    assert [o["step"] for o in outs] == [6, 6] and outs[0]["opt_count"] == 6
    one = run_gpt_training(cfg, max_steps=6, device="cpu")
    _assert_trees(outs[0]["params"], tck.export_tree(one.model), 2e-6, "resumed step")


def test_torch_gpt_runner_refuses_a_mesh_that_does_not_divide(tmp_path, monkeypatch):
    """3 heads do not divide over 2 model ranks; a batch of 3 does not divide
    over 2 data ranks (JAX's runner would leave a device idle instead)."""
    from genvc_tpu_torch.parallel import mesh as mesh_lib
    from genvc_tpu_torch.train import runner

    cfg = _cfg(tmp_path, "bad")
    cfg.model_args.gpt_n_heads = 3
    with pytest.raises(ValueError, match="divide"):
        run_gpt_training(cfg, n_model=2, device="cpu")
    monkeypatch.setattr(mesh_lib, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="batch of 3 rows does not divide over 2 data ranks"):
        runner._data_mesh(3, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="n_model=4 does not divide the world of 2"):
        runner._data_mesh(8, 4, torch.device("cpu"))


def test_torch_dvae_step_data_parallel_matches_one_process(first_launch):
    """Two dVAE steps (mel features) with the batch of 4 split over 2 data
    ranks against one process on the whole batch: the codebook's EMA counts
    every row of the global batch, and the averaged gradients give the same
    update."""
    _, _, _, spec, outs = first_launch
    assert outs[0]["codebook_digest"] == outs[1]["codebook_digest"]
    cfg, tree = spec["vae_cfg"], spec["tree"]
    wav, norms = spec["batch"]["wav"], spec["mel_norms"]
    with torch.device("meta"):
        model = tdvae.DVAE(tck.dvae_config(cfg), trainable=True)
    tck.assign(model, tree, "cpu")
    params = toptim.FlatParams(model)
    state = vae_stage.VAETrainState(model, params, vae_stage.make_optimizer(cfg, params))
    step, _ = vae_stage.make_train_step(vae_stage.make_feature_fn(cfg))
    for got in outs[0]["metrics"]:
        state, m = step(state, {"wav": torch.from_numpy(wav)}, torch.from_numpy(norms))
        for k, v in m.items():
            assert got[k] == pytest.approx(float(v), rel=1e-5), k
    _assert_trees(outs[0]["tree"], tck.export_tree(model), 2e-6, "dvae")


def _np_tree(node):
    if isinstance(node, dict):
        return {k: _np_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_np_tree(v) for v in node]
    return node.numpy()
