"""The port's GPT-stage runner and CLI on the CPU (synthetic data and stage
checkpoints: 2 steps, checkpoint, resume), and the loader behaviour tests of
``tests/test_runner.py`` against the port's ``BatchLoader``."""

import logging
import os

import numpy as np
import pytest
import torch

from genvc_tpu_torch import checkpoint as tck
from genvc_tpu_torch.config import GenVCConfig, GPTModelArgs
from genvc_tpu_torch.data.loader import BatchLoader
from genvc_tpu_torch.testing_synthetic import smoke_overrides, write_stage_ckpts
from genvc_tpu_torch.train import loop
from genvc_tpu_torch.train.runner import run_gpt_training


def _cfg(tmp_path):
    cfg = GenVCConfig(model_args=GPTModelArgs(
        gpt_number_text_tokens=258, gpt_start_text_token=256, gpt_stop_text_token=257,
        gpt_fix_condition_embeddings=True, gpt_use_masking_gt_prompt_approach=True),
        lr=1e-4, optimizer_params={"betas": [0.9, 0.96], "eps": 1e-8, "weight_decay": 1e-6},
        output_path=str(tmp_path / "exp_gpt"))
    smoke_overrides(cfg, str(tmp_path / "assets"))
    cfg.model_args.max_conditioning_length = 48000
    return cfg


def test_torch_gpt_runner_end_to_end_and_resume(tmp_path):
    """2 steps (8 samples / batch 2, capped by max_steps), a checkpoint at
    step 2, then a second call resumes there and trains no further; a third
    with max_steps 3 takes one more step from the restored state."""
    cfg = _cfg(tmp_path)
    state = run_gpt_training(cfg, max_steps=2, max_eval_batches=1, device="cpu")
    assert state.step == 2 and state.opt.count == 2
    ckpt = loop.CheckpointManager(os.path.join(cfg.output_path, "ckpt"))
    assert ckpt.steps() == [2]
    saved, step = ckpt.restore()
    assert step == 2 and saved["names"] == state.params.names
    trained = tck.export_tree(state.model)

    again = run_gpt_training(cfg, max_steps=2, device="cpu")
    assert again.step == 2 and again.opt.count == 2
    for a, b in zip(tck.export_tree(again.model)["core"]["blocks"]["mlp"]["c_fc"].values(),
                    trained["core"]["blocks"]["mlp"]["c_fc"].values()):
        np.testing.assert_array_equal(a, b)
    torch.testing.assert_close(again.opt.mu, state.opt.mu, rtol=0, atol=0)

    more = run_gpt_training(cfg, max_steps=3, device="cpu")
    assert more.step == 3 and ckpt.steps() == [2, 3]
    assert not np.array_equal(tck.export_tree(more.model)["mel_head"]["w"],
                              trained["mel_head"]["w"])


def test_torch_gpt_runner_loads_a_gpt_checkpoint(tmp_path):
    """``gpt_checkpoint`` starts from the reference-format GPT bundle."""
    cfg = _cfg(tmp_path)
    paths = write_stage_ckpts(str(tmp_path / "assets"))
    cfg.model_args.gpt_checkpoint = paths["gpt"]
    cfg.epochs = 0
    state = run_gpt_training(cfg, device="cpu")
    want = tck.load_gpt(paths["gpt"], 2)
    np.testing.assert_array_equal(tck.export_tree(state.model)["text_embedding"],
                                  want["text_embedding"])


def test_torch_gpt_runner_refuses_what_is_not_ported(tmp_path):
    """Every mode is ported (tensor parallelism:
    tests/test_torch_parallel_runner.py); what is refused is a mesh the
    model does not divide: 3 model ranks for the 4 heads."""
    cfg = _cfg(tmp_path)
    with pytest.raises(ValueError, match="divide"):
        run_gpt_training(cfg, device="cpu", n_model=3)


def test_torch_train_cli_smoke_on_cpu(tmp_path, monkeypatch, capsys):
    from genvc_tpu_torch import train_genVC

    monkeypatch.chdir(tmp_path)
    assert train_genVC.main(["--smoke", "--device", "cpu"]) == 0
    assert "trained to step 2" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "exp/smoke_gpt_torch/ckpt/2.pt")
    log = (tmp_path / "exp/smoke_gpt_torch/train_log.jsonl").read_text().splitlines()
    assert len(log) == 2 and "loss_mel_ce" in log[0]


def test_torch_train_cli_refuses_and_needs_a_card(tmp_path, monkeypatch, capsys):
    from genvc_tpu_torch import train_genVC

    monkeypatch.chdir(tmp_path)
    # tensor parallelism needs its ranks: one process is told to launch them
    assert train_genVC.main(["--smoke", "--n_model", "2"]) == 2
    assert "torchrun --nproc_per_node" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_genVC.main(["--smoke"])


# ------------------------------------------------- loader (tests/test_runner.py)


def test_torch_loader_process_shards_disjoint():
    class IdxDataset:
        def __len__(self):
            return 16

        def collate(self, idx, rng):
            return list(idx)

    seen = []
    for shard in range(2):
        ld = BatchLoader(IdxDataset(), batch_size=2, shuffle=True, num_workers=1,
                         seed=7, num_shards=2, shard_index=shard)
        assert len(ld) == 4
        got = [i for b in ld for i in b]
        assert len(got) == 8
        seen.append(set(got))
    assert seen[0].isdisjoint(seen[1])
    assert seen[0] | seen[1] == set(range(16))


def test_torch_loader_substitutes_corrupt_samples(caplog):
    class FlakyDataset:
        BAD = {5, 9}

        def __len__(self):
            return 12

        def collate(self, idx, rng):
            if any(i in self.BAD for i in idx):
                raise ValueError(f"corrupt sample in {idx}")
            return list(idx)

    ld = BatchLoader(FlakyDataset(), batch_size=4, shuffle=False, num_workers=1, seed=0)
    with caplog.at_level(logging.WARNING, logger="genvc_tpu_torch.data.loader"):
        batches = list(ld)
    assert len(batches) == 3
    flat = [i for b in batches for i in b]
    assert len(flat) == 12 and 5 not in flat and 9 not in flat
    assert flat.count(1) == 3
    assert ld.substitutions == 2 and ld.dropped_batches == 0
    assert any("substituted" in r.message for r in caplog.records)


def test_torch_loader_drops_unrecoverable_batch():
    class BrokenDataset:
        def __len__(self):
            return 8

        def collate(self, idx, rng):
            if len(idx) > 1 and any(i >= 4 for i in idx):
                raise ValueError("batch-level failure")
            return list(idx)

    ld = BatchLoader(BrokenDataset(), batch_size=4, shuffle=False, num_workers=1, seed=0)
    assert len(list(ld)) == 1
    assert ld.dropped_batches == 1


@pytest.mark.parametrize("shards", [dict(num_shards=2, shard_index=0), dict(lockstep=True)])
def test_torch_loader_raises_on_unrecoverable_batch_in_lockstep(shards):
    """Ranks that step together (data shards, or a model group) never drop a
    batch: a rank that skipped one would pair its collectives with the
    others' next step."""
    class BrokenDataset:
        def __len__(self):
            return 16

        def collate(self, idx, rng):
            if len(idx) > 1 and any(i >= 4 for i in idx):
                raise ValueError("batch-level failure")
            return list(idx)

    ld = BatchLoader(BrokenDataset(), batch_size=4, shuffle=False, num_workers=2, seed=0,
                     **shards)
    with pytest.raises(RuntimeError, match="not dropped") as err:
        list(ld)
    assert isinstance(err.value.__cause__, ValueError)
    assert ld.dropped_batches == 0


def test_torch_loader_prefetch_bounds_batches_ahead():
    """A slow first batch holds the workers at ``prefetch`` batches claimed:
    the batches collated ahead of the one awaited stay bounded; all come in
    index order."""
    import threading
    import time

    class SlowFirst:
        def __init__(self):
            self.claimed, self.lock = [], threading.Lock()

        def __len__(self):
            return 64

        def collate(self, idx, rng):
            with self.lock:
                self.claimed.append(idx[0] // 4)
            if idx[0] == 0:
                time.sleep(0.3)
            return list(idx)

    ds = SlowFirst()
    ld = BatchLoader(ds, batch_size=4, shuffle=False, num_workers=4, prefetch=2, seed=0)
    it = iter(ld)
    assert next(it) == [0, 1, 2, 3]
    assert sorted(ds.claimed) == [0, 1]
    rest = list(it)
    assert [b[0] // 4 for b in rest] == list(range(1, 16))


def test_torch_dataset_collate_matches_jax(tmp_path):
    """The port's dataset copy gives the JAX package's batches (same files,
    same seeds)."""
    from genvc_tpu.data.dataset import VCDatasetConfig as JCfg, VCWaveDataset as JDs
    from genvc_tpu_torch.data.dataset import VCDatasetConfig, VCWaveDataset
    from genvc_tpu_torch.testing_synthetic import make_sine_dataset

    meta = make_sine_dataset(str(tmp_path), n=4)
    kw = dict(meta_file=meta, min_text_len=2, max_text_len=6,
              min_conditioning_length=24000, max_conditioning_length=36000)
    import random

    for is_eval in (False, True):
        want = JDs(JCfg(is_eval=is_eval, **kw)).collate([0, 3, 1], random.Random(5))
        got = VCWaveDataset(VCDatasetConfig(is_eval=is_eval, **kw)).collate(
            [0, 3, 1], random.Random(5))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
