"""The reference against the port on the CPU at a tiny size, the control,
and faults planted in the timed path, each seen as not correct."""

import numpy as np
import pytest
import torch

from conftest import run_cell, tiny
from perfbench import codebooks, program, traffic, weights
from perfbench.reference import check


def draw(cfg, seed):
    from conftest import ROOT

    return codebooks.fill(weights.draw(weights.inference_spec(cfg), seed, "cpu"), cfg, seed, ROOT)


def served_calls(cfg, seed, n=3):
    from perfbench.drivers import common

    pipe = program.build(cfg, draw(cfg, seed), seed, "cpu")
    rec = program.StreamRecorder(pipe)
    mix = {"arrivals": "closed", "requests": n,
           "src_seconds": {"dist": "uniform", "low": 1.5, "high": 7.5},
           "ref_seconds": {"dist": "uniform", "low": 3.0, "high": 6.0}}
    out = []
    try:
        for r in traffic.requests(mix, seed):
            src, ref = common.inputs(r)
            wav, _, _ = pipe.synthesize_streaming(src, ref, verbose=False)
            out.append({"src": src, "ref": ref, "audio": wav,
                        "served": program.host_segments(rec.take())})
    finally:
        rec.close()
    return out


def numbers(cfg, seed, calls, control=False):
    from perfbench.drivers import common

    tree = draw(cfg, seed)
    norms = common.mel_norms(cfg)
    r_ref = check.Reference(tree, cfg, norms)
    r_ctl = check.Reference(tree, cfg, norms, control=True)
    prog, ctl = [], []
    for c in calls:
        r = r_ref.request(c["src"], c["ref"], c["served"])
        prog.append(check.program_numbers(r, c["served"], c["audio"]))
        if control:
            ctl.append(check.control_numbers(r, r_ctl.request(c["src"], c["ref"], c["served"])))
    return check.summarise(prog), (check.summarise(ctl) if control else None)


def test_the_reference_matches_the_float32_port_exactly(cpu_harness, flagship):
    cfg = tiny(flagship)
    cfg["gpt"].update(dtype="float32", kv_cache_dtype="float32")
    seed = 2 ** 31 + 12345
    got, _ = numbers(cfg, seed, served_calls(cfg, seed))
    assert got["code_mismatch"] == 0.0 and got["logit_gap"] == 0.0
    assert got["audio_err"] < 1e-5 and got["latent_err"] < 1e-5
    assert got["distinct_codes"] >= 8     # the placed codebook spreads the codes


def test_the_bf16_port_passes_and_the_lower_precision_control_reads_three_times_higher(
        cpu_harness, flagship):
    cfg = tiny(flagship)
    seed = 2 ** 31 + 999
    got, ctl = numbers(cfg, seed, served_calls(cfg, seed), control=True)
    assert check.verdict(got), got
    assert ctl["audio_err"] >= 3 * got["audio_err"]
    assert ctl["logit_gap"] >= 3 * max(got["logit_gap"], 1e-3)


def _alter_token(monkeypatch):
    from genvc_tpu_torch.decode import engine

    select = engine._select_token
    calls = {"n": 0}

    def altered(logits, *a, **k):
        tok = select(logits, *a, **k)
        calls["n"] += 1
        return (tok + 1) % logits.shape[-1] if calls["n"] % 5 == 0 else tok

    monkeypatch.setattr(engine, "_select_token", altered)


def _state_unchanged(monkeypatch):
    from genvc_tpu_torch.decode import engine

    step = engine._decode_one

    def stuck(model, state, *a, **k):
        index = state.cur_index
        out = step(model, state, *a, **k)
        state.cur_index = index            # the cache position never advances
        return out

    monkeypatch.setattr(engine, "_decode_one", stuck)


def _perturb_latents(monkeypatch):
    from genvc_tpu_torch.models import dvae

    encode = dvae.DVAE.encode

    def perturbed(self, *a, **k):
        return encode(self, *a, **k) * 1.001   # most codes kept, the values off

    monkeypatch.setattr(dvae.DVAE, "encode", perturbed)


def _half_the_batch(monkeypatch):
    from genvc_tpu_torch.inference import pipeline

    vocode = pipeline.GenVCPipeline.batch_window_vocode

    def half(self, all_lats, win):
        wavs = vocode(self, all_lats, win)
        wavs[wavs.shape[0] // 2:] = 0.0   # the pool's second half left out
        return wavs

    monkeypatch.setattr(pipeline.GenVCPipeline, "batch_window_vocode", half)


@pytest.mark.parametrize("cell,fault", [
    ("genvc-bf16.stream", _alter_token),
    ("genvc-bf16.stream", _state_unchanged),
    ("genvc-bf16.stream", _perturb_latents),
    ("genvc-bf16.serve-poisson", _alter_token),
    ("genvc-bf16.serve-poisson", _half_the_batch),
])
def test_a_fault_in_the_timed_path_comes_out_not_correct(cpu_harness, monkeypatch, cell, fault):
    sound = run_cell(cell, 8.0, lead_in_seconds=1.0)
    assert sound["correct"], sound["numbers"]
    fault(monkeypatch)
    broken = run_cell(cell, 8.0, lead_in_seconds=1.0)
    assert not broken["correct"], broken["numbers"]


@pytest.mark.cuda
def test_the_stream_cell_runs_correct_on_the_card():
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from conftest import ROOT

    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                          "genvc-bf16.stream", "--seed", "2147483999", "--seconds", "5"],
                         capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    import json

    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


def test_sampling_keeps_the_longest_request():
    from perfbench.drivers import common

    done = [{"src_s": s} for s in (1.0, 9.0, 2.0, 3.0, 4.0, 5.0)]
    got = common.sample(done, 3, 2 ** 31 + 3)
    assert got[0]["src_s"] == 9.0 and len(got) == 3
    assert got == common.sample(done, 3, 2 ** 31 + 3)
    assert np.all([g in done for g in got])


# The card's limits hold float32 on the card at full width (sound runs
# 1e-7); on the CPU at the tiny width a sound float32 step reads 7e-6, a
# fault 1e-2, so the tests hold the tiny cell to limits of their own.
TINY_TRAIN_LIMITS = {"grad_gap": 1e-4, "change_gap": 1e-3, "latent_err": 1e-4}


def _train_cell(monkeypatch, tmp_path, dtype=None):
    """The training cell at the tiny size, its corpus under ``tmp_path``."""
    import tempfile

    from perfbench.reference import check_train

    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    monkeypatch.setattr(check_train, "LIMITS", TINY_TRAIN_LIMITS)
    monkeypatch.setattr(check_train.verdict, "__defaults__", (TINY_TRAIN_LIMITS,))

    def updates(cell):
        cfg = cell["config"]
        for k in ("content_dvae", "acoustic_dvae"):
            cfg[k].update(num_tokens=64, codebook_dim=32, hidden_dim=32, num_resnet_blocks=1)
        if dtype is not None:
            cfg["gpt"]["dtype"] = dtype
        cfg["train"].update(batch_size=4, max_text_len=40)
        cell["traffic"]["files"] = 8
        return cell

    from perfbench import manifest

    real = manifest.cell
    monkeypatch.setattr(manifest, "cell", lambda b, n: updates(real(b, n)))
    return run_cell("genvc-train-f32.gpt-b24", 2.0)


def test_the_training_reference_follows_the_float32_program_exactly(cpu_harness, monkeypatch,
                                                                   tmp_path):
    out = _train_cell(monkeypatch, tmp_path, dtype="float32")
    n = out["numbers"]
    assert n["code_mismatch"] == 0.0 and n["latent_err"] < 1e-5
    assert n["distinct_audio_codes"] >= 8 and n["distinct_text_codes"] >= 4
    assert n["loss_gap"] < 1e-6 and n["grad_gap"] < 1e-4 and n["change_gap"] < 1e-4


def _train_half_batch(monkeypatch):
    from genvc_tpu_torch.train import gpt_stage

    prepare = gpt_stage.prepare_features

    def half(frozen, batch, *a, **k):
        feats = prepare(frozen, batch, *a, **k)
        b = feats["text_inputs"].shape[0] // 2
        return {key: v[:b] for key, v in feats.items()}   # the mean over the rest

    monkeypatch.setattr(gpt_stage, "prepare_features", half)


def _train_state_unchanged(monkeypatch):
    from genvc_tpu_torch.train import optim

    monkeypatch.setattr(optim.AdamW, "step", lambda self, flat, grad: None)


@pytest.mark.parametrize("fault", [_train_half_batch, _train_state_unchanged, _perturb_latents])
def test_a_fault_in_the_training_step_comes_out_not_correct(cpu_harness, monkeypatch, tmp_path,
                                                            fault):
    assert _train_cell(monkeypatch, tmp_path)["correct"]
    fault(monkeypatch)
    broken = _train_cell(monkeypatch, tmp_path)
    assert not broken["correct"], broken["numbers"]
