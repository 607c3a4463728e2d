"""The DeepSeek-V3 cell (``genvc-moonlight-bf16.stream-b8``) on the CPU at a
tiny size: its manifest entries and files, its configuration against the
published numbers, the reference's own checks, and the driver end to end."""

import argparse
import copy
import json
import math
import os

import pytest
import torch

from conftest import ROOT
from perfbench import manifest

CELL = "genvc-moonlight-bf16.stream-b8"
# Moonlight-16B-A3B's config.json (moonshotai, the shape keys)
PUBLISHED = {
    "first_k_dense_replace": 1, "hidden_size": 2048, "intermediate_size": 11264,
    "kv_lora_rank": 512, "moe_intermediate_size": 1408, "n_group": 1, "n_routed_experts": 64,
    "n_shared_experts": 2, "norm_topk_prob": True, "num_attention_heads": 16,
    "num_experts_per_tok": 6, "num_hidden_layers": 27, "q_lora_rank": None,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-5, "rope_theta": 50000,
    "routed_scaling_factor": 2.446, "scoring_func": "sigmoid", "topk_group": 1,
    "topk_method": "noaux_tc", "v_head_dim": 128, "vocab_size": 163840}


def tiny_moonlight(cfg: dict) -> dict:
    """3 layers (1 dense + 2 mixture) of width 64, 4 heads, nope 16, rope 8,
    v 16, kv_lora 32, 8 experts with top 2, 1 shared; small front end."""
    cfg = copy.deepcopy(cfg)
    cfg.update(num_hidden_layers=3, hidden_size=64, num_attention_heads=4, qk_nope_head_dim=16,
               qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32, n_routed_experts=8,
               num_experts_per_tok=2, n_shared_experts=1, intermediate_size=128,
               moe_intermediate_size=32)
    cfg["gpt"].update(layers=3, model_dim=64, heads=4, head_dim=16)
    cfg["contentvec"]["layers"] = 2
    cfg["content_dvae"].update(num_tokens=64, codebook_dim=32, hidden_dim=32, num_resnet_blocks=1)
    cfg["hifigan"].update(input_feat_dim=64, upsample_initial_channel=32)
    return cfg


@pytest.fixture
def config():
    with open(os.path.join(ROOT, "perfbench", "configs", "genvc-moonlight-bf16.json")) as f:
        return json.load(f)


def test_manifest_validates_with_the_cell_and_its_files():
    b = manifest.load(ROOT)
    assert manifest.validate(b) == []
    cell = manifest.cell(b, CELL)
    assert cell["driver"] == "stream_batch" and cell["chips"] == 1
    assert [m["name"] for m in manifest.end_to_end(b, CELL)] == [
        "setup_s", "ttfa_ms_p50", "audio_s_per_s"]
    names = [m["name"] for m in manifest.per_layer(b, CELL)]
    assert len(names) == 9 and all(n.endswith(".stream-b8") for n in names)
    for n in names:
        assert callable(manifest.metric_reader(ROOT, n))


def test_config_holds_the_published_numbers_but_the_vocabulary(config):
    entry = next(c for c in manifest.load(ROOT)["configs"] if c["name"] == "genvc-moonlight-bf16")
    assert entry["reduced"] == ["vocab_size"] == config["reduced"]
    differ = [k for k, v in PUBLISHED.items() if config[k] != v]
    assert differ == ["vocab_size"]
    assert config["hifigan"]["input_feat_dim"] == config["hidden_size"]


def _tiny_tree(cfg, seed=5):
    from perfbench import weights_moonlight

    return weights_moonlight.draw(cfg, seed, "cpu")


def test_reference_rope_is_relative_and_routing_scales(config):
    """Scores of rotated q and k depend on the positions' difference only;
    the routing picks the top-k of score + bias and its weights sum to the
    scaling factor."""
    from perfbench import weights_moonlight
    from perfbench.reference import moonlight

    cfg = tiny_moonlight(config)
    m = weights_moonlight.gpt_group(cfg)["backbone"]
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(5, 8, generator=g), torch.randn(5, 8, generator=g)
    pos = torch.arange(5)
    a = (moonlight.rope(q, pos, m) * moonlight.rope(k, pos, m)).sum(-1)
    b = (moonlight.rope(q, pos + 37, m) * moonlight.rope(k, pos + 37, m)).sum(-1)
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)   # f32 angles up to ~40 rad

    tree = moonlight.f32_tree(_tiny_tree(cfg)["gpt"]["core"]["blocks"][1]["moe"])
    x = torch.randn(7, cfg["hidden_size"], generator=g)
    out, idx, sel, taken, same, _ = moonlight.moe(tree, x, m)
    s = torch.sigmoid(x @ tree["router"]["w"])
    want = torch.topk(s + tree["router"]["bias"], m["num_experts_per_tok"]).indices
    assert torch.equal(idx, want) and out.shape == x.shape and taken.all() and same.all()
    swap = idx.clone()
    swap[:, -1] = torch.topk(s + tree["router"]["bias"], 3).indices[:, -1]  # the 3rd best
    _, used, _, taken, same, below = moonlight.moe(tree, x, m, forced=swap, tie=1.0)
    assert torch.equal(used, swap) and taken.all() and not same.any() and (below > 0).all()
    _, used, _, taken, _, _ = moonlight.moe(tree, x, m, forced=swap, tie=0.0)
    assert torch.equal(used, idx) and not taken.any()
    assert (sel[:, :-1] >= sel[:, 1:]).all()
    torch.testing.assert_close(
        (s.gather(-1, idx) / s.gather(-1, idx).sum(-1, keepdim=True)).sum(-1) *
        m["routed_scaling_factor"], torch.full((7,), m["routed_scaling_factor"]))


def test_reference_forward_is_causal_and_control_moves_it(config):
    """The logits of a position do not see later tokens; the e4m3 control
    moves the logits."""
    from perfbench import weights_moonlight
    from perfbench.reference import moonlight

    cfg = tiny_moonlight(config)
    g = weights_moonlight.gpt_group(cfg)
    p = _tiny_tree(cfg)["gpt"]
    cond = torch.randn(32, cfg["hidden_size"], generator=torch.Generator().manual_seed(1)) * 0.1
    codes = torch.tensor([3, 9, 1, 4])
    audio = torch.tensor([5, 77, 300, 12, 900])
    lat, logits, routing = moonlight.gpt_forward(p, g, cond, codes, audio)
    lat2, logits2, _ = moonlight.gpt_forward(p, g, cond, codes, audio[:3])
    torch.testing.assert_close(logits[:4], logits2, rtol=1e-5, atol=1e-5)
    assert logits.shape == (6, g["num_audio_tokens"]) and len(routing) == 2
    assert routing[0][0].shape == (44, 2) and routing[0][1].shape == (44, 3)
    _, ctl, _ = moonlight.gpt_forward(p, g, cond, codes, audio, moonlight.e4m3_rows)
    assert (ctl - logits).abs().max() > 1e-4


def test_driver_runs_the_cell_end_to_end_at_a_tiny_size(cpu_harness, config, monkeypatch):
    """Two callers in lockstep, one group traced by the recorder (no
    profiler on the CPU): the end-to-end numbers, the compared numbers and
    the program's counters."""
    from perfbench import trace
    from perfbench.drivers import stream_batch

    b = manifest.load(ROOT)
    cell = manifest.cell(b, CELL)
    cell["config"] = tiny_moonlight(cell["config"])
    cell.update(batch=2, check_rows=2, passes=1)
    cell["traffic"] = dict(cell["traffic"], requests=4,
                           src_seconds={"dist": "uniform", "low": 1.0, "high": 2.0})
    monkeypatch.setattr(trace, "traced", _untraced)
    monkeypatch.setattr(trace.Trace, "whole", lambda self: True)
    monkeypatch.setattr(trace.Trace, "count", lambda self, *a: 0)
    from genvc_tpu_torch.ops import mla
    monkeypatch.setattr(mla.mla_decode, "launches", 0)
    args = argparse.Namespace(seed=2 ** 31 + 99, seconds=0.5, trace=1)
    out = stream_batch.run(cell, args, 0.0)
    e2e = out["end_to_end"]
    assert e2e["audio_s_per_s"] > 0 and e2e["ttfa_ms_p50"] > 0
    nums = out["numbers"]
    assert set(out["limits"]) == {"logit_gap", "audio_err", "latent_err", "route_agree"}
    assert all(math.isfinite(nums[k]) for k in out["limits"])
    assert 0.5 <= nums["route_agree"] <= 1.0
    counters = out["record"]["counters"]
    assert counters["moe.experts_touched"] > 0
    (call,) = out["record"]["calls"]
    assert call["decode_steps"] > 0 and call["end"] > call["start"]
    assert out["record"]["group"]["rows"]


@pytest.mark.parametrize("name", ["engine.step_ms", "engine.enqueue_ms", "engine.readback_ms",
                                  "engine.launches_per_step", "device.idle_share",
                                  "pipeline.vocode_share"])
def test_the_cells_span_readers_read_as_the_stream_cells(name):
    """The traced group, recorded as one call, reads as the stream cell's
    calls do: one window of 8 steps (enqueue 6 ms, readback 2, vocode 1 ms)
    in a group of 20 ms, one kernel of 0.1 ms and 4 launches."""
    import types

    from perfbench import trace

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(n, start, end, dev=cpu):
        return types.SimpleNamespace(name=n, device_type=dev,
                                     time_range=types.SimpleNamespace(start=start, end=end))

    events = [ev("genvc.decode", 0, 9000), ev("genvc.decode.enqueue", 0, 6000),
              ev("genvc.decode.readback", 6000, 8000), ev("genvc.vocode", 9000, 10000),
              ev("k", 100, 200, cuda)] + [ev("cudaLaunchKernel", i, i + 1) for i in range(4)]
    tr = trace.Trace(types.SimpleNamespace(events=lambda: events), wall_s=0.02)
    rec = {"trace": tr, "calls": [{"decode_steps": 8, "start": 1.0, "end": 1.02}]}
    want = {"engine.step_ms": 9.0 / 8, "engine.enqueue_ms": 6.0 / 8,
            "engine.readback_ms": 2.0 / 8, "engine.launches_per_step": 4 / 8,
            "device.idle_share": 100.0 * (1 - tr.busy_s() / 0.02),
            "pipeline.vocode_share": 100.0 * 0.001 / 0.02}[name]
    got = manifest.metric_reader(ROOT, f"{name}.stream-b8")(rec)
    assert got == pytest.approx(want)
    assert got == manifest.metric_reader(ROOT, f"{name}.stream")(rec)


def _untraced(out):
    import contextlib
    import time
    import types

    from perfbench import trace

    @contextlib.contextmanager
    def region():
        t0 = time.perf_counter()
        yield
        out.append(trace.Trace(types.SimpleNamespace(events=lambda: []),
                               time.perf_counter() - t0))

    return region()
