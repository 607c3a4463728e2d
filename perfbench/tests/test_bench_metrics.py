"""Metric arithmetic on a small recorded trace, and the byte and FLOP
functions against hand counts at the flagship shapes."""

import json
import os
import types

import numpy as np
import pytest
import torch

from conftest import ROOT
from perfbench import flops, manifest, trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def ev(name, start, end, dev=CUDA):
    return types.SimpleNamespace(name=name, device_type=dev,
                                 time_range=types.SimpleNamespace(start=start, end=end))


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def small_trace():
    """A 10 ms region: a decode and a vocode span on the host, kernels of
    1 + 2 + 3 ms (two overlapping), three launches on the host."""
    return trace.Trace(Prof([
        ev("genvc.decode", 0, 4000, CPU), ev("genvc.vocode", 4500, 9000, CPU),
        ev("genvc.decode", 0, 4000, CUDA),
        ev("cudaLaunchKernel", 10, 20, CPU), ev("cudaLaunchKernel", 30, 40, CPU),
        ev("cudaLaunchKernel", 50, 60, CPU),
        ev("decode_split_logits<bf16>", 1000, 2000),
        ev("decode_split_pv<bf16>", 1500, 3500),
        ev("nvjet_gemm", 6000, 9000),
    ]), wall_s=0.010)


def test_trace_arithmetic():
    tr = small_trace()
    assert tr.whole()
    assert tr.busy_s() == pytest.approx(0.0055)            # [1, 3.5] + [6, 9] ms
    assert tr.device_s("decode_split_logits", "decode_split_pv") == pytest.approx(0.003)
    assert tr.count("decode_split") == 2
    assert tr.span_s("genvc.decode") == pytest.approx(0.004)
    assert tr.device_s_within("genvc.decode") == pytest.approx(0.003)
    gaps = dict(tr.idle_gaps())
    assert gaps["genvc.vocode"] == pytest.approx(0.0025)    # 3.5 -> 6 ms, host in vocode
    top = tr.top_ops()
    assert top[0] == ["nvjet_gemm", pytest.approx(0.003)]


def test_a_trace_that_lost_device_records_is_not_whole():
    tr = trace.Trace(Prof([ev("cudaLaunchKernel", 0, 1, CPU), ev("cudaLaunchKernel", 2, 3, CPU),
                           ev("k", 5, 6)]), wall_s=1.0)
    assert not tr.whole()


def test_the_stream_readers_on_a_recorded_trace(flagship):
    bench = manifest.load(ROOT)
    seg = {"n": 40, "codes": np.zeros(40), "tokens": np.arange(5)}
    record = {"cfg": flagship, "trace": small_trace(),
              "calls": [{"start": 0.0, "end": 0.01, "decode_steps": 4, "served": [seg],
                         "src": np.zeros((1, 16000), np.float32), "ref_samples": 72000}]}
    read = {m["name"]: manifest.metric_reader(ROOT, m["name"])(record)
            for m in manifest.per_layer(bench, "genvc-bf16.stream")}
    assert read["device.idle_share.stream"] == pytest.approx(45.0)
    assert read["pipeline.vocode_share.stream"] == pytest.approx(45.0)
    assert read["engine.step_ms.stream"] == pytest.approx(1.0)
    assert read["engine.launches_per_step.stream"] == pytest.approx(0.75)
    keys = 32 + 40 + 2
    bound = 30 * sum(flops.decode_attention_bound_s(flagship, [keys + 1 + j]) for j in range(1, 5))
    assert read["kernel.k1_roofline.stream"] == pytest.approx(100 * bound / 0.003)
    assert 0 < read["mfu.stream"] < 100


def test_decode_attention_bytes_by_hand(flagship):
    # one row, 400 keys, 4 heads of 256 in bf16: keys and values, query and
    # output, the f32 bias over the keys
    byt, flo = flops.decode_attention_bytes(flagship, [400])
    assert byt == 2 * 4 * 400 * 256 * 2 + 2 * 4 * 256 * 2 + 4 * 400
    assert flo == 4 * 4 * 400 * 256
    byt_w, _ = flops.decode_attention_bytes(flagship, [400], write=True)
    assert byt_w - byt == 2 * 4 * 256 * 2
    assert flops.decode_attention_bound_s(flagship, [400]) == pytest.approx(byt / 3.35e12)


def test_gpt_flops_by_hand(flagship):
    body, head = flops.gpt_token_flops(flagship, 100)
    assert body == 30 * (24 * 1024 ** 2 + 4 * 100 * 1024)
    assert head == 2 * 1024 * 1026
    b2, h2 = flops.gpt_segment_flops(flagship, 3, 2)
    assert b2 == sum(flops.gpt_token_flops(flagship, k)[0] for k in (1, 2, 3, 4, 5))
    assert h2 == 2 * head


def test_content_and_vocoder_flops_by_hand(flagship):
    t = 16000
    convs, length, c_in = 0, t, 1
    for c, k, s in [(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2:
        length = (length - k) // s + 1
        convs += 2 * length * c * c_in * k
        c_in = c
    n = length
    lin = 2 * n * 512 * 768 + 2 * n * 768 * 256
    pos = 2 * (n + 1) * 768 * (768 // 16) * 128       # SamePad: one output past n, cut
    layer = 2 * n * 768 * 768 * 4 + 2 * n * 768 * 3072 * 2 + 2 * 2 * n * n * 768
    cv = convs + lin + pos + 12 * layer
    got = flops.content_flops(flagship, t)
    dvae = got - cv
    # the content dVAE's encoder: two strided k3 convs, three resblocks, out
    l1, l2 = (n - 1) // 2 + 1, ((n - 1) // 2) // 2 + 1
    enc = (2 * l1 * 512 * 256 * 3 + 2 * l2 * 1024 * 512 * 3
           + 3 * (2 * 2 * l2 * 1024 * 1024 * 3 + 2 * l2 * 1024 * 1024) + 2 * l2 * 512 * 1024
           + 2 * l2 * 512 * 256)
    assert dvae == pytest.approx(enc, rel=1e-9)
    # HiFi-GAN over 8 latents: conv_pre at 32 frames, then three stages
    v = flops.vocoder_flops(flagship, 8)
    frames, ch = 32, 256
    hand = 2 * frames * 256 * 1024 * 7
    for u, k in zip((8, 8, 4), (16, 16, 8)):
        out = ch // 2
        hand += 2 * frames * ch * out * k        # transposed conv, per input frame
        frames *= u
        hand += sum(2 * frames * out * out * kr * 2 for kr in (3, 5, 7))
        ch = out
    hand += 2 * frames * ch * 1 * 7
    assert v == pytest.approx(hand, rel=1e-9)


def test_the_training_flops_count_the_step(flagship):
    with open(os.path.join(ROOT, "perfbench", "configs", "genvc-train-f32.json")) as f:
        cfg = json.load(f)
    feats = {"text_inputs": (2, 50), "audio_codes": (2, 98)}
    batch = {"wav_lengths": np.array([96000, 96000]), "text_lengths": np.array([50, 50]),
             "cond_lens": np.array([72000, 72000])}
    f = flops.train_step_flops(cfg, feats, batch)
    n = 32 + 51 + (94 + 3 + 1)
    per_row = 3 * (30 * (24 * 1024 ** 2 * n + 2 * n * n * 1024)
                   + 2 * 1024 * (258 * 52 + 1026 * 100))
    tokenizers = 2 * (flops.content_flops(cfg, 64000 + 320) + flops._acoustic(flops._key(cfg), 376))
    assert list(f) == ["float32"]
    assert 2 * per_row + tokenizers < f["float32"] < (2 * per_row + tokenizers) * 1.05
    assert flops.flash_bound_s(cfg, feats) > 0
