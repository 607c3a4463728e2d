"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 1 builds every hand-written kernel from ``genvc_tpu_torch/csrc`` (one
``nvcc`` per source, all in parallel), checks each against its plain PyTorch
version at the shapes the paths give it, and times kernel, plain version and
the library yardstick with CUDA events: K1 (cached decode attention, split
over the cache length; K2 is K1 with L = 1) at the flagship decode shape and
at B in {1, 4, 8, 16} x T in {128, 384, 1024}, K3 (the per-row cache write
and attention of the serving pool, K1's split with the write folded into its
logits pass: caches bit-equal to the plain version's, a row past the cache
end untouched, rows on both edges of a key range) at the pool's shapes and
at T = 128 and 1024, K4 (flash-attention
forward, O and LSE; bf16 on the tensor cores) at the latent pass's and the
training step's shapes and at its tile edges, K5 / K6 (flash-attention
backward: dq; dk and dv; bf16 on the tensor cores) at the training step's
shapes (T = 184 and 328) and at tile edges, with device times (a
``torch.profiler`` trace) beside SDPA's backward; K4, K5 and K6 also at the
tensor-parallel step's 2 local heads (B = 8, T = 184, bf16) and K3 at a
server shard's 4 rows. It holds K1 and K3 to the
JAX package's e4m3 rule at overflow (0x7F / 0xFF stored past 464, read as
+-480) and records each build's registers, spills and shared memory
(``-Xptxas -v``). Kernel / library ratios are printed for K1, K2, K4 and
K5 + K6. The beam reorder (``engine.reorder_rows``, an ``index_select`` of
the cache by parent beam) at the flagship cache of 4 beams, bf16 and e4m3:
rows bit-equal to their parents', K1 on the reordered cache against its
plain version, and its device time against its byte bound. The LayerNorm
kernel (``csrc/layer_norm.cu``, no TPU kernel) at the decode step's call (1
x 1024 bf16, bf16 and f32 parameters) and at the training features' (24 x
500 x 768 f32): within one bf16 ulp / 1e-5 of its plain version, one launch
a call, timed beside the plain ops and ``F.layer_norm`` with each one's host
microseconds a call. The DeepSeek-V3 backbone's kernels (no TPU kernels) at
Moonlight-16B-A3B's widths: the RMS mode of ``csrc/layer_norm.cu`` at 8 x
2048 and at 920 x 512 with rows 576 apart, ``mla_decode`` (absorbed latent
attention, ``csrc/mla_decode.cu``) at 8 rows x 384 positions, 16 heads, 512
+ 64, and ``moe_experts`` (``csrc/moe_experts.cu``) at 8 and 920 rows x 6 of
64 experts: each against its plain version, one counted call, and timed
beside it and a library yardstick (``F.rms_norm``, SDPA, ``torch._grouped_mm``).

Phase 2 first checks the host audio loader: the native library
(``native/audioio.cpp``) builds, ``load_audio`` takes it on the sample wavs
(within 1e-6 of the numpy path) and gives fault C.6's inputs (a 24 kHz stereo
wav cut in its header: ``None``; cut in its data chunk: (1, 7996) / (1, 11994)
at 16 / 24 kHz) what the JAX package gives. It holds the int8 product of the quantized linears (``ops.quant``:
``torch._int_mm`` on the card) to its exact CPU version at the decode rows
(1, 8, 16) and beyond, and at the heads' widths (1026, 258): int8 weights,
activations and int32 accumulators equal, outputs within 1e-6; and times one
block's four int8 products against bf16 ``torch.matmul`` at m = 1, 8, 16 and
a prefill's 115 rows. K1 with an f32 GPT's queries over an e4m3 cache (hd 16
and 256) must lie within ``bf16_rounding_bound`` of f32 attention over the
widened cache, the CPU engine's path. It then runs a small f32 configuration on the card and
on the CPU with the same weights: streaming, offline ``synthesize``,
``synthesize_batch`` and a 2-slot ``StreamServer`` (three streams, one
arriving mid-flight), offline beam search (3 beams), group beam search (4
beams, 2 groups) and contrastive search (4 candidates), and streaming with
int8 linears and with an fp8 cache (K1 on the card) must give the same
lengths and audio within 1e-3; beam_sample (3 beams) with one noise sequence handed to both
the same tokens; two GPT training steps (K4 / K5 / K6 on the card) must
give the same codes, losses, gradient norms and parameters. The port's CLI
then streams one utterance with ``--bf16 --profile DIR`` on a small bundle
of 64 mel tokens, whose last window steps past the cap (fault C.7): the
trace must hold K1's two CUDA kernels, and its ``counters.json`` the
LayerNorm kernel's launches (``ops.layer_norm.kernel``, 62 a decode step at
least).

Phase 3 drives every ported path through its entry points at flagship width
(GPT 30 layers x 1024, 4 heads, bf16; ContentVec 12 layers; content dVAE
256 ch; default HiFi-GAN) with seeded random weights on the repo's sample
wavs: ``synthesize_streaming`` (3 runs), ``synthesize`` on a 7.68 s source
(two segments; 1 run), ``synthesize_batch`` / ``synthesize_streaming_batch``
with 4 utterances (1 run each), each after one warm-up, and a ``StreamServer``
of 8 slots draining 16 streams submitted at once (1 drain after
``warmup_admission``);
and on the 1.54 s source offline beam search and beam_sample (4 beams), group
beam search (4 beams, 2 groups), contrastive search (4 candidates) and, at
the engine level, constrained beam search (4 beams, one two-token phrase),
each once to warm up and once timed. It checks the audio and that the
kernels of each path were launched as often as the path says: K1 30 times
per lockstep decode step (a search's forward at B = beams or candidates),
K4 30 times per latent pass, K3 30 times per per-row decode step of the
server (and the others not at all there), and in streaming the LayerNorm
kernel 62 times a decode step at least.
Phase 6d runs there, on that pipeline.

Phase 3b builds the quantized serving configuration at flagship width (bf16
GPT, ``quantize="int8"``, ``kv_cache_dtype="fp8"``) from the same weights:
its GPT's weight bytes beside the bf16 GPT's, prefill logits within 0.05
relative of the bf16 pipeline's, one decode step's device time and kernel
launches in both, then ``synthesize_streaming`` (1 run after a warm-up),
``synthesize`` on the 7.68 s source (1 run) and the 16-stream drain into 8
slots (1 drain after ``warmup_admission``), each checked as in phase 3 (K1
on the e4m3 cache 30 per lockstep step, K3 30 per per-row step, K4 30 per
latent pass) and with the int8 product launched 4 x 30 + 1 times per
forward (4 x 30 per latent pass); its RTF, latency and drain RTF are
printed beside phase 3's.

Phase 4 trains the GPT at flagship width (stage 3, bf16 on f32 masters,
attention kernels K4 forward, K5 / K6 backward) through
``train.runner.run_gpt_training`` on wavs tiled from the samples, B = 8 with
50-token texts: one epoch of 1 warm-up and 5 timed steps (K4 = K5 = K6 = 30
a step, K1 = K3 = 0), one eval batch (K4 30 more) and, at the epoch's end,
the two listening samples (f32 decode, the acoustic dVAE's decode,
Griffin-Lim), finite and each passing ``check_audio``; a checkpoint written
and resumed for one more step; then, on one
fixed batch, steps timed with a device sync (losses must fall), the same
step with ``attn_impl="xla"`` in turns with the kernels'; on that batch the
loss and gradients with ``remat=True`` and ``"dots"`` bit-equal to the step
without (K4 = 60, K5 = K6 = 30: the recompute runs K4 again), each
setting's step ms and peak memory, the bf16 ContentVec's code flip share and
time against f32 and one ``content_dtype`` step; and one step at the
recipe's B = 24 with 100-token texts for peak memory.

Phase 5 trains the other stages. A small f32 configuration runs one GAN step
(four discriminator families at their smallest filters; K4 on the card) and
one dVAE step on the card and on the CPU: losses, parameters, spectral-norm
buffers and the EMA codebook must agree. K4 is held to its plain version at
the vocoder stage's latent pass (the frozen f32 GPT, B = 64, T = 64) and
timed beside masked SDPA. Stage 4 then runs at the recipe's full width
through ``train.runner.run_vocoder_training`` (``train_vocoder``'s config:
batch 64 of 0.64 s segments, all four families at ``VocoderConfig()``, a
seeded 30 x 1024 GPT written through ``export_gpt``): 1 warm-up and 2 timed
steps and a checkpoint (K4 = 30 a step, K1 = K3 = K5 = K6 = 0), then steps
on one fixed batch timed to a device sync and two traced for device busy
time and launches; and stages 1 and 2 at their recipes through
``run_vae_training`` (batch 256 of 6 s mel crops; batch 64 of 6 s crops
through the 12-layer ContentVec), 3 steps and a checkpoint each, then fixed-
batch steps with peak memory.

Phase 6 runs the parallel paths with ranks that share the card over gloo
(``genvc_tpu_torch.parallel.launch.run_ranks``; NCCL refuses two ranks on
one device): a transport probe (``all_reduce``, ``all_gather`` and
``broadcast`` on CUDA tensors, the all-reduce timed); 6a, the GPT step
tensor-parallel on 2 ranks at full width and depth (30 x 1024, each rank 2
of the 4 heads) on phase 4's fixed batch, and 6b, 2 x 2 (data x model) on 4
ranks at 2 layers, each 2 steps in f32 and in bf16 on f32 masters against
the one-process step on the same card and batch (loss, gradient norm,
every parameter), K4 = K5 = K6 = 30 (6a) a rank a step; 6c, stages 1, 2
and 4 data-parallel on 2 ranks at their recipes' widths with the batch cut
(dVAE codebooks against the one-process step, GAN losses, spectral-norm
buffers equal across the ranks); 6d, ``StreamServer(slots=8,
mesh=make_mesh(n_data=2, devices=[cuda:0, cuda:0]))`` at flagship width,
bf16, greedy: 8 streams within 2e-4 of unsharded 4-slot servers, then 16
streams with K3 30 a shard's decode step and the drain's RTF and first-audio
latency beside phase 3's.

Prints measurements on earlier lines, the kernel table as one JSON line, the
GPU's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero on any failure or when no
CUDA device is present.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12            # H100 SXM f32 outside the tensor cores
FLAGSHIP = dict(L=30, H=4, T=384, hd=256)
TOL = 2e-2  # K1 vs plain: same casts; bf16 probabilities and bf16 output
            # round at 2^-8 relative, f32 sums differ in order
# K4 vs plain: the plain version computes in f32 from the same inputs with
# an unrounded p; the bf16 kernel rounds p to bf16 before P.V on the tensor
# cores (2^-9 of each weight, an error under O's own bf16 rounding), the f32
# kernel does not; the sums run in another order (f32, ~1e-6 relative). A
# bf16 O is then rounded to bf16 on both sides, so one rounding may land a
# bf16 ulp apart (2^-8 relative). LSE comes from the f32 p on both sides.
FLASH_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# the tensor-parallel GPT step's shape (phase 6a): each of 2 model ranks
# attends 2 of the 4 heads, q, k and v strided views of its (B, T, 3 x 2 x
# 256) projection; a ninth entry is the head count (4 where it is absent)
TP_CASE = (8, 184, 256, torch.bfloat16, 0, 0, False, True, 2)
LSE_TOL = 1e-4
# (B, T, hd, dtype, masked key tail of the last row, masked leading keys of
# row 0, row 0 all masked, causal): the latent pass's shapes (T = 308 for a
# full 6 s segment, 180 for the 1.68 s tail of the flagship source),
# batched, in f32, the small configuration's hd = 16; the training step's
# shapes (T = 184 at 50-token texts, 328 at the recipe's 100); the tile
# edges of the bf16 kernel (16 query rows, 64 keys a tile): T below one
# tile, T not a multiple of it, hd 64 and 72 (padded to 80 in shared
# memory), rows before the first valid key, and a non-causal row with no
# valid key (both the uniform mean over the padded width)
FLASH_CASES = [(1, 308, 256, torch.bfloat16, 0, 0, False, True),
               (1, 180, 256, torch.bfloat16, 0, 0, False, True),
               (1, 308, 256, torch.bfloat16, 57, 0, False, True),
               (8, 308, 256, torch.bfloat16, 57, 0, False, True),
               (1, 308, 256, torch.float32, 0, 0, False, True),
               (1, 180, 16, torch.float32, 23, 0, False, True),
               (8, 184, 256, torch.bfloat16, 0, 0, False, True),
               (8, 328, 256, torch.bfloat16, 0, 0, False, True),
               (1, 11, 256, torch.bfloat16, 0, 0, False, True),
               (2, 77, 256, torch.bfloat16, 5, 0, False, True),
               (2, 184, 64, torch.bfloat16, 9, 0, False, True),
               (2, 184, 72, torch.bfloat16, 9, 0, False, True),
               (2, 184, 256, torch.bfloat16, 0, 37, False, True),
               (2, 136, 256, torch.bfloat16, 11, 0, True, False),
               (2, 136, 64, torch.float32, 11, 0, True, False),
               TP_CASE]
# K1 cases beyond the flagship shape (B, T): batch rows x cache lengths
DECODE_SHAPES = [(b, t) for b in (1, 4, 8, 16) for t in (128, 384, 1024)]


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=200, warmup=10) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=50, warmup=5, tries=3, same_per_call=True):
    """Device time of one call of ``fn``: the summed durations of the CUDA
    kernels its calls launch, traced with ``torch.profiler`` over ``iters``
    calls, and the kernels launched per call. ``time_ms`` over a loop of
    calls is bounded below by the host's time per call (the wrapper's Python
    and the launches), which for these small kernels exceeds the device's.

    The tracer now and then loses device records (one run kept 14 of 100).
    A trace counts only if it holds a device record for every launch the
    host made (the ``*LaunchKernel*`` runtime calls it traced) and, with
    ``same_per_call``, the same number for each call; else it is taken again,
    up to ``tries`` times, and then the time is not measured (None, None).
    Without ``same_per_call`` (a decode step, whose copies vary from call to
    call) the second number is the host's kernel launches per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        spans = [ev.time_range for ev in events
                 if ev.device_type == torch.autograd.DeviceType.CUDA]
        n_launch = sum(1 for ev in events if ev.device_type != torch.autograd.DeviceType.CUDA
                       and "LaunchKernel" in ev.name)
        if spans and len(spans) >= n_launch and (not same_per_call or len(spans) % iters == 0):
            per_call = len(spans) // iters if same_per_call else n_launch / iters
            return sum(tr.end - tr.start for tr in spans) / iters / 1e3, per_call
        print(f"device_ms: the trace held {len(spans)} device records for {n_launch} "
              f"launches in {iters} calls: taken again", flush=True)
    print(f"device_ms: no complete trace in {tries} tries: not measured", flush=True)
    return None, None


def kernel_profile(fn, n=6):
    """One traced call of ``fn``: its kernels' summed device ms, the device
    records and the host's kernel launches in the trace (equal unless the
    tracer lost records), and the ``n`` kernels with the most device time
    {name cut to 80 characters: ms}."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    totals, records, launches = {}, 0, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            key = ev.name[:80]
            totals[key] = totals.get(key, 0.0) + (ev.time_range.end - ev.time_range.start) / 1e3
            records += 1
        elif "LaunchKernel" in ev.name:
            launches += 1
    return {"device_ms": sum(totals.values()), "device_records": records,
            "launches": launches,
            "top_ms": dict(sorted(totals.items(), key=lambda kv: -kv[1])[:n])}


def ratio(a, b):
    return a / b if a and b else None


def decode_inputs(b, cache_dtype, q_dtype, seed, T=FLAGSHIP["T"]):
    L, H, hd = FLAGSHIP["L"], FLAGSHIP["H"], FLAGSHIP["hd"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, H, hd, generator=g, device="cuda").to(q_dtype)
    ck = torch.randn(L, b, H, T, hd, generator=g, device="cuda").to(cache_dtype)
    cv = torch.randn(L, b, H, T, hd, generator=g, device="cuda").to(cache_dtype)
    lens = torch.randint(T // 4, T + 1, (b,), generator=g, device="cuda")
    if b > 1:
        lens[0] = 1  # a row with a single valid key
    valid = torch.arange(T, device="cuda")[None, :] < lens[:, None]
    bias = torch.where(valid, 0.0, -1e9).float()
    return q, ck, cv, bias


def check_decode_attention(da):
    """K1 vs its plain version: the flagship decode shape in every cache / q
    type, and bf16 at B in {1, 4, 8, 16} x T in {128, 384, 1024} (row 0 of a
    batch has a single valid key). Times kernel, plain version and SDPA;
    returns the timing record of the main-path configuration (bf16 cache,
    bf16 q, B=1, T=384) and of the beam searches' shape (B=4, T=384)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    L, H, T, hd = FLAGSHIP["L"], FLAGSHIP["H"], FLAGSHIP["T"], FLAGSHIP["hd"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    main = beam = None
    bf = torch.bfloat16
    cases = ([(1, T, bf, bf)] + [(b, t, bf, bf) for b, t in DECODE_SHAPES if (b, t) != (1, T)]
             + [(1, T, torch.float8_e4m3fn, bf), (16, T, torch.float8_e4m3fn, bf),
                (4, 1024, torch.float8_e4m3fn, bf), (1, T, bf, torch.float32),
                (8, 1024, bf, torch.float32), (1, T, torch.float8_e4m3fn, torch.float32),
                (16, T, torch.float8_e4m3fn, torch.float32)])
    for i, (b, t, cdt, qdt) in enumerate(cases):
        q, ck, cv, bias = decode_inputs(b, cdt, qdt, seed=i, T=t)
        worst = 0.0
        for layer in (0, 13, L - 1):
            got = da.decode_attention_layer(q, ck, cv, bias, layer).float()
            torch.cuda.synchronize()
            want = da.decode_attention_layer_plain(q, ck, cv, bias, layer).float()
            err = (got - want).abs()
            worst = max(worst, float(err.max()))
            if not bool((err <= TOL + TOL * want.abs()).all()):
                raise AssertionError(f"decode_attention B={b} T={t} cache={cdt} q={qdt} "
                                     f"layer={layer}: max |err| {float(err.max())}")
        # time over every layer in turn (the decode step's access pattern)
        lidx = iter(range(10 ** 9))
        ms = time_ms(lambda: da.decode_attention_layer(q, ck, cv, bias, next(lidx) % L))
        plain_ms = time_ms(lambda: da.decode_attention_layer_plain(q, ck, cv, bias,
                                                                   next(lidx) % L), iters=50)
        lib_ms = None
        if cdt == bf and qdt == bf:
            q4, m4 = q[:, :, None, :], bias[:, None, None, :].to(bf)
            def lib_call():
                layer = next(lidx) % L
                return sdpa(q4, ck[layer], cv[layer], attn_mask=m4)
            lib_ms = time_ms(lib_call)
            lib_dev, _ = device_ms(lib_call)
        dev, per_call = device_ms(lambda: da.decode_attention_layer(q, ck, cv, bias,
                                                                    next(lidx) % L))
        n_bytes = (2 * b * H * t * hd * ck.element_size() + q.numel() * q.element_size()
                   + bias.numel() * 4 + q.numel() * q.element_size())
        flops = 4 * b * H * t * hd
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        rec = {"B": b, "T": t, "cache": str(cdt).replace("torch.", ""),
               "q": str(qdt).replace("torch.", ""), "keys_per_split": da.split_len(b * H, t, da.SPLIT_BLOCKS_PER_SM * n_sm),
               "cuda_launches_per_call": per_call, "max_abs_err": worst, "tol": TOL,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "ratio": ms / lib_ms if lib_ms else None, "device_ms": dev,
               "library_device_ms": lib_dev if lib_ms else None,
               "device_ratio": ratio(dev, lib_dev) if lib_ms else None,
               "bound_ms": bound_ms, "bytes": n_bytes}
        print("decode_attention_layer " + json.dumps(rec), flush=True)
        if i == 0:
            main = rec
        if (b, t, cdt, qdt) == (4, T, bf, bf):
            beam = rec
        del q, ck, cv, bias
    # K2 (single-layer cache) is the same kernel with L = 1
    b = 2
    q, ck, cv, bias = decode_inputs(b, bf, bf, seed=99)
    k2, v2 = ck[3], cv[3]  # contiguous (B, H, T, hd) layer views
    got = da.decode_attention(q, k2, v2, bias).float()
    want = da.decode_attention_plain(q, k2, v2, bias).float()
    err = float((got - want).abs().max())
    if err > TOL + TOL * float(want.abs().max()):
        raise AssertionError(f"decode_attention L=1: max |err| {err}")
    m4 = bias[:, None, None, :].to(bf)
    n_bytes = 2 * b * H * T * hd * 2 + 2 * q.numel() * 2 + bias.numel() * 4
    rec = {"B": b, "cache": "bfloat16", "q": "bfloat16", "keys_per_split": da.split_len(b * H, T, da.SPLIT_BLOCKS_PER_SM * n_sm),
           "max_abs_err": err, "tol": TOL,
           "ms": time_ms(lambda: da.decode_attention(q, k2, v2, bias)),
           "plain_ms": time_ms(lambda: da.decode_attention_plain(q, k2, v2, bias), iters=50),
           "library_ms": time_ms(lambda: sdpa(q[:, :, None, :], k2, v2, attn_mask=m4)),
           "bound_ms": max(n_bytes / HBM_BYTES_PER_S, 4 * b * H * T * hd / BF16_FLOPS) * 1e3,
           "bound_by": "bytes", "bytes": n_bytes}
    rec["ratio"] = rec["ms"] / rec["library_ms"]
    rec["device_ms"], rec["cuda_launches_per_call"] = device_ms(
        lambda: da.decode_attention(q, k2, v2, bias))
    rec["library_device_ms"], _ = device_ms(lambda: sdpa(q[:, :, None, :], k2, v2, attn_mask=m4))
    rec["device_ratio"] = ratio(rec["device_ms"], rec["library_device_ms"])
    print("decode_attention (L=1) " + json.dumps(rec), flush=True)
    return main, beam


def check_beam_reorder(da, engine, gpu):
    """The beam reorder at the flagship cache of 4 beams (30 x 4 x 4 x 384 x
    256, bf16 and e4m3): each row equals its parent's bit for bit under a
    parent vector with a cycle and a repeat, and K1 on the reordered cache
    (a buffer ``index_select`` wrote) agrees with its plain version. Device
    time of one reorder (K and V, key_valid, seen) against its byte bound
    (read and write both caches once). Returns the bf16 record."""
    L, H, T, hd = FLAGSHIP["L"], FLAGSHIP["H"], FLAGSHIP["T"], FLAGSHIP["hd"]
    nb = 4
    parent = torch.tensor([1, 2, 0, 1], device="cuda")
    recs = {}
    for cdt in (torch.bfloat16, torch.float8_e4m3fn):
        q, ck, cv, bias = decode_inputs(nb, cdt, torch.bfloat16, seed=7)
        state = engine.DecodeState(
            cache_k=ck, cache_v=cv, key_valid=bias == 0, cur_index=T - 1, n_generated=1,
            last_token=torch.zeros(nb, dtype=torch.long, device="cuda"),
            seen=torch.zeros(nb, 1026, dtype=torch.bool, device="cuda"),
            finished=torch.zeros(nb, dtype=torch.bool, device="cuda"), generator=None)
        bits = (lambda x: x.view(torch.uint8) if x.element_size() == 1 else x.view(torch.int16))
        want_k, want_v = bits(ck)[:, parent].clone(), bits(cv)[:, parent].clone()
        spare = (torch.empty_like(ck), torch.empty_like(cv))
        spare = engine.reorder_rows(state, parent, spare)
        if not (torch.equal(bits(state.cache_k), want_k) and torch.equal(bits(state.cache_v),
                                                                          want_v)):
            raise AssertionError(f"beam reorder {cdt}: rows differ from their parents'")
        bias = bias[parent]
        worst = 0.0
        for layer in (0, L - 1):
            got = da.decode_attention_layer(q, state.cache_k, state.cache_v, bias, layer).float()
            want = da.decode_attention_layer_plain(q, state.cache_k, state.cache_v, bias,
                                                   layer).float()
            err = (got - want).abs()
            worst = max(worst, float(err.max()))
            if not bool((err <= TOL + TOL * want.abs()).all()):
                raise AssertionError(f"K1 on a reordered {cdt} cache: max |err| {worst}")

        def reorder():
            nonlocal spare
            spare = engine.reorder_rows(state, parent, spare)

        dev, per_call = device_ms(reorder, iters=20)
        n_bytes = 2 * 2 * ck.numel() * ck.element_size()
        rec = {"B": nb, "T": T, "cache": str(cdt).replace("torch.", ""),
               "bytes": n_bytes, "device_ms": dev, "launches_per_call": per_call,
               "ms": time_ms(reorder, iters=20, warmup=2),
               "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
               "k1_on_reordered_max_abs_err": worst, "tol": TOL, "gpu": gpu}
        print("beam_reorder " + json.dumps(rec), flush=True)
        recs[rec["cache"]] = rec
        del q, ck, cv, state, spare
    return recs["bfloat16"]


def flash_inputs(b, t, hd, dtype, tail, seed, h=4):
    """q, k, v as the latent pass gives them: strided (B, H, T, hd) views of
    one fused (B, T, 3 * H * hd) projection; the last row's last ``tail``
    keys masked."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, t, 3 * h * hd, generator=g, device="cuda").to(dtype)
    q, k, v = (x.reshape(b, t, h, hd).transpose(1, 2) for x in qkv.chunk(3, dim=-1))
    valid = torch.ones(b, t, dtype=torch.bool, device="cuda")
    if tail:
        valid[-1, t - tail:] = False
    return q, k, v, valid


def check_flash_attention(fa):
    """K4 vs its plain version on O and LSE at the latent pass's and the
    training step's shapes and at the bf16 kernel's tile edges; times
    kernel, plain version, SDPA with the same boolean mask and, where nothing
    is masked, SDPA with ``is_causal=True`` (the fused flash backend).
    Returns the timing records of the main-path shape (B=1, T=308, bf16) and
    of the training step's (B=8, T=184, bf16)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    recs = {}
    for i, case in enumerate(FLASH_CASES):
        b, t, hd, dt, tail, lead, unseen, causal = case[:8]
        h = case[8] if len(case) > 8 else 4
        q, k, v, valid = flash_inputs(b, t, hd, dt, tail, seed=100 + i, h=h)
        if lead:
            valid[0, :lead] = False
        if unseen:
            valid[0] = False
        got_o, got_lse = fa.flash_attention_fwd(q, k, v, valid, None, causal)
        torch.cuda.synchronize()
        want_o, want_lse = fa.flash_attention_plain(q, k, v, valid, None, causal)
        err_o = (got_o.float() - want_o.float()).abs()
        err_lse = float((got_lse - want_lse).abs().max())
        tol = FLASH_TOL[dt]
        if not bool((err_o <= tol + tol * want_o.float().abs()).all()) or err_lse > LSE_TOL:
            raise AssertionError(f"flash_attention B={b} T={t} hd={hd} {dt} tail={tail} "
                                 f"lead={lead} unseen={unseen} causal={causal}: "
                                 f"max |err| O {float(err_o.max())}, LSE {err_lse}")
        mask = valid[:, None, None, :]
        if causal:
            mask = mask & torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
        elt = q.element_size()
        n_bytes = 4 * b * h * t * hd * elt + b * h * t * 4 + b * t
        # q.k and p.v over the pairs the causal mask keeps
        flops = 2 * b * h * t * ((t + 1) if causal else 2 * t) * hd
        peak = BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS
        ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, valid, None, causal))
        lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask))
        dev, _ = device_ms(lambda: fa.flash_attention_fwd(q, k, v, valid, None, causal))
        lib_dev, _ = device_ms(lambda: sdpa(q, k, v, attn_mask=mask))
        lib_causal_ms = lib_causal_dev = None
        if causal and not (tail or lead or unseen):
            lib_causal_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True))
            lib_causal_dev, _ = device_ms(lambda: sdpa(q, k, v, is_causal=True))
        rec = {"B": b, "H": h, "T": t, "hd": hd, "dtype": str(dt).replace("torch.", ""),
               "masked_tail": tail, "masked_lead": lead, "row_without_keys": unseen,
               "causal": causal, "max_abs_err": float(err_o.max()),
               "max_abs_err_lse": err_lse, "tol": tol, "tol_lse": LSE_TOL, "ms": ms,
               "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, valid, None,
                                                                    causal), iters=50),
               "library_ms": lib_ms, "ratio": ms / lib_ms,
               "library_causal_ms": lib_causal_ms,
               "ratio_causal": ms / lib_causal_ms if lib_causal_ms else None,
               "device_ms": dev, "library_device_ms": lib_dev, "device_ratio": ratio(dev, lib_dev),
               "library_causal_device_ms": lib_causal_dev,
               "device_ratio_causal": ratio(dev, lib_causal_dev),
               "bound_ms": max(n_bytes / HBM_BYTES_PER_S, flops / peak) * 1e3,
               "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= flops / peak
               else "operations", "bytes": n_bytes, "flops": flops}
        print("flash_attention " + json.dumps(rec), flush=True)
        recs[case] = rec
    return (recs[1, 308, 256, torch.bfloat16, 0, 0, False, True],
            recs[8, 184, 256, torch.bfloat16, 0, 0, False, True], recs[TP_CASE])


# K5 / K6 vs the plain backward computed in f32 from the same inputs: the
# kernels sum in f32 in a fixed order; a bf16 dq / dk / dv is then rounded to
# bf16 (2^-8 relative) while the f32 reference is not, and the bf16 kernels
# round p and ds to bf16 before the second products (ds in two bf16 parts
# where a row sees no valid key).
BWD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# (B, T, hd, dtype, masked key tail of the last row, masked leading keys of
# row 0, row 0 all masked, causal): the training step's shape (32 cond + 52
# text + 100 audio positions at 50-token texts), the recipe's 100-token
# maximum, a masked tail, f32 with rows before the first valid key, the small
# configuration's hd = 16, and non-causal with a row that sees no valid key;
# then the bf16 kernels' edges: rows before the first valid key (ds in two
# parts), and hd = 72 (padded to 80 in shared memory) with a row that sees
# no valid key
BWD_CASES = [(8, 184, 256, torch.bfloat16, 0, 0, False, True),
             (8, 328, 256, torch.bfloat16, 0, 0, False, True),
             (8, 184, 256, torch.bfloat16, 37, 0, False, True),
             (2, 184, 256, torch.float32, 37, 5, False, True),
             (2, 184, 16, torch.float32, 23, 0, False, True),
             (2, 136, 64, torch.float32, 11, 0, True, False),
             (2, 328, 256, torch.bfloat16, 45, 37, False, True),
             (2, 136, 72, torch.bfloat16, 11, 0, True, False),
             TP_CASE]
# the rows timed on the device as well (T = 184 and 328 at the step's B = 8,
# and the tensor-parallel step's 2 local heads)
BWD_DEVICE_ROWS = (0, 1, 8)


def check_flash_backward(fa):
    """K5 and K6 vs the plain backward (f32, same inputs) at the training
    step's shapes: q, k, v strided views of the fused projection, dO the
    (B, H, T, hd) view of a (B, T, H, hd) gradient, as the step gives them.
    Times K5, K6, their wrapper (with D = rowsum(dO * O)), the plain version
    and SDPA's backward (additive mask, autograd over a retained forward
    graph); at BWD_DEVICE_ROWS also their device times. Returns the records of the
    training shapes (B=8, bf16, T=184 and T=328)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    recs = []
    for i, case in enumerate(BWD_CASES):
        b, t, hd, dt, tail, lead, unseen, causal = case[:8]
        h = case[8] if len(case) > 8 else 4
        q, k, v, valid = flash_inputs(b, t, hd, dt, tail, seed=300 + i, h=h)
        if lead:
            valid[0, :lead] = False
        if unseen:
            valid[0] = False
        g = torch.Generator(device="cuda").manual_seed(400 + i)
        do = torch.randn(b, t, h, hd, generator=g, device="cuda").to(dt).transpose(1, 2)
        out, lse = fa.flash_attention_fwd(q, k, v, valid, None, causal)
        got = fa.flash_attention_bwd(q, k, v, valid, out, lse, do, None, causal)
        torch.cuda.synchronize()
        f = [x.float() for x in (q, k, v, out, do)]
        want = fa.flash_attention_bwd_plain(f[0], f[1], f[2], valid, f[3], lse, f[4],
                                            None, causal)
        tol = BWD_TOL[dt]
        errs = {}
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            err = (a.float() - w).abs()
            errs[name] = float(err.max())
            if not bool((err <= tol + tol * w.abs()).all()):
                raise AssertionError(f"flash_attention backward B={b} T={t} hd={hd} {dt} "
                                     f"tail={tail} lead={lead} unseen={unseen} "
                                     f"causal={causal}: {name} max |err| {errs[name]}")
        lse_c, dd, g_, valid_c, qkv_st, g_st = fa._bwd_args(q, k, v, valid, out, lse, do)
        args = (q, k, v, valid_c, lse_c, dd, g_, 1.0 / hd ** 0.5, causal, qkv_st, g_st)
        dq_ms = time_ms(lambda: fa.flash_attention_dq(*args))
        dkdv_ms = time_ms(lambda: fa.flash_attention_dkdv(*args))
        ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, valid, out, lse, do, None, causal))
        plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, valid, out, lse, do,
                                                                None, causal), iters=20)
        ok = valid[:, None, None, :]
        if causal:
            ok = ok & torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
        bias = torch.where(ok, 0.0, -1e9).to(dt)
        # SDPA's backward alone: autograd over one retained forward graph
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        lib_out = sdpa(*leaves, attn_mask=bias)

        def lib_bwd():
            return torch.autograd.grad(lib_out, leaves, do, retain_graph=True)
        lib_ms = time_ms(lib_bwd, iters=50)
        dev = {}
        if i in BWD_DEVICE_ROWS:
            dev["dq"], _ = device_ms(lambda: fa.flash_attention_dq(*args))
            dev["dkdv"], _ = device_ms(lambda: fa.flash_attention_dkdv(*args))
            dev["library"], _ = device_ms(lib_bwd)
        elt, n, bht = q.element_size(), b * h * t * hd, b * h * t
        frac = 0.5 if causal else 1.0
        peak = BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS
        # inputs q, k, v, dO, LSE, D and the key mask read once; outputs once
        stats = 2 * bht * 4 + b * t
        bounds = {name: (n_bytes, flops, max(n_bytes / HBM_BYTES_PER_S, flops / peak) * 1e3)
                  for name, n_bytes, flops in (
                      ("dq", 5 * n * elt + stats, 3 * 2 * b * h * t * t * hd * frac),
                      ("dkdv", 6 * n * elt + stats, 4 * 2 * b * h * t * t * hd * frac),
                      ("both", 7 * n * elt + stats, 5 * 2 * b * h * t * t * hd * frac))}
        rec = {"B": b, "H": h, "T": t, "hd": hd, "dtype": str(dt).replace("torch.", ""),
               "masked_tail": tail, "masked_lead": lead, "row_without_keys": unseen,
               "causal": causal, "max_abs_err": errs, "tol": tol,
               "dq_ms": dq_ms, "dkdv_ms": dkdv_ms, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms,
               "dq_device_ms": dev.get("dq"), "dkdv_device_ms": dev.get("dkdv"),
               "library_device_ms": dev.get("library"),
               "device_ratio": ratio(dev["dq"] + dev["dkdv"], dev["library"])
               if dev.get("dq") and dev.get("dkdv") else None,
               "bound_ms": {k_: v_[2] for k_, v_ in bounds.items()},
               "bound_by": {k_: "bytes" if v_[0] / HBM_BYTES_PER_S >= v_[1] / peak
                            else "operations" for k_, v_ in bounds.items()},
               "bytes": {k_: v_[0] for k_, v_ in bounds.items()},
               "flops": {k_: v_[1] for k_, v_ in bounds.items()}}
        print("flash_attention_backward " + json.dumps(rec), flush=True)
        if i in BWD_DEVICE_ROWS:
            recs.append(rec)
    return recs


def update_inputs(b, cache_dtype, q_dtype, seed, T=FLAGSHIP["T"], pos_dtype=torch.int64):
    """K3's inputs as the pool gives them: q / k_new / v_new strided views of
    one fused projection, positions spread over the cache with rows at 0,
    T - 1, one past the end (an idle slot) and on both edges of one of the
    split's key ranges (its last key, the next range's first), the bias
    marking each row's position valid."""
    from genvc_tpu_torch.ops import decode_attention as da

    L, H, hd = FLAGSHIP["L"], FLAGSHIP["H"], FLAGSHIP["hd"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, 1, 3 * H * hd, generator=g, device="cuda").to(q_dtype)
    q, kn, vn = (x.reshape(b, H, hd) for x in qkv.chunk(3, dim=-1))
    ck = torch.randn(L, b, H, T, hd, generator=g, device="cuda").to(cache_dtype)
    cv = torch.randn(L, b, H, T, hd, generator=g, device="cuda").to(cache_dtype)
    pos = torch.randint(1, T - 1, (b,), generator=g, device="cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    per = da.split_len(b * H, T, da.SPLIT_BLOCKS_PER_SM * n_sm)
    edge = per * max(1, -(-T // per) // 2)
    special = [0, T - 1, T + 7, edge - 1, min(edge, T - 1)][:b]
    pos[:len(special)] = torch.tensor(special, device="cuda")
    valid = torch.arange(T, device="cuda")[None, :] <= pos[:, None]
    bias = torch.where(valid, 0.0, -1e9).float()
    return q, kn, vn, ck, cv, bias, pos.to(pos_dtype)


def _bits(x):
    return x.view(torch.uint8)


def check_decode_attention_update(da):
    """K3 vs its plain version at the pool's shapes (B = 8 and 16 slots,
    bf16 / e4m3 caches, bf16 q, and f32 q with either cache, one of them
    with int32 positions; the pool's T = 384, and B = 8 bf16 at T = 128 and
    1024): ``out`` within TOL on layers 0, 13, 29; after each call both
    caches, every layer, bit-equal to the plain version's, and the row past
    the cache end untouched. Also ``out`` against the cache write followed by
    K1 (the same split and arithmetic: equal). Returns the timing records of
    the 4-, 8- and 16-slot configurations at T = 384 (bf16 and e4m3 caches,
    bf16 q), keyed (B, cache)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    L, H, T, hd = FLAGSHIP["L"], FLAGSHIP["H"], FLAGSHIP["T"], FLAGSHIP["hd"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    main = {}
    bf, f8, i64 = torch.bfloat16, torch.float8_e4m3fn, torch.int64
    # 4 rows: a sharded server's shard (8 slots over 2 shards, phase 6d)
    cases = [(8, bf, bf, T, i64), (16, bf, bf, T, i64), (4, bf, bf, T, i64),
             (8, f8, bf, T, i64),
             (16, f8, bf, T, i64), (8, bf, torch.float32, T, i64),
             (8, f8, torch.float32, T, torch.int32), (8, bf, bf, 128, i64),
             (8, bf, bf, 1024, i64)]
    for i, (b, cdt, qdt, t, pdt) in enumerate(cases):
        q, kn, vn, ck, cv, bias, pos = update_inputs(b, cdt, qdt, seed=200 + i, T=t,
                                                     pos_dtype=pdt)
        ck0 = ck.clone()
        worst = worst_k1 = 0.0
        for layer in (0, 13, L - 1):
            pk, pv = ck.clone(), cv.clone()
            got = da.decode_attention_update_layer(q, kn, vn, ck, cv, bias, pos, layer).float()
            torch.cuda.synchronize()
            want = da.decode_attention_update_layer_plain(q, kn, vn, pk, pv, bias, pos,
                                                          layer).float()
            if not (torch.equal(_bits(ck), _bits(pk)) and torch.equal(_bits(cv), _bits(pv))):
                raise AssertionError(f"decode_attention_update B={b} T={t} cache={cdt} "
                                     f"q={qdt} layer={layer}: caches differ from the plain "
                                     "version's")
            if not torch.equal(_bits(ck[:, 2]), _bits(ck0[:, 2])):
                raise AssertionError("decode_attention_update: the row past the cache "
                                     "end was written")
            err = (got - want).abs()
            worst = max(worst, float(err.max()))
            if not bool((err <= TOL + TOL * want.abs()).all()):
                raise AssertionError(f"decode_attention_update B={b} T={t} cache={cdt} "
                                     f"q={qdt} layer={layer}: max |err| {float(err.max())}")
            k1 = da.decode_attention_layer(q.contiguous(), ck, cv, bias, layer).float()
            worst_k1 = max(worst_k1, float((got - k1).abs().max()))
        lidx = iter(range(10 ** 9))
        ms = time_ms(lambda: da.decode_attention_update_layer(q, kn, vn, ck, cv, bias, pos,
                                                              next(lidx) % L))
        plain_ms = time_ms(lambda: da.decode_attention_update_layer_plain(
            q, kn, vn, ck, cv, bias, pos, next(lidx) % L), iters=50)
        lib_ms = None
        if cdt == bf and qdt == bf:
            rows = torch.arange(b, device="cuda")
            inpos = pos.clamp(max=t - 1)  # index_put_ asserts past the end
            q4, m4 = q[:, :, None, :], bias[:, None, None, :].to(bf)

            def lib_call():
                layer = next(lidx) % L
                ck[layer, rows, :, inpos] = kn
                cv[layer, rows, :, inpos] = vn
                return sdpa(q4, ck[layer], cv[layer], attn_mask=m4)
            lib_ms = time_ms(lib_call)
            lib_dev, _ = device_ms(lib_call)
        dev, per_call = device_ms(lambda: da.decode_attention_update_layer(
            q, kn, vn, ck, cv, bias, pos, next(lidx) % L))
        if per_call is not None and per_call != 2:
            raise AssertionError(f"decode_attention_update: {per_call} CUDA launches a "
                                 "call, not the split's 2")
        qe = q.element_size()
        n_bytes = (2 * b * H * t * hd * ck.element_size() + 2 * b * H * hd * ck.element_size()
                   + 4 * b * H * hd * qe + bias.numel() * 4 + pos.numel() * pos.element_size())
        flops = 4 * b * H * t * hd
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        rec = {"B": b, "T": t, "cache": str(cdt).replace("torch.", ""),
               "q": str(qdt).replace("torch.", ""), "pos": str(pdt).replace("torch.", ""),
               "keys_per_split": da.split_len(b * H, t, da.SPLIT_BLOCKS_PER_SM * n_sm),
               "edge_positions": pos[3:5].tolist(), "cuda_launches_per_call": per_call,
               "max_abs_err": worst, "tol": TOL,
               "max_abs_err_vs_write_then_k1": worst_k1,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "device_ms": dev,
               "library_device_ms": lib_dev if lib_ms else None,
               "device_ratio": ratio(dev, lib_dev) if lib_ms else None,
               "library_call": "index_put_ of k and v + scaled_dot_product_attention",
               "bound_ms": bound_ms, "device_times_bound": ratio(dev, bound_ms),
               "bound_by": "bytes", "bytes": n_bytes}
        print("decode_attention_update_layer " + json.dumps(rec), flush=True)
        if t == T and qdt == bf:
            main[b, rec["cache"]] = rec
        del q, kn, vn, ck, cv, ck0, bias, pos
    return main


# C.1: e4m3 at overflow, as the JAX package writes (astype) and reads
# (_f8e4m3_bits_to_bf16) it: values, the bits stored, the values read back
OVERFLOW = [1e4, 460.0, 500.0, -1e4, 464.0, 447.0]
OVERFLOW_BITS = [0x7F, 0x7E, 0x7F, 0xFF, 0x7E, 0x7E]
OVERFLOW_READ = [480.0, 448.0, 480.0, -480.0, 448.0, 448.0]


def check_fp8_overflow(da):
    """K/V rows holding OVERFLOW (K) and its negation (V) through K3 into an
    e4m3 cache at the pool's shape (8 slots), then K1 over that cache: K3's
    caches equal the plain version's to the bit and hold OVERFLOW_BITS; the
    lockstep write (``to_cache`` on the card) stores the same bits; K1's and
    K3's outputs are finite and within TOL of the plain versions, which read
    0x7F / 0xFF as +-480 (the row whose only valid key is the new one
    returns exactly -OVERFLOW_READ)."""
    L = FLAGSHIP["L"]
    q, kn, vn, ck, cv, bias, pos = update_inputs(8, torch.float8_e4m3fn, torch.bfloat16,
                                                 seed=250)
    over = torch.tensor(OVERFLOW, device="cuda")
    kn[:, :, :6], vn[:, :, :6] = over, -over
    want_bits = torch.tensor(OVERFLOW_BITS, dtype=torch.uint8, device="cuda")
    if not torch.equal(_bits(da.to_cache(kn, ck.dtype))[:, :, :6],
                       want_bits.expand(8, FLAGSHIP["H"], 6)):
        raise AssertionError("fp8 overflow: the lockstep write's bits differ from jnp.astype's")
    worst = 0.0
    for layer in (0, L - 1):
        pk, pv = ck.clone(), cv.clone()
        got3 = da.decode_attention_update_layer(q, kn, vn, ck, cv, bias, pos, layer).float()
        want3 = da.decode_attention_update_layer_plain(q, kn, vn, pk, pv, bias, pos,
                                                       layer).float()
        torch.cuda.synchronize()
        if not (torch.equal(_bits(ck), _bits(pk)) and torch.equal(_bits(cv), _bits(pv))):
            raise AssertionError(f"fp8 overflow, layer {layer}: K3's caches differ from the "
                                 "plain version's")
        if not torch.equal(_bits(ck[layer, 0, :, 0, :6]), want_bits.expand(FLAGSHIP["H"], 6)):
            raise AssertionError(f"fp8 overflow, layer {layer}: K3 stored "
                                 f"{_bits(ck[layer, 0, 0, 0, :6]).tolist()}")
        got1 = da.decode_attention_layer(q.contiguous(), ck, cv, bias, layer).float()
        want1 = da.decode_attention_layer_plain(q, ck, cv, bias, layer).float()
        torch.cuda.synchronize()
        for name, got, want in (("K3", got3, want3), ("K1", got1, want1)):
            err = (got - want).abs()
            worst = max(worst, float(err.max()))
            if not (bool(torch.isfinite(got).all())
                    and bool((err <= TOL + TOL * want.abs()).all())):
                raise AssertionError(f"fp8 overflow, layer {layer}: {name} max |err| "
                                     f"{float(err.max())}, finite {bool(torch.isfinite(got).all())}")
        if want3[0, :, :6].tolist() != [[-x for x in OVERFLOW_READ]] * FLAGSHIP["H"]:
            raise AssertionError(f"fp8 overflow: 0x7F / 0xFF read as {want3[0, 0, :6].tolist()}")
    print("fp8 overflow " + json.dumps({
        "values": OVERFLOW, "bits": OVERFLOW_BITS, "read_as": OVERFLOW_READ,
        "k3_caches_bit_equal_plain": True, "max_abs_err_k1_k3": worst, "tol": TOL}), flush=True)


def ptxas_summary(log):
    """Registers, spill bytes and static shared memory of each kernel
    function in one ``nvcc -Xptxas -v`` log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out[name].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[name]["registers"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                out[name]["static_smem"] = int(m[1])
    return out


# (m, k, n): one row (streaming), 8 and 16 rows (the server's slots), 40 (a
# prefill's rows); the block widths and the heads' 1026 and 258
Q8_CASES = [(1, 1024, 3072), (8, 1024, 3072), (16, 1024, 1024), (40, 4096, 1024),
            (1, 1024, 1026), (16, 1024, 1026), (40, 1024, 258)]
# one block's four projections: c_attn, attn c_proj, c_fc, mlp c_proj
BLOCK_LINEARS = [(1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024)]
INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core peak


def check_int8_linear(quant, gpu):
    """The int8 product of ``ops.quant`` on the card against its CPU version:
    int8 weights / scales and activations equal, int32 accumulators equal,
    ``linear_q8`` outputs within 1e-6 relative (the same IEEE steps in the
    same order), f32 and bf16 inputs; each card product one ``_int_mm``.
    Then one block's four products at m = 1, 8, 16 and 115 rows (a prefill):
    ``linear_q8`` (activation quantization, the int8 product, the rescale)
    and the bare ``_int_mm`` against bf16 ``x @ w``, device ms, CUDA launches
    per call and the int8 weights' byte bound."""
    g = torch.Generator().manual_seed(7)
    worst = 0.0
    for m, k, n in Q8_CASES:
        w, b = torch.randn(k, n, generator=g) * 0.03, torch.randn(n, generator=g)
        cpu = quant.QLinear.from_float(w, b)
        card = quant.QLinear.from_float(w.cuda(), b.cuda())
        if not (torch.equal(card.w_q.cpu(), cpu.w_q) and torch.equal(card.scale.cpu(), cpu.scale)):
            raise AssertionError(f"int8 weights differ between card and CPU at {m, k, n}")
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(m, k, generator=g) * 3).to(dtype)
            x_q, _ = quant.quantize_rows(x)
            x_qc, _ = quant.quantize_rows(x.cuda())
            quant.int8_matmul.launches = 0
            acc_c = quant.int8_matmul(x_qc, card.w_q)
            if quant.int8_matmul.launches != 1:
                raise AssertionError("int8_matmul did not launch _int_mm")
            y, y_c = cpu(x).float(), card(x.cuda()).float().cpu()
            rel = float((y_c - y).abs().max() / y.abs().max())
            worst = max(worst, rel)
            if (not torch.equal(x_qc.cpu(), x_q)
                    or not torch.equal(acc_c.cpu(), quant.int8_matmul_plain(x_q, cpu.w_q))
                    or rel > 1e-6):
                raise AssertionError(f"linear_q8 card vs CPU at {m, k, n} {dtype}: rel {rel}")
    print(f"int8 linear card vs CPU: {len(Q8_CASES)} shapes x f32 / bf16, int8 "
          f"activations and int32 accumulators equal, max rel err {worst:.3g} (tol 1e-6)",
          flush=True)
    wb = [torch.randn(k, n, device="cuda") * 0.03 for k, n in BLOCK_LINEARS]
    q = [quant.QLinear.from_float(w, torch.zeros(w.shape[1], device="cuda")) for w in wb]
    wb = [w.to(torch.bfloat16) for w in wb]
    weight_bytes = sum(k * n for k, n in BLOCK_LINEARS)
    rec = {"block_linears": BLOCK_LINEARS, "int8_weight_bytes": weight_bytes, "rows": {},
           "gpu": gpu}
    for m in (1, 8, 16, 115):
        xs = [torch.randn(m, k, device="cuda", dtype=torch.bfloat16) for k, _ in BLOCK_LINEARS]
        xq = [quant.quantize_rows(x)[0] for x in xs]

        def q8():
            return [lin(x) for lin, x in zip(q, xs)]

        def int_mm():
            return [quant.int8_matmul(a, lin.w_q) for lin, a in zip(q, xq)]

        def bf16():
            return [x @ w for x, w in zip(xs, wb)]

        ops = 2 * m * weight_bytes
        bound = max(weight_bytes / HBM_BYTES_PER_S, ops / INT8_OPS) * 1e3
        bound_bf16 = max(2 * weight_bytes / HBM_BYTES_PER_S, ops / BF16_FLOPS) * 1e3
        row = {}
        for name, fn in (("linear_q8", q8), ("int_mm", int_mm), ("bf16_matmul", bf16)):
            dev, per_call = device_ms(fn)
            row[name] = {"ms": time_ms(fn), "device_ms": dev, "cuda_launches": per_call}
        row["int8_bound_ms"], row["bf16_bound_ms"] = bound, bound_bf16
        row["device_ratio_q8_vs_bf16"] = ratio(row["linear_q8"]["device_ms"],
                                               row["bf16_matmul"]["device_ms"])
        rec["rows"][m] = row
    print("int8_product " + json.dumps(rec), flush=True)


def host_us(fn, calls=2000, warmup=50):
    """Host microseconds a call of ``fn`` takes to return (its Python and its
    launches), over ``calls`` calls with no synchronise between them; the
    device runs behind the host for calls that cost it less."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def check_layer_norm(tnn, gpu):
    """The LayerNorm kernel (``csrc/layer_norm.cu``, no TPU kernel: LayerNorm
    is plain jnp that XLA fuses) against its plain version, at the decode
    step's call (1 x 1024 bf16, bf16 parameters; f32 ``final_norm``
    parameters) and at the training features' ContentVec call (24 x 500 rows
    of 768 f32): bf16 within one bf16 ulp of the plain version, f32 within
    1e-5; one launch a call (``layer_norm.launches``). Times
    kernel, plain version and ``F.layer_norm`` (the library yardstick, which
    the port never calls): ms, device ms, the byte bound, and each one's host
    microseconds a call."""
    import torch.nn.functional as F

    cases = [("decode", 1, 1024, torch.bfloat16, torch.bfloat16),
             ("decode_f32_params", 1, 1024, torch.bfloat16, torch.float32),
             ("features", 24 * 500, 768, torch.float32, torch.float32)]
    recs = {}
    for name, rows, d, xdt, pdt in cases:
        g = torch.Generator(device="cuda").manual_seed(rows + d)
        x = (torch.randn(rows, d, generator=g, device="cuda") * 3 + 0.5).to(xdt)
        scale = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")).to(pdt)
        bias = (0.1 * torch.randn(d, generator=g, device="cuda")).to(pdt)
        before = tnn.layer_norm.launches
        got = tnn.layer_norm(x, scale, bias).float()
        torch.cuda.synchronize()
        calls = tnn.layer_norm.launches - before
        want = tnn.layer_norm_plain(x, scale, bias).float()
        err = (got - want).abs()
        if xdt == torch.bfloat16:  # one bf16 ulp, plus the f32 sums' order where
            # the output's terms cancel (tests/test_torch_layer_norm.py)
            xf = x.float()
            mean = xf.mean(-1, keepdim=True)
            nrm = (xf - mean) * torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + 1e-5)
            slack = 2.0 ** -20 * ((nrm * scale.float()).abs() + bias.float().abs())
            ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
            ok = bool((err <= ulp + slack).all())
        else:
            ok = bool((err <= 1e-5 + 1e-5 * want.abs()).all())
        if calls != 1 or not ok:
            raise AssertionError(f"layer_norm {name}: {calls} kernel calls, max |err| "
                                 f"{float(err.max())}")

        def kernel():
            return tnn.layer_norm(x, scale, bias)

        def plain():
            return tnn.layer_norm_plain(x, scale, bias)

        def library():
            return F.layer_norm(x, (d,), scale.to(xdt), bias.to(xdt), 1e-5)

        n_bytes = 2 * rows * d * x.element_size() + 2 * d * scale.element_size()
        rec = {"rows": rows, "d": d, "x": str(xdt).replace("torch.", ""),
               "params": str(pdt).replace("torch.", ""), "max_abs_err": float(err.max()),
               "bytes": n_bytes, "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3}
        for label, fn in (("kernel", kernel), ("plain", plain), ("library", library)):
            dev, per_call = device_ms(fn)
            rec[label] = {"ms": time_ms(fn), "device_ms": dev, "cuda_launches": per_call,
                          "host_us": host_us(fn)}
        rec["device_ratio_vs_library"] = ratio(rec["kernel"]["device_ms"],
                                               rec["library"]["device_ms"])
        recs[name] = rec
    # the stream handle's host cost, the wrapper's way and the public way
    dev_idx = torch.cuda.current_device()
    recs["stream_handle_host_us"] = {
        "raw": host_us(lambda: torch._C._cuda_getCurrentRawStream(dev_idx)),
        "current_stream": host_us(lambda: torch.cuda.current_stream(
            torch.device("cuda", dev_idx)).cuda_stream)}
    recs["gpu"] = gpu
    print("layer_norm " + json.dumps(recs), flush=True)


# Moonlight-16B-A3B's published widths (the DeepSeek-V3 backbone): hidden,
# heads, latent rank, rotary width, nope width, experts, chosen a token,
# expert width, layers
MOONLIGHT = dict(D=2048, H=16, R=512, P=64, NOPE=128, E=64, K=6, F=1408, L=27)


def yardsticks(fns, iters=200, host_calls=2000):
    """Each of ``fns`` {label: fn} timed: ms (CUDA events over ``iters``
    calls), device ms and CUDA launches a call (profiler) and, where
    ``host_calls``, host microseconds a call. The library yardstick is not
    part of the port: where its call fails, the error is recorded instead."""
    out = {}
    for label, fn in fns.items():
        try:
            dev, per_call = device_ms(fn, iters=min(50, iters))
            out[label] = {"ms": time_ms(fn, iters=iters, warmup=min(10, iters)),
                          "device_ms": dev, "cuda_launches": per_call}
            if host_calls:
                out[label]["host_us"] = host_us(fn, calls=host_calls, warmup=min(50, host_calls))
        except RuntimeError as e:
            if label != "library":
                raise
            out[label] = {"error": str(e)[:300]}
    return out


def check_mla_decode(mla, gpu):
    """``mla_decode`` (``csrc/mla_decode.cu``, no TPU kernel: the JAX package
    has no latent attention) at the lockstep step's call of the DeepSeek-V3
    backbone: 8 rows, a latent cache of 27 layers x 384 positions (200
    valid, the rest masked) of 512 + 64, 16 heads, bf16, the last layer.
    Against its plain version within 2^-7 relative plus 2e-3 (two bf16 ulps:
    f32 sums in another order), one count a call (two CUDA launches). Times
    kernel, plain version and SDPA over the rows expanded to 16 heads (the
    library yardstick): ms, device ms, the byte bound (the valid rows, the
    queries and the outputs at 3.35 TB/s) and host microseconds a call."""
    import torch.nn.functional as F

    m = MOONLIGHT
    b, t, valid_t, h, r, p = 8, 384, 200, m["H"], m["R"], m["P"]
    g = torch.Generator(device="cuda").manual_seed(18)
    cache = torch.randn(m["L"], b, t, r + p, generator=g, device="cuda").to(torch.bfloat16)
    q = (torch.randn(b, h, r + p, generator=g, device="cuda") * 0.3).to(torch.bfloat16)
    bias = torch.where(torch.arange(t, device="cuda") < valid_t, 0.0, -1e9).expand(b, t)
    bias = bias.contiguous()
    scale = (m["NOPE"] + p) ** -0.5
    layer = m["L"] - 1
    before = mla.mla_decode.launches
    got = mla.mla_decode(q, cache, bias, layer, r, scale).float()
    torch.cuda.synchronize()
    calls = mla.mla_decode.launches - before
    want = mla.mla_decode_plain(q, cache, bias, layer, r, scale).float()
    err = (got - want).abs()
    if calls != 1 or not bool((err <= 2e-3 + 2 ** -7 * want.abs()).all()):
        raise AssertionError(f"mla_decode: {calls} counted calls, max |err| {float(err.max())}")
    rows = cache[layer][:, None]                                    # (B, 1, T, R + P)
    keys, values = rows.expand(b, h, t, r + p), rows[..., :r].expand(b, h, t, r)
    mask = bias[:, None, None, :].to(torch.bfloat16)
    n_bytes = (b * valid_t * (r + p) + b * h * (r + p) + b * h * r) * 2
    rec = {"B": b, "T": t, "valid": valid_t, "H": h, "R": r, "P": p,
           "max_abs_err": float(err.max()), "bytes": n_bytes,
           "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "gpu": gpu}
    rec |= yardsticks({
        "kernel": lambda: mla.mla_decode(q, cache, bias, layer, r, scale),
        "plain": lambda: mla.mla_decode_plain(q, cache, bias, layer, r, scale),
        "library": lambda: F.scaled_dot_product_attention(q[:, :, None], keys, values,
                                                          attn_mask=mask, scale=scale)})
    rec["device_ratio_vs_library"] = ratio(rec["kernel"]["device_ms"],
                                           rec["library"].get("device_ms"))
    print("mla_decode " + json.dumps(rec), flush=True)


def check_moe_experts(moe, gpu):
    """``moe_experts`` (``csrc/moe_experts.cu``, no TPU kernel: the JAX
    package has no experts) at the backbone's widths (64 experts of 2048 ->
    2 x 1408 -> 2048, bf16, 6 chosen a row) at the lockstep step's 8 rows and
    at a prefill's 920 rows. Against its plain version within 2^-7 absolute
    plus 2^-6 relative (one rounded intermediate a bf16 ulp apart, times a
    weight under 1), one count a call (three CUDA launches). Times kernel,
    plain version (a host loop over the chosen experts) and
    ``torch._grouped_mm`` over the rows sorted by expert (the library
    yardstick, without the weighted combine): ms, device ms, the bound (the
    chosen experts' weights, the rows in and out at 3.35 TB/s, or the
    products at the bf16 peak) and, at 8 rows, host microseconds a call."""
    import torch.nn.functional as F

    m = MOONLIGHT
    d, f, n_exp, k = m["D"], m["F"], m["E"], m["K"]
    g = torch.Generator(device="cuda").manual_seed(1408)
    w1 = (torch.randn(n_exp, 2 * f, d, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
    w2 = (torch.randn(n_exp, d, f, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
    recs = {"gpu": gpu}
    for name, rows, iters, host_calls in (("decode", 8, 200, 200), ("prefill", 920, 10, 0)):
        x = torch.randn(rows, d, generator=g, device="cuda").to(torch.bfloat16)
        idx = torch.argsort(torch.rand(rows, n_exp, generator=g, device="cuda"), dim=-1)[:, :k]
        w = torch.rand(rows, k, generator=g, device="cuda")
        w = w / w.sum(-1, keepdim=True)
        before = moe.moe_experts.launches
        got = moe.moe_experts(x, idx, w, w1, w2).float()
        torch.cuda.synchronize()
        calls = moe.moe_experts.launches - before
        want = moe.moe_experts_plain(x, idx, w, w1, w2).float()
        err = (got - want).abs()
        if calls != 1 or not bool((err <= 2 ** -7 + 2 ** -6 * want.abs()).all()):
            raise AssertionError(f"moe_experts {name}: {calls} counted calls, max |err| "
                                 f"{float(err.max())}")
        chosen = int(idx.unique().numel())
        n_bytes = chosen * 3 * d * f * 2 + 2 * rows * d * 2 + rows * k * 8
        flops = 2 * rows * k * 3 * d * f
        flat = idx.reshape(-1)
        order = torch.argsort(flat)
        offs = torch.cumsum(torch.bincount(flat, minlength=n_exp), 0).to(torch.int32)
        src_rows = order // k

        def library():
            gu = torch._grouped_mm(x[src_rows], w1.transpose(1, 2), offs=offs)
            gate, up = gu.chunk(2, dim=-1)
            return torch._grouped_mm(F.silu(gate) * up, w2.transpose(1, 2), offs=offs)

        rec = {"rows": rows, "chosen": chosen, "max_abs_err": float(err.max()),
               "bytes": n_bytes, "flops": flops,
               "bound_ms": max(n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
               "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS
               else "flops"}
        rec |= yardsticks({"kernel": lambda: moe.moe_experts(x, idx, w, w1, w2),
                           "plain": lambda: moe.moe_experts_plain(x, idx, w, w1, w2),
                           "library": library}, iters=iters, host_calls=host_calls)
        rec["device_ratio_vs_library"] = ratio(rec["kernel"]["device_ms"],
                                               rec["library"].get("device_ms"))
        recs[name] = rec
    print("moe_experts " + json.dumps(recs), flush=True)


def check_rms_norm(tnn, gpu):
    """The RMS mode of ``csrc/layer_norm.cu`` (``ops.nn.rms_norm``) at the
    backbone's calls: the lockstep step's 8 rows of 2048 and a prefill's 920
    rows of the latent (512 of each 576-wide row of the projection, read in
    place). Against its plain version within one bf16 ulp (2^-7 relative,
    the sum of squares in another order), one launch a call, a contiguous
    result. Times kernel, plain version and ``F.rms_norm`` (the library
    yardstick): ms, device ms, the byte bound and host microseconds a call."""
    import torch.nn.functional as F

    recs = {"gpu": gpu}
    for name, rows, d, ld in (("decode", 8, 2048, 2048), ("latent_prefill", 920, 512, 576)):
        g = torch.Generator(device="cuda").manual_seed(rows + d)
        x = (torch.randn(rows, ld, generator=g, device="cuda") * 3).to(torch.bfloat16)[:, :d]
        scale = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")).to(torch.bfloat16)
        before = tnn.rms_norm.launches
        got = tnn.rms_norm(x, scale)
        torch.cuda.synchronize()
        calls = tnn.rms_norm.launches - before
        want = tnn.rms_norm_plain(x, scale).float()
        err = (got.float() - want).abs()
        if calls != 1 or not got.is_contiguous() or not bool(
                (err <= 1e-6 + 2 ** -7 * want.abs()).all()):
            raise AssertionError(f"rms_norm {name}: {calls} launches, max |err| "
                                 f"{float(err.max())}")
        n_bytes = 2 * rows * d * 2 + d * 2
        rec = {"rows": rows, "d": d, "row_stride": ld, "max_abs_err": float(err.max()),
               "bytes": n_bytes, "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3}
        rec |= yardsticks({"kernel": lambda: tnn.rms_norm(x, scale),
                           "plain": lambda: tnn.rms_norm_plain(x, scale),
                           "library": lambda: F.rms_norm(x, (d,), scale, 1e-5)})
        rec["device_ratio_vs_library"] = ratio(rec["kernel"]["device_ms"],
                                               rec["library"].get("device_ms"))
        recs[name] = rec
    print("rms_norm " + json.dumps(recs), flush=True)


def small_config(pipeline):
    cfg = pipeline.flagship_config()
    ma = cfg.model_args
    ma.gpt_layers, ma.gpt_n_model_channels, ma.gpt_n_heads = 2, 64, 4
    cd = cfg.content_dvae_config
    cd.codebook_dim, cd.hidden_dim = 24, 16
    cfg.vocoder_config.input_feat_dim = 64
    cfg.vocoder_config.upsample_initial_channel = 32
    return cfg


def check_native_audio(tmp):
    """The native audio library (``native/audioio.cpp``) builds here and
    ``load_audio`` takes it: on the sample wavs (96 kHz PCM32) at 16 and
    24 kHz it gives the native result, within 1e-6 of the numpy path
    (``read_wav`` + ``resample_np``). Fault C.6's inputs, a 24 kHz stereo
    int16 wav cut to 6, 20 and 40 bytes (inside the header) and to half
    (inside the data chunk): ``None``, ``None``, ``None`` and (1, 7996) /
    (1, 11994) samples at 16 / 24 kHz, as the JAX package gives them."""
    import wave

    import numpy as np

    from genvc_tpu_torch.data import native_audio
    from genvc_tpu_torch.dsp import audio_io
    from genvc_tpu_torch.dsp.resample import resample_np

    t0 = time.perf_counter()
    if not native_audio.available():
        raise AssertionError("the native audio library did not build")
    build_s = time.perf_counter() - t0
    worst = 0.0
    for f in ("EF4_ENG_0112_1.wav", "EM1_ENG_0037_1.wav"):
        path = os.path.join(HERE, "samples", f)
        for sr in (16000, 24000):
            got = audio_io.load_audio(path, sr)
            if not np.array_equal(got, native_audio.load_audio_native(path, sr)):
                raise AssertionError(f"load_audio({f}, {sr}) did not take the native path")
            audio, rate = audio_io.read_wav(path)
            want = np.clip(resample_np(audio.mean(axis=0, keepdims=True), rate, sr), -1, 1)
            worst = max(worst, float(np.abs(got - want).max()))
    if worst > 1e-6:
        raise AssertionError(f"native vs numpy load_audio: {worst}")
    rng = np.random.default_rng(0)
    stereo = os.path.join(tmp, "stereo24k.wav")
    with wave.open(stereo, "wb") as wf:
        wf.setnchannels(2)
        wf.setsampwidth(2)
        wf.setframerate(24000)
        wf.writeframes((rng.standard_normal((24000, 2)) * 0.2 * 32767).astype(np.int16).tobytes())
    data = open(stereo, "rb").read()
    shapes = {}
    for n in (6, 20, 40, len(data) // 2):
        cut = os.path.join(tmp, f"cut{n}.wav")
        with open(cut, "wb") as f:
            f.write(data[:n])
        for sr in (16000, 24000):
            out = audio_io.load_audio(cut, sr)
            shapes[f"{n}_bytes_{sr}"] = None if out is None else list(out.shape)
    want = {"6_bytes_16000": None, "6_bytes_24000": None, "20_bytes_16000": None,
            "20_bytes_24000": None, "40_bytes_16000": None, "40_bytes_24000": None,
            f"{len(data) // 2}_bytes_16000": [1, 7996], f"{len(data) // 2}_bytes_24000": [1, 11994]}
    if shapes != want:
        raise AssertionError(f"C.6 inputs: {shapes}, expected {want}")
    print("native audio " + json.dumps({
        "library": os.path.relpath(native_audio.lib_path(), HERE), "build_or_load_s": build_s,
        "load_audio_path": "native", "native_vs_numpy_max_abs": worst,
        "c6_shapes": shapes}), flush=True)


def check_cli_profile(pipeline, da, fa, tmp, gpu):
    """``python -m genvc_tpu_torch.infer --streaming --bf16 --profile DIR``
    (in this process) on a small bundle (the phase-2 configuration, GPT 2 x
    64 with 64 mel tokens, seeded weights written by ``export_bundle``) and a
    0.5 s source: the
    conversion writes its wav and ``DIR/trace.json``, and the trace holds
    K1's two CUDA kernels (``decode_split_logits``, ``decode_split_pv``).
    The tracer has lost device records on that machine before, so the
    count of each in the trace is printed beside the wrapper's launches,
    not required to equal it."""
    import numpy as np

    from genvc_tpu_torch import checkpoint, infer
    from genvc_tpu_torch.dsp.audio_io import load_audio, write_wav
    from genvc_tpu_torch.models import dvae

    cfg = small_config(pipeline)
    tree = pipeline.random_tree(cfg, seed=3, device="cpu")
    # 61 generated tokens at most, not 602 (random weights never stop
    # early), so the trace stays small; the streaming windows step past the
    # cap to position 67 of the 67-row table, which clamps (fault C.7)
    cfg.model_args.gpt_max_audio_tokens = 64
    tree["config"] = cfg.to_dict()
    tree["gpt"]["mel_pos"] = tree["gpt"]["mel_pos"][: 64 + 3]
    # a bundle's dVAE carries its decoder: draw the trainable form
    tree["content_dvae"] = dvae.init_tree(torch.Generator().manual_seed(4), checkpoint.dvae_config(
        cfg.content_dvae_config), trainable=True)
    bundle = os.path.join(tmp, "small_bundle.pth")
    checkpoint.export_bundle(tree, bundle)
    src = load_audio(os.path.join(HERE, "samples", "EF4_ENG_0112_1.wav"), 16000)
    src_path, out, prof = (os.path.join(tmp, n) for n in ("src.wav", "out.wav", "prof"))
    write_wav(src_path, src[:, :8000], 16000)
    flags = ["--model_path", bundle, "--device", "cuda", "--streaming", "--bf16", "--top_k",
             "1", "--src_wav", src_path, "--ref_audio",
             os.path.join(HERE, "samples", "EM1_ENG_0037_1.wav"), "--output_path", out,
             "--profile", prof]
    t0 = time.perf_counter()
    with Launches(da, fa) as n:
        rc = infer.main(flags)
    wall = time.perf_counter() - t0
    if rc != 0 or not os.path.exists(out):
        raise AssertionError(f"infer --profile exited {rc}")
    trace_path = os.path.join(prof, "trace.json")
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    for ev in events:
        if ev.get("cat") == "kernel":
            for k in ("decode_split_logits", "decode_split_pv"):
                if k in ev.get("name", ""):
                    kernels[k] = kernels.get(k, 0) + 1
    expect_none("cli --profile", n, ("k3", "k4", "k5", "k6"))
    if not n.k1 or set(kernels) != {"decode_split_logits", "decode_split_pv"}:
        raise AssertionError(f"trace kernels {kernels}, K1 launched {n.k1} times")
    # the recorder's counters: every LayerNorm of the bf16 call on the kernel
    with open(os.path.join(prof, "counters.json")) as f:
        counters = json.load(f)
    steps = counters.get("engine.steps", 0)
    ln_kernel = counters.get("ops.layer_norm.kernel", 0)
    per_step = 2 * cfg.model_args.gpt_layers + 2
    if not steps or ln_kernel < per_step * steps:
        raise AssertionError(f"cli --profile counters {counters}")
    print("cli profile " + json.dumps({
        "trace_mb": os.path.getsize(trace_path) / 2 ** 20, "events": len(events),
        "k1_launches": n.k1, "k1_kernels_in_trace": kernels, "wall_s": wall,
        "counters": counters, "layer_norm_per_decode_step": per_step, "gpu": gpu}),
        flush=True)
    return n.counts()


def serve(server_cls, pipe, srcs, refs, **kw):
    """All streams through a server; the ones after the first two are
    submitted after the first step (mid-flight). Returns the waveforms."""
    server = server_cls(pipe, **kw)
    sids = [server.submit(s, r) for s, r in zip(srcs[:2], refs[:2])]
    server.step()
    sids += [server.submit(s, r) for s, r in zip(srcs[2:], refs[2:])]
    server.drain()
    return [server.result(sid)[0] for sid in sids]


def beam_sample_tokens(pipe, engine, seg, ref, noise, nb=3):
    """beam_sample over one segment at the engine level, its Gumbel noise
    from ``noise`` (the same draws on every device): the token list."""
    import numpy as np

    pipe._cond_latent = pipe.get_gpt_cond_latents(ref)
    padded = np.pad(seg, ((0, 0), (0, pipe._seg_len_16k - seg.shape[-1])))
    codes, n_codes = pipe.extract_content_codes(padded, seg.shape[-1])
    prefix, valid, state = pipe._tiled_segment(codes, n_codes, nb)
    with torch.inference_mode():
        buf, n = engine.decode_beam(pipe.gpt, state, prefix, valid, pipe._max_new(n_codes),
                                    nb, repetition_penalty=2.0, do_sample=True,
                                    temperature=1.3, top_k=8, top_p=0.9, noise=noise)
    return buf[:n].tolist()


def check_f32_query_over_e4m3(da):
    """An f32 GPT's decode attention over an e4m3 cache: K1 on the card
    rounds q and the probabilities to bf16, where the CPU engine (as the JAX
    package off the TPU) attends in f32 over the cache widened by
    ``from_e4m3``. At the small configuration's head dim (16) and the
    flagship's (256), one masked overflow code among the keys, every element
    of K1's output must lie within ``da.bf16_rounding_bound`` of the f32
    attention on the same card inputs."""
    g = torch.Generator(device="cuda").manual_seed(11)
    for hd in (16, 256):
        b, h, t = 3, 4, 384
        q = torch.randn(b, h, hd, generator=g, device="cuda") * 0.3
        kv = [torch.randn(2, b, h, t, hd, generator=g, device="cuda") * 2 for _ in range(2)]
        kv[1][1, 2, 0, 300, :4] = 1e4  # past row 2's 97 keys
        ck, cv = (da.to_cache(x, torch.float8_e4m3fn) for x in kv)
        lens = torch.tensor([t, 1, 97], device="cuda")
        bias = torch.where(torch.arange(t, device="cuda")[None] < lens[:, None], 0.0, -1e9)
        got = da.decode_attention_layer(q, ck, cv, bias, 1)
        k, v = (da.widen(c[1], torch.float32) for c in (ck, cv))
        want = torch.softmax(torch.einsum("bhd,bhtd->bht", q, k) / hd ** 0.5
                             + bias[:, None], -1)
        want = torch.einsum("bht,bhtd->bhd", want, v)
        bound = da.bf16_rounding_bound(q, ck, cv, bias, 1)
        err = (got - want).abs()
        worst = float((err / bound.clamp_min(1e-30)).max())  # a zero v: err 0
        print(f"K1, f32 q over e4m3 (hd {hd}) vs f32 attention: max |err| "
              f"{float(err.max()):.3g}, largest share of the bf16 rounding bound {worst:.3g}",
              flush=True)
        if not torch.isfinite(got).all() or worst > 1:
            raise AssertionError(f"K1 with f32 q (hd {hd}) outside the bf16 rounding bound")


def check_small_against_cpu(pipeline, engine, server_cls, da, fa, quant, src, ref, ref16):
    """A small f32 configuration (hd = 16) on the card vs the same weights on
    the CPU: greedy streaming, offline, batch (two rows of different lengths),
    a 2-slot server (first window 4, three streams, the third arriving after
    the first step), and offline beam (3 beams), group beam (4 beams, 2
    groups) and contrastive search (4 candidates), and streaming with int8
    linears (``_int_mm`` on the card) and with an fp8 cache (K1 on the card,
    which rounds q and the probabilities to bf16; f32 attention over the
    widened cache on the CPU, as the JAX package off the TPU) give the same
    lengths and audio within 1e-3; beam_sample (3 beams) with one noise
    sequence, drawn on the CPU from a seeded generator and handed to both,
    the same tokens."""
    cfg = small_config(pipeline)
    tree = pipeline.random_tree(cfg, seed=1, device="cpu", contentvec_layers=2)
    seg = src[:, :24000]
    runs = {
        "streaming": lambda p: [p.synthesize_streaming(src[:, :16000], ref, verbose=False)[0]],
        "offline": lambda p: [p.synthesize(seg, ref)],
        "beam": lambda p: [p.synthesize(seg, ref, num_beams=3)],
        "group_beam": lambda p: [p.synthesize(seg, ref, num_beams=4, num_beam_groups=2)],
        "contrastive": lambda p: [p.synthesize(seg, ref, penalty_alpha=0.6,
                                               contrastive_top_k=4)],
        "batch": lambda p: p.synthesize_batch([src[:, :24000], ref16[:, :40000]],
                                              [ref, ref[:, :48000]]),
        "server": lambda p: serve(server_cls, p, [src[:, :16000], ref16[:, :40000],
                                                  src[:, 8000:20000]],
                                  [ref, ref[:, :48000], ref], slots=2, first_window=4),
    }
    gen = torch.Generator().manual_seed(3)
    draws = {}

    def noise(s):  # (3 beams x V,) Gumbel noise of step s, drawn once
        if s not in draws:
            n = 3 * pipeline.gpt_model.GPTConfig.num_audio_tokens
            draws[s] = -torch.log(torch.empty(n).exponential_(generator=gen))
        return draws[s]

    outs, tokens = {}, {}
    for dev in ("cpu", "cuda"):
        pipe = pipeline.build_pipeline(tree, cfg, device=dev, dtype=torch.float32)
        pipe.gen_cap_tokens_per_code = 1.0
        for name, run in runs.items():
            fa.flash_attention.launches = 0
            outs[name, dev] = run(pipe)
            if (dev == "cuda" and name not in ("streaming", "server")
                    and fa.flash_attention.launches == 0):
                raise AssertionError(f"small-config {name}: the flash kernel never ran")
        tokens[dev] = beam_sample_tokens(pipe, engine, seg, ref, noise)
        for name, kw in (("int8_streaming", {"quantize": "int8"}),
                         ("fp8_streaming", {"kv_cache_dtype": "fp8"})):
            pipe = pipeline.build_pipeline(tree, cfg, device=dev, dtype=torch.float32, **kw)
            pipe.gen_cap_tokens_per_code = 1.0
            quant.int8_matmul.launches = da.decode_attention_layer.launches = 0
            outs[name, dev] = runs["streaming"](pipe)
            if dev == "cuda" and name == "int8_streaming" and quant.int8_matmul.launches == 0:
                raise AssertionError("small-config int8 streaming: _int_mm never ran")
            if (dev == "cuda" and name == "fp8_streaming"
                    and da.decode_attention_layer.launches == 0):
                raise AssertionError("small-config fp8 streaming: K1 never ran")
    print(f"small f32 config beam_sample, card vs CPU: {len(tokens['cuda'])} vs "
          f"{len(tokens['cpu'])} tokens, equal {tokens['cuda'] == tokens['cpu']}", flush=True)
    if tokens["cuda"] != tokens["cpu"] or len(tokens["cpu"]) < 2:
        raise AssertionError("small-config beam_sample tokens differ between card and CPU")
    for name in list(runs) + ["int8_streaming", "fp8_streaming"]:
        for a, b in zip(outs[name, "cpu"], outs[name, "cuda"]):
            err = float(abs(a - b).max()) if a.shape == b.shape and a.size else None
            print(f"small f32 config {name}, card vs CPU: samples {b.shape[0]} vs "
                  f"{a.shape[0]}, max |err| {err} (tol 1e-3)", flush=True)
            if err is None or err > 1e-3:
                raise AssertionError(f"small-config {name} output differs between "
                                     "card and CPU")


def check_audio(name, wav, sample_rate):
    import numpy as np

    if not (wav.ndim == 1 and wav.size > 0 and np.isfinite(wav).all()
            and np.abs(wav).max() <= 1.0 and sample_rate == 24000):
        raise AssertionError(f"{name}: output is not finite 24 kHz audio")


class Launches:
    """The kernels' launch counts over one call of a path: zeroed just
    before it, read just after."""

    def __init__(self, da, fa):
        from genvc_tpu_torch.ops import nn as tnn
        from genvc_tpu_torch.ops import quant

        self.da, self.fa, self.quant, self.tnn = da, fa, quant, tnn

    def __enter__(self):
        self.tnn.layer_norm.launches = 0
        self.quant.int8_matmul.launches = 0
        self.da.decode_attention_layer.launches = 0
        self.da.decode_attention_update_layer.launches = 0
        self.fa.flash_attention.launches = 0
        self.fa.flash_attention_dq.launches = 0
        self.fa.flash_attention_dkdv.launches = 0
        return self

    def __exit__(self, *exc):
        self.k1 = self.da.decode_attention_layer.launches
        self.k3 = self.da.decode_attention_update_layer.launches
        self.k4 = self.fa.flash_attention.launches
        self.k5 = self.fa.flash_attention_dq.launches
        self.k6 = self.fa.flash_attention_dkdv.launches
        self.q8 = self.quant.int8_matmul.launches
        self.ln = self.tnn.layer_norm.launches
        return False

    def counts(self):
        return {"decode_attention_layer": self.k1, "decode_attention_update_layer": self.k3,
                "flash_attention": self.k4, "flash_attention_dq": self.k5,
                "flash_attention_dkdv": self.k6, "int8_matmul": self.q8,
                "layer_norm": self.ln}


def expect(name, got, want):
    if got != want or want == 0:
        raise AssertionError(f"{name}: {got} launches, expected {want} (> 0)")


def expect_none(path, n, kernels):
    """Kernels that are not on ``path`` were not launched during it."""
    for k in kernels:
        if getattr(n, k):
            raise AssertionError(f"{path}: {k.upper()} launched {getattr(n, k)} times")


def expect_int8(name, n, layers, forwards, latent_passes=0):
    """A quantized path: ``_int_mm`` ran for every int8 linear of every
    forward (4 per block and the mel head; a prefill is one forward) and
    latent pass (4 per block), with at least one prefill beside the decode
    forwards; a bf16 path (``layers`` None): never."""
    if layers is None:
        if n.q8:
            raise AssertionError(f"{name}: the int8 product ran {n.q8} times")
        return
    per_forward = 4 * layers + 1
    rest = n.q8 - per_forward * forwards - 4 * layers * latent_passes
    if rest <= 0 or rest % per_forward:
        raise AssertionError(f"{name}: {n.q8} int8 products for {forwards} forwards and "
                             f"{latent_passes} latent passes")


def check_serving(pipe, server_cls, srcs, refs, da, fa, gpu, runs=2):
    """``StreamServer(pipe, slots=8)`` with its defaults (first window 4,
    waves of up to 4, 2 ticks in flight) drains all streams, submitted at
    one instant; run 0 (after ``warmup_admission``) warms up. Per drain:
    aggregate RTF (wall time over the total source), first-audio latency
    p50 / p95 from that instant, pool counters and launches. Checks the
    audio, that every stream completed, and that the server launched K3 30
    times per per-row decode step and neither K1 nor K4, and on a quantized
    pipeline the int8 product at every forward. Returns the last drain's
    launch counts and the median aggregate RTF of the drains after the
    first."""
    import numpy as np

    layers = pipe.gpt_cfg.layers
    total_s = sum(s.shape[-1] for s in srcs) / 16000
    drains = []
    for run in range(runs):
        server = server_cls(pipe, slots=8)
        if run == 0:
            server.warmup_admission()
        with Launches(da, fa) as n:
            t0 = time.perf_counter()
            sids = [server.submit(s, r, arrival_t=t0) for s, r in zip(srcs, refs)]
            server.drain()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
        m = server.metrics()
        results = [server.result(sid) for sid in sids]
        for wav, _ in results:
            check_audio("serving", wav, pipe.sample_rate)
        if m["completed"] != len(srcs):
            raise AssertionError(f"serving: {m['completed']} of {len(srcs)} streams completed")
        expect("serving K3", n.k3, layers * m["decode_steps"])
        expect_none("serving", n, ("k1", "k4", "k5", "k6"))
        expect_int8("serving", n, layers if pipe.quantize else None, m["decode_steps"])
        lat_ms = np.asarray([stats["latency_s"] for _, stats in results]) * 1e3
        print("serving " + json.dumps({
            "run": run, "warm_up": run == 0, "streams": len(srcs), "slots": server.slots,
            "source_s": total_s, "wall_s": elapsed, "aggregate_rtf": elapsed / total_s,
            "first_audio_ms_p50": float(np.percentile(lat_ms, 50)),
            "first_audio_ms_p95": float(np.percentile(lat_ms, 95)),
            "ticks": m["ticks"], "mean_occupancy": m["mean_occupancy"],
            "admissions": m["admissions"], "decode_steps": m["decode_steps"],
            "k1_launches": n.k1, "k3_launches": n.k3, "k4_launches": n.k4,
            "int8_launches": n.q8, "quantize": pipe.quantize,
            "cache": str(pipe.cache_dtype), "gpu": gpu}), flush=True)
        drains.append(elapsed / total_s)
    return n.counts(), statistics.median(drains[1:] or drains)


def check_search_modes(pipe, engine, src, ref, da, fa, gpu, reorder, runs=1):
    """Offline beam search (4 beams), beam_sample (4), group beam search (4
    beams, 2 groups) and contrastive search (4 candidates) through
    ``synthesize``, and constrained beam search (4 beams, one two-token
    phrase) through ``engine.decode_constrained`` in ``synthesize``'s place of
    the segment decoder, on the 1.54 s source; each after one warm-up.
    Checks the audio and the launches (K1 30 per forward, K4 30 per latent
    pass, K3 / K5 / K6 none); prints wall ms, RTF and forwards, beside the
    beam reorder's device ms per step (``reorder``, phase 1's record at these
    shapes). Returns the launch counts of each mode's last run."""
    seconds = src.shape[-1] / 16000
    layers = pipe.gpt_cfg.layers

    def constrained_segment(codes, n_codes):
        prefix, valid, state = pipe._tiled_segment(codes, n_codes, 4)
        buf, n = engine.decode_constrained(
            pipe.gpt, state, prefix, valid, pipe._max_new(n_codes), 4, [[17, 3]],
            repetition_penalty=pipe.sampler.repetition_penalty,
            prefix_fake_len=pipe.gpt_cfg.n_cond_latents + n_codes + 3)
        return buf[:n].tolist(), state.steps

    modes = {
        "beam": lambda: pipe.synthesize(src, ref, num_beams=4),
        "beam_sample": lambda: pipe.synthesize(src, ref, num_beams=4, beam_do_sample=True),
        "group_beam": lambda: pipe.synthesize(src, ref, num_beams=4, num_beam_groups=2),
        "contrastive": lambda: pipe.synthesize(src, ref, penalty_alpha=0.6,
                                               contrastive_top_k=4),
        "constrained": lambda: pipe._synthesize_with(src, ref, constrained_segment),
    }
    by_path = {}
    for name, run_mode in modes.items():
        run_mode()  # warm-up
        rtf = []
        for run in range(runs):
            with Launches(da, fa) as n:
                t0 = time.perf_counter()
                wav = run_mode()
                torch.cuda.synchronize()
                elapsed = time.perf_counter() - t0
            timing = pipe.last_timing
            check_audio(name, wav, pipe.sample_rate)
            expect(f"{name} K1", n.k1, layers * timing["decode_steps"])
            expect(f"{name} K4", n.k4, layers * timing["latent_passes"])
            expect_none(name, n, ("k3", "k5", "k6"))
            rtf.append(elapsed / seconds)
            print(f"{name} run {run}: {seconds:.2f} s source, {wav.size} samples, "
                  f"{elapsed * 1e3:.1f} ms, RTF {rtf[-1]:.4f}, forwards "
                  f"{timing['decode_steps']}, latent passes {timing['latent_passes']}, "
                  f"K1 launches {n.k1}, K4 launches {n.k4}", flush=True)
        by_path[name] = n.counts()
        print(json.dumps({name: {
            "rtf_median": statistics.median(rtf), "runs": len(rtf),
            "forwards": timing["decode_steps"], "source_s": seconds,
            # contrastive search copies one slot a step instead of reordering
            "reorder_device_ms_per_step": None if name == "contrastive"
            else reorder["device_ms"], "gpu": gpu}}), flush=True)
    return by_path


def gpt_weight_bytes(gpt):
    """Bytes of the GPT's block projections and heads (weights, scales,
    biases), and of the whole GPT (parameters and buffers)."""
    def size(mods):
        return sum(t.numel() * t.element_size() for m in mods
                   for t in list(m.parameters()) + list(m.buffers()))
    linears = [lin for blk in gpt.core.blocks for lin in (
        blk.attn.c_attn, blk.attn.c_proj, blk.mlp.c_fc, blk.mlp.c_proj)]
    return size(linears + [gpt.mel_head, gpt.text_head]), size([gpt])


def decode_step_profile(pipe, engine, gpt_model):
    """A seeded 75-code prefix: its prefill logits (f32), then one lockstep
    decode step's device ms and kernel launches (``device_ms`` over 8 steps
    of a second, prefilled state)."""
    g = torch.Generator(device="cuda").manual_seed(5)
    cond = torch.randn(1, 32, pipe.gpt_cfg.model_dim, generator=g, device="cuda") * 0.05
    codes = torch.randint(0, 256, (1, 80), generator=g, device="cuda")
    with torch.inference_mode():
        prefix, valid = gpt_model.build_prefix_emb(pipe.gpt, cond, codes,
                                                   torch.tensor([75], device="cuda"))
        states = [engine.init_state(pipe.gpt_cfg, pipe._prefix_width, 1, "cuda",
                                    cache_dtype=pipe.cache_dtype, generator=pipe.generator,
                                    gen_tokens=pipe._cache_gen_tokens()) for _ in range(2)]
        _, logits = engine.prefill_logits(pipe.gpt, states[0], prefix, valid)
        engine.prefill(pipe.gpt, states[1], prefix, valid, pipe.sampler)
        step_ms, launches = device_ms(
            lambda: engine.decode_chunk(pipe.gpt, states[1], pipe.sampler, chunk=1),
            iters=8, warmup=3, same_per_call=False)
    return logits.float(), step_ms, launches


def check_quantized(pipeline, engine, gpt_model, server_cls, da, fa, gpu, tree, cfg,
                    bf16_pipe, bf16, src, ref, tiled, serve_srcs, serve_refs):
    """Phase 3b: the quantized serving configuration (bf16 GPT, int8 linears,
    e4m3 cache) from phase 3's weights. ``bf16`` holds phase 3's medians
    (same call) to print beside this arm's. Returns the launch counts of its
    paths."""
    t0 = time.perf_counter()
    pipe = pipeline.build_pipeline(tree, cfg, device="cuda", dtype=torch.bfloat16,
                                   quantize="int8", kv_cache_dtype="fp8")
    pipe.gen_cap_tokens_per_code = 1.875
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    layers = pipe.gpt_cfg.layers
    lq, step_q, launch_q = decode_step_profile(pipe, engine, gpt_model)
    lb, step_b, launch_b = decode_step_profile(bf16_pipe, engine, gpt_model)
    rel = float((lq - lb).norm() / lb.norm())
    (lin_q, all_q), (lin_b, all_b) = gpt_weight_bytes(pipe.gpt), gpt_weight_bytes(bf16_pipe.gpt)
    print("quantized_build " + json.dumps({
        "build_s": build_s, "linear_bytes_int8": lin_q, "linear_bytes_bf16": lin_b,
        "gpt_bytes_int8": all_q, "gpt_bytes_bf16": all_b,
        "prefill_logits_rel_err_vs_bf16": rel, "tol": 0.05,
        "decode_step_device_ms": {"int8_fp8": step_q, "bf16": step_b},
        "decode_step_kernel_launches": {"int8_fp8": launch_q, "bf16": launch_b},
        "gpu": gpu}), flush=True)
    if not rel < 0.05:
        raise AssertionError(f"quantized prefill logits {rel} from the bf16 pipeline's")
    by_path, arm = {}, {}

    pipe.synthesize_streaming(src, ref, verbose=False)  # warm-up
    lat, rtf = [], []
    for run in range(1):
        with Launches(da, fa) as n:
            wav, latency, r = pipe.synthesize_streaming(src, ref, verbose=False)
        steps = pipe.last_timing["decode_steps"]
        check_audio("quantized streaming", wav, pipe.sample_rate)
        expect("quantized streaming K1", n.k1, layers * steps)
        expect_none("quantized streaming", n, ("k3", "k4", "k5", "k6"))
        expect_int8("quantized streaming", n, layers, steps)
        lat.append(latency * 1e3)
        rtf.append(r)
        print(f"quantized streaming run {run}: {wav.size} samples, first-chunk latency "
              f"{latency * 1e3:.2f} ms, RTF {r:.4f}, decode steps {steps}, K1 launches "
              f"{n.k1}, int8 products {n.q8}", flush=True)
    by_path["quantized_streaming"] = n.counts()
    arm["streaming_latency_ms_median"] = statistics.median(lat)
    arm["streaming_rtf_median"] = statistics.median(rtf)

    seconds = tiled.shape[-1] / 16000
    with Launches(da, fa) as n:
        t0 = time.perf_counter()
        wav = pipe.synthesize(tiled, ref)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    timing = pipe.last_timing
    check_audio("quantized offline", wav, pipe.sample_rate)
    expect("quantized offline K1", n.k1, layers * timing["decode_steps"])
    expect("quantized offline K4", n.k4, layers * timing["latent_passes"])
    expect_none("quantized offline", n, ("k3", "k5", "k6"))
    expect_int8("quantized offline", n, layers, timing["decode_steps"], timing["latent_passes"])
    print(f"quantized offline: {seconds:.2f} s source, {wav.size} samples, "
          f"{elapsed * 1e3:.1f} ms, RTF {elapsed / seconds:.4f}, decode steps "
          f"{timing['decode_steps']}, K1 launches {n.k1}, K4 launches {n.k4}, int8 "
          f"products {n.q8}", flush=True)
    by_path["quantized_offline"] = n.counts()
    arm["offline_rtf"] = elapsed / seconds

    by_path["quantized_serving"], arm["drain_rtf"] = check_serving(
        pipe, server_cls, serve_srcs, serve_refs, da, fa, gpu, runs=1)
    arm["decode_step_kernel_launches"] = launch_q
    bf16["decode_step_kernel_launches"] = launch_b
    print("quantized_vs_bf16 " + json.dumps({"int8_fp8": arm, "bf16": bf16, "gpu": gpu}),
          flush=True)
    del pipe
    return by_path


def _stage_trees(paths):
    from genvc_tpu_torch import checkpoint as ckpt

    return {"contentvec": ckpt.load_contentvec(paths["contentvec"]),
            "acoustic_dvae": ckpt.load_dvae(paths["acoustic_dvae"]),
            "content_dvae": ckpt.load_dvae(paths["content_dvae"])}


def check_small_train_against_cpu(da, fa, tmp):
    """Two GPT training steps of a small f32 configuration (the synthetic
    stage checkpoints: GPT 2 x 64, hd = 16; ContentVec 1 layer; dVAEs hidden
    16) on the card (K4 / K5 / K6) and on the CPU (their plain versions) from
    the same files and batch, ``adamw_grouped`` (lr 1e-3 halved at step 1,
    weight decay 0.1, Adam eps 1e-3). Codes identical; losses, top-10 and
    gradient norms within 1e-4 relative (f32 on both sides, TF32 off, sums in
    other orders); parameters within 1e-5 (updates are ~lr = 1e-3; the large
    eps keeps noise-level gradients from being normalized up to ~lr)."""
    import numpy as np

    from genvc_tpu_torch import checkpoint as ckpt
    from genvc_tpu_torch import config, resolve_device
    from genvc_tpu_torch.models import gpt as gpt_model
    from genvc_tpu_torch.testing_synthetic import write_stage_ckpts
    from genvc_tpu_torch.train import gpt_stage, optim

    paths = write_stage_ckpts(os.path.join(tmp, "small"))
    cfg = config.GenVCConfig()
    for c, ch, nt in ((cfg.acoustic_dvae_config, 80, 64), (cfg.content_dvae_config, 256, 36)):
        c.num_channels, c.num_tokens, c.hidden_dim, c.codebook_dim = ch, nt, 16, 24
        c.num_resnet_blocks = 3
    gcfg = gpt_model.GPTConfig(layers=2, model_dim=64, heads=4)
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((2, 1, 6 * 1920)) * 0.1).astype(np.float32)
    wav[1, :, 4 * 1920:] = 0
    batch = {"wav": wav, "wav_lengths": np.asarray([6 * 1920, 4 * 1920]),
             "conditioning": (rng.standard_normal((2, 1, 1, 48000)) * 0.1).astype(np.float32),
             "cond_lens": np.asarray([48000, 30000]), "text_lengths": np.asarray([6, 4])}
    runs = {}
    for dev in ("cpu", "cuda"):
        dev = resolve_device(dev)
        frozen = gpt_stage.make_frozen(cfg, _stage_trees(paths), np.ones(80, np.float32), dev)
        with torch.device("meta"):
            model = gpt_model.GPT(gcfg)
        ckpt.assign(model, ckpt.load_gpt(paths["gpt"], gcfg.layers), dev)
        flat = optim.FlatParams(model)
        tx = optim.adamw_grouped(optim.multistep_schedule(1e-3, [1], 0.5), eps=1e-3,
                                 weight_decay=0.1, params=flat).init(flat.flat)
        state = gpt_stage.GPTTrainState(model, flat, tx)
        step, _ = gpt_stage.make_train_step(attn_impl="flash", grad_norms=True)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        feats = gpt_stage.prepare_features(frozen, tb)
        metrics = []
        with Launches(da, fa) as n:
            for _ in range(2):
                state, m = step(state, tb, frozen)
                metrics.append({k: float(v) for k, v in m.items()})
        runs[dev.type] = (feats, metrics, ckpt.export_tree(model), n)
    (fc, mc, pc, _), (fg, mg, pg, ng) = runs["cpu"], runs["cuda"]
    if (ng.k4, ng.k5, ng.k6) != (4, 4, 4):
        raise AssertionError(f"small train step: K4/K5/K6 launched {ng.k4}/{ng.k5}/{ng.k6} "
                             "times, expected 4 each (2 layers x 2 steps)")
    for k in ("audio_codes", "text_inputs"):
        if not torch.equal(fc[k], fg[k].cpu()):
            raise AssertionError(f"small train step: {k} differ between card and CPU")
    worst = 0.0
    for a, b in zip(mc, mg):
        for k in a:
            rel = abs(a[k] - b[k]) / max(abs(a[k]), 1e-6)
            worst = max(worst, rel)
            if rel > 1e-4 and abs(a[k] - b[k]) > 1e-6:
                raise AssertionError(f"small train step: {k} {b[k]} on the card vs {a[k]}")

    def leaves(t, prefix=""):
        for k_, v_ in t.items():
            if isinstance(v_, dict):
                yield from leaves(v_, prefix + k_ + ".")
            else:
                yield prefix + k_, v_
    pcpu = dict(leaves(pc))
    perr = max(float(np.abs(pcpu[k_] - v_).max()) for k_, v_ in leaves(pg))
    if perr > 1e-5:
        raise AssertionError(f"small train step: parameters differ by {perr} after 2 steps")
    print("small f32 config training, card vs CPU: 2 steps, losses "
          f"{[m['loss'] for m in mg]} vs {[m['loss'] for m in mc]}, grad_norm/total "
          f"{[m['grad_norm/total'] for m in mg]}, max rel metric err {worst:.2e} (tol 1e-4), "
          f"max |param err| {perr:.2e} (tol 1e-5), codes identical, K4/K5/K6 launches "
          f"{ng.k4}/{ng.k5}/{ng.k6}", flush=True)


def write_training_assets(tmp):
    """Frozen stage checkpoints at flagship width in the reference formats
    (seeded random weights: ContentVec 12 layers; acoustic dVAE 80 ch / 1024
    tokens and content dVAE 256 ch / 256 tokens, codebook 512, hidden 512;
    the acoustic decoder's output scaled to a log-mel's range)
    and a metafile of 48 wavs, each a sample tiled to >= 8.5 s at 24 kHz
    (rolled so no two are equal). Returns (paths, metafile)."""
    import numpy as np

    from genvc_tpu_torch import testing_synthetic as ts
    from genvc_tpu_torch.dsp.audio_io import load_audio, write_wav

    torch.manual_seed(0)
    paths = {"contentvec": os.path.join(tmp, "contentvec.pt"),
             "acoustic_dvae": os.path.join(tmp, "acoustic_dvae.pth"),
             "content_dvae": os.path.join(tmp, "content_dvae.pth")}
    torch.save({"model": ts.contentvec_sd(prefix="", n_layers=12)}, paths["contentvec"])
    acoustic = ts.dvae_sd("", 80, 1024, codebook_dim=512, hidden=512)
    # the decoder's output conv scaled so the random decoder's log-mel stays
    # within about +-5 (unscaled it reaches ~4000, and the listening samples'
    # exp of the de-normalized mel overflows to inf, Griffin-Lim to NaN)
    acoustic["decoder.6.weight"] *= 1e-3
    torch.save(acoustic, paths["acoustic_dvae"])
    torch.save(ts.dvae_sd("", 256, 256, codebook_dim=512, hidden=512), paths["content_dvae"])
    srcs = [load_audio(os.path.join(HERE, "samples", f), 24000)[0]
            for f in ("EF4_ENG_0112_1.wav", "EM1_ENG_0037_1.wav")]
    meta = os.path.join(tmp, "train.txt")
    with open(meta, "w") as f:
        for i in range(48):
            src = srcs[i % 2]
            wav = np.roll(np.tile(src, -(-int(8.5 * 24000) // src.size)), 4801 * i)
            path = os.path.join(tmp, f"w{i}.wav")
            write_wav(path, wav, 24000)
            f.write(f"{path}|spk{i % 2}\n")
    return paths, meta


def check_training(da, fa, tmp, gpu, paths, meta):
    """Phase 4: GPT training at flagship width through the runner, then steps
    on one fixed batch. Returns the runner run's launch counts."""
    import random

    import numpy as np

    from genvc_tpu_torch import checkpoint as ckpt
    from genvc_tpu_torch.train import gpt_stage, runner
    from genvc_tpu_torch.train_genVC import recipe_config

    cfg = recipe_config(meta, meta, os.path.join(HERE, "pre_trained", "mel_stats.npy"),
                        paths["acoustic_dvae"], paths["content_dvae"], paths["contentvec"],
                        output_path=os.path.join(tmp, "exp"), batch_size=8, num_workers=4)
    ma = cfg.model_args
    ma.min_text_length = ma.max_text_length = 50
    cfg.print_step = 1
    layers, steps, b, text_len = ma.gpt_layers, 6, cfg.batch_size, 50

    # the entry point: one epoch of 48 wavs, 1 warm-up + 5 timed steps, one
    # eval batch (K4 30 more), the listening samples, a checkpoint
    cfg.epochs = 1
    torch.cuda.reset_peak_memory_stats()
    with Launches(da, fa) as n, ListeningSamples() as samples:
        t0 = time.perf_counter()
        state = runner.run_gpt_training(cfg, max_eval_batches=1, bf16=True, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak_b8 = torch.cuda.max_memory_allocated()
    expect("training K4", n.k4, layers * (steps + 1))
    for k in ("k5", "k6"):
        expect(f"training {k.upper()}", getattr(n, k), layers * steps)
    expect_none("training", n, ("k1", "k3"))
    counts = n.counts()
    listening = samples.check(os.path.join(cfg.output_path, "eval_samples"))
    with open(os.path.join(cfg.output_path, "train_log.jsonl")) as f:
        log = [r for r in map(json.loads, f) if "steps_per_sec" in r]
    losses = [r["loss"] for r in log]
    step_ms = [1e3 / r["steps_per_sec"] for r in log]
    if len(log) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"training: {len(log)} logged steps, losses {losses}")
    del state

    # resume from the step-6 checkpoint for one more step
    cfg.epochs = 2
    with Launches(da, fa) as n:
        state = runner.run_gpt_training(cfg, max_steps=steps + 1, bf16=True, device="cuda")
    if state.step != steps + 1 or state.opt.count != steps + 1:
        raise AssertionError(f"resume: step {state.step}, optimizer count {state.opt.count}")
    expect("resumed K5", n.k5, layers)

    # one fixed batch: the step timed with a device sync, flash vs xla in turns
    frozen = gpt_stage.make_frozen(cfg, _stage_trees(paths),
                                   ckpt.load_mel_norms(ma.mel_norm_file), torch.device("cuda"))
    train_ds, _ = runner.datasets(cfg)
    batch = runner.to_device(train_ds.collate(list(range(b)), random.Random(0)), "cuda")
    feats = gpt_stage.prepare_features(frozen, batch)
    t_len = 32 + feats["text_inputs"].shape[1] + 2 + feats["audio_codes"].shape[1] + 2
    step_fns = {impl: gpt_stage.make_train_step(compute_dtype=torch.bfloat16,
                                                attn_impl=impl)[0] for impl in ("flash", "xla")}
    times, fixed_losses = {"flash": [], "xla": []}, []

    def run(impl, k, record=True):
        nonlocal state
        for _ in range(k):
            with Launches(da, fa) as n:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step_fns[impl](state, batch, frozen)
                loss = float(m["loss"])
                ms = (time.perf_counter() - t0) * 1e3
            want = layers if impl == "flash" else 0
            if (n.k4, n.k5, n.k6) != (want, want, want) or n.k1 or n.k3:
                raise AssertionError(f"fixed-batch {impl} step launches {n.counts()}")
            fixed_losses.append(loss)
            if record:
                times[impl].append(ms)

    run("flash", 1, record=False)
    run("xla", 1, record=False)
    for impl in ("flash", "xla", "xla", "flash"):
        run(impl, 3)
    if not (all(np.isfinite(fixed_losses)) and fixed_losses[-1] < fixed_losses[0]):
        raise AssertionError(f"fixed batch: losses did not fall: {fixed_losses}")

    remat_rec = check_remat(da, fa, gpu, state, batch, frozen, layers)
    content_rec = check_content_bf16(da, fa, gpu, state, batch, frozen, layers)

    # the recipe's B = 24 with 100-token texts: one step, peak memory
    ma.min_text_length = ma.max_text_length = 100
    train_ds, _ = runner.datasets(cfg)
    batch = runner.to_device(train_ds.collate(list(range(24)), random.Random(1)), "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = step_fns["flash"](state, batch, frozen)
    loss24 = float(m["loss"])
    ms24 = (time.perf_counter() - t0) * 1e3
    peak_b24 = torch.cuda.max_memory_allocated()
    if not np.isfinite(loss24):
        raise AssertionError(f"B=24 step: loss {loss24}")

    # bench_train.py's analytic count: 6 * sequence tokens * core parameters
    def flops(bsz, tl):
        return 6 * bsz * (32 + tl + 2 + tl * 1920 // 1024 + 6) * 12 * layers * 1024 ** 2

    med = {k: statistics.median(v) for k, v in times.items()}
    rec = {"batch": b, "text_len": text_len, "T": t_len, "layers": layers,
           "dtype": "bf16 on f32 masters", "attn_impl": "flash",
           "runner_steps": steps, "runner_wall_s": wall,
           "runner_step_ms": step_ms, "runner_step_ms_median_timed": statistics.median(
               step_ms[1:]), "runner_losses": losses,
           "fixed_batch_step_ms": times["flash"], "step_ms_median": med["flash"],
           "step_ms_min": min(times["flash"]), "step_ms_max": max(times["flash"]),
           "tokens_per_s": b * text_len * 2.875 / (med["flash"] / 1e3),
           "mfu": flops(b, text_len) / (med["flash"] / 1e3) / BF16_FLOPS,
           "xla_step_ms": times["xla"], "xla_step_ms_median": med["xla"],
           "xla_over_flash": med["xla"] / med["flash"], "fixed_batch_losses": fixed_losses,
           "max_memory_allocated_b8": peak_b8, "resumed_to_step": steps + 1,
           "b24_text_len": 100, "b24_step_ms": ms24, "b24_loss": loss24,
           "b24_mfu": flops(24, 100) / (ms24 / 1e3) / BF16_FLOPS,
           "max_memory_allocated_b24": peak_b24, "launches": counts,
           "listening_samples": listening, "gpu": gpu}
    print("training " + json.dumps(rec), flush=True)
    return counts, remat_rec["launches"], content_rec["launches"]


REMAT_SETTINGS = (False, True, "dots")


def check_remat(da, fa, gpu, state, batch, frozen, layers):
    """Phase 4, activation checkpointing on the fixed batch (B = 8, bf16 on
    f32 masters, the kernels' path). The loss and gradient of the step
    without remat (taken twice: the card's own run-to-run spread), with
    ``remat=True`` and with ``"dots"``: loss and every gradient element must
    be bit-equal, K4 launched 30 / 60 / 60 times (the recompute runs the
    attention forward again), K5 = K6 = 30; the memory the forward keeps for
    the backward and the forward and backward's peak, each above what was
    allocated before them. Then whole steps of each
    setting (1 warm-up, 3 timed to a device sync): step ms and the step's
    peak memory."""
    import numpy as np

    from genvc_tpu_torch.train import gpt_stage

    feats = gpt_stage.prepare_features(frozen, batch)
    feats = dict(feats, cond_mels=feats["cond_mels"].to(torch.bfloat16))

    def grad(remat):
        flat = state.params.flat
        flat.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with Launches(da, fa) as n:
            loss, _ = gpt_stage.loss_fn(state.model, state.params.tensors(torch.bfloat16), feats,
                                        0.01, 1.0, True, "flash", remat)
            n.kept = torch.cuda.memory_allocated() - base
            loss.backward()
            torch.cuda.synchronize()
        n.peak = torch.cuda.max_memory_allocated() - base
        g, flat.grad = flat.grad, None
        return loss.detach(), g, n

    runs = {"no_remat": grad(False), "no_remat_again": grad(False),
            "remat": grad(True), "dots": grad("dots")}
    loss0, g0, _ = runs["no_remat"]
    diffs = {}
    for name, (loss, g, n) in runs.items():
        k4 = layers * (1 if name.startswith("no_remat") else 2)
        if (n.k4, n.k5, n.k6) != (k4, layers, layers) or n.k1 or n.k3:
            raise AssertionError(f"remat {name}: launches {n.counts()}, expected K4 {k4}, "
                                 f"K5 = K6 = {layers}")
        diffs[name] = {"loss_bit_equal": bool(torch.equal(loss, loss0)),
                       "grad_bit_equal": bool(torch.equal(g, g0)),
                       "grad_max_abs_diff": float((g - g0).abs().max()),
                       "grad_elements_differing": int((g != g0).sum()),
                       "kept_for_backward_bytes": n.kept,
                       "fwd_bwd_peak_bytes_above_start": n.peak,
                       "k4": n.k4, "k5": n.k5, "k6": n.k6}
    for name in ("remat", "dots"):
        if not (diffs[name]["loss_bit_equal"] and diffs[name]["grad_bit_equal"]):
            raise AssertionError(f"remat {name}: loss / gradients differ from the step "
                                 f"without remat: {diffs}")
    del runs, g0

    steps, launches = {}, {}
    for r in REMAT_SETTINGS:
        step = gpt_stage.make_train_step(compute_dtype=torch.bfloat16, remat=r)[0]
        ms = []
        for i in range(4):
            torch.cuda.synchronize()
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            with Launches(da, fa) as n:
                t0 = time.perf_counter()
                _, m = step(state, batch, frozen)
                loss = float(m["loss"])
                if i:
                    ms.append((time.perf_counter() - t0) * 1e3)
            if not np.isfinite(loss) or n.k4 != layers * (2 if r else 1):
                raise AssertionError(f"remat={r} step: loss {loss}, launches {n.counts()}")
        name = {False: "no_remat", True: "remat", "dots": "dots"}[r]
        launches[f"training_{name}"] = n.counts()
        steps[name] = {"step_ms": ms, "step_ms_median": statistics.median(ms),
                       "max_memory_allocated": torch.cuda.max_memory_allocated(),
                       "k4_per_step": n.k4, "k5_per_step": n.k5, "k6_per_step": n.k6}
    rec = {"batch": batch["wav"].shape[0], "grads": diffs, "steps": steps, "gpu": gpu}
    print("remat " + json.dumps(rec), flush=True)
    return {"launches": launches}


def check_content_bf16(da, fa, gpu, state, batch, frozen, layers):
    """Phase 4, the bf16 ContentVec on the fixed batch: the share of content
    codes that flip against the f32 ContentVec (all positions, and the valid
    ones), the acoustic labels unchanged, the ContentVec's time in f32 and
    bf16 (CUDA events around 10 calls; one traced call's device time,
    launches and costliest kernels), and one ``content_dtype`` step."""
    import numpy as np
    import torch.nn.functional as F

    from genvc_tpu_torch.dsp.resample import resample
    from genvc_tpu_torch.train import gpt_stage

    f32 = gpt_stage.prepare_features(frozen, batch)
    b16 = gpt_stage.prepare_features(frozen, batch, content_dtype=torch.bfloat16)
    if not torch.equal(f32["audio_codes"], b16["audio_codes"]):
        raise AssertionError("content_bf16 changed the acoustic labels")
    codes, codes16 = f32["text_inputs"], b16["text_inputs"]
    valid = (torch.arange(codes.shape[1], device=codes.device)[None, :]
             < f32["text_lengths"][:, None])
    flips = codes != codes16
    wav = batch["wav"][:, 0, :]
    pad = int(frozen.text_frame_rate * frozen.content_sample_rate)
    content_wav = F.pad(resample(wav, frozen.sample_rate, frozen.content_sample_rate), (0, pad))
    cv_ms, cv_prof = {}, {}
    with torch.no_grad():
        for name, dt in (("f32", None), ("bf16", torch.bfloat16)):
            run = lambda: frozen.contentvec(content_wav, compute_dtype=dt)  # noqa: E731
            cv_ms[name] = time_ms(run, iters=10, warmup=2)
            cv_prof[name] = kernel_profile(run)
    step = gpt_stage.make_train_step(compute_dtype=torch.bfloat16,
                                     content_dtype=torch.bfloat16)[0]
    with Launches(da, fa) as n:
        _, m = step(state, batch, frozen)
        loss = float(m["loss"])
    if not np.isfinite(loss) or (n.k4, n.k5, n.k6) != (layers, layers, layers):
        raise AssertionError(f"content_bf16 step: loss {loss}, launches {n.counts()}")
    rec = {"codes": codes.numel(), "flipped": int(flips.sum()),
           "flip_share": float(flips.float().mean()),
           "valid_codes": int(valid.sum()), "valid_flipped": int((flips & valid).sum()),
           "valid_flip_share": float((flips & valid).sum() / valid.sum()),
           "contentvec_ms_f32": cv_ms["f32"], "contentvec_ms_bf16": cv_ms["bf16"],
           "contentvec_speedup": cv_ms["f32"] / cv_ms["bf16"],
           "contentvec_traced": cv_prof,
           "step_loss": loss,
           "content_wav_shape": list(content_wav.shape), "gpu": gpu}
    print("content_bf16 " + json.dumps(rec), flush=True)
    return {"launches": {"training_content_bf16": n.counts()}}


class ListeningSamples:
    """Times ``eval_samples.generate_eval_samples`` while the runner calls it
    at an epoch's end (the runner imports it at that call) and keeps what it
    returned; :meth:`check` then holds those waveforms finite and the two
    files written from them (``e<epoch>_self.wav``, ``e<epoch>_cross<row>.wav``)
    to ``check_audio``."""

    def __enter__(self):
        from genvc_tpu_torch.train import eval_samples

        self.module, self.generate, self.runs = eval_samples, eval_samples.generate_eval_samples, []

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.generate(*args, **kw)
            self.runs.append((time.perf_counter() - t0, out))
            return out

        eval_samples.generate_eval_samples = timed
        return self

    def __exit__(self, *exc):
        self.module.generate_eval_samples = self.generate
        return False

    def check(self, sample_dir):
        import numpy as np

        from genvc_tpu_torch.dsp.audio_io import read_wav

        names = sorted(os.listdir(sample_dir)) if os.path.isdir(sample_dir) else []
        if len(self.runs) != 1 or len(names) != 2 or "e0_self.wav" not in names:
            raise AssertionError(f"on_epoch_end wrote {names} ({len(self.runs)} sample runs)")
        seconds, (self_wav, cross_wav, tgt) = self.runs[0]
        for name, wav in (("self", self_wav), ("cross", cross_wav)):
            if not (wav.size and np.isfinite(wav).all()):
                raise AssertionError(f"listening sample {name}: not finite")
        rec = {"files": names, "generate_eval_samples_s": seconds, "target_row": tgt,
               "peak_abs": [float(np.abs(w).max()) for w in (self_wav, cross_wav)]}
        for name in names:
            audio, sr = read_wav(os.path.join(sample_dir, name))
            check_audio(f"listening sample {name}", audio[0], sr)
            rec[name + "_s"] = audio.shape[1] / sr
        print("listening samples " + json.dumps(rec), flush=True)
        return rec


# ---- phase 5: dVAE training (stages 1-2) and the HiFi-GAN GAN (stage 4)

VOC_PARAM_TOL = 4e-6   # 2 % of the 2e-4 one step of lr 2e-4 can move a parameter
VAE_PARAM_TOL = 2e-6   # 2 % of one step of lr 1e-4
STAGE_LOSS_TOL = 1e-4  # relative: f32 on both sides, TF32 off, sums in other orders


def check_small_stages_against_cpu(da, fa, tmp):
    """One GAN step (all four families at the smallest filters, the synthetic
    2 x 64 GPT frozen, K4 on the card) and one dVAE step (mel features) of a
    small f32 configuration on the card and on the CPU from the same weights
    and batch, Adam's eps 1e-3 (see tests/test_torch_train.py). Losses within
    STAGE_LOSS_TOL relative; parameters within VOC_PARAM_TOL / VAE_PARAM_TOL;
    the spectral-norm buffers and the EMA codebook within 1e-5 relative."""
    import numpy as np

    from genvc_tpu_torch import checkpoint as ckpt
    from genvc_tpu_torch import config, resolve_device
    from genvc_tpu_torch.models import dvae, gpt as gpt_model, hifigan
    from genvc_tpu_torch.testing_synthetic import write_stage_ckpts
    from genvc_tpu_torch.train import gpt_stage, optim, vae_stage, vocoder_stage

    paths = write_stage_ckpts(os.path.join(tmp, "small5"))
    cfg = config.GenVCConfig()
    for c, ch, nt in ((cfg.acoustic_dvae_config, 80, 64), (cfg.content_dvae_config, 256, 36)):
        c.num_channels, c.num_tokens, c.hidden_dim, c.codebook_dim = ch, nt, 16, 24
        c.num_resnet_blocks = 3
    vcfg = config.VocoderConfig(input_feat_dim=64, upsample_initial_channel=16,
                                msstftd_filters=4, mssbcqtd_filters=4,
                                mssbcqtd_hop_lengths=[512], mssbcqtd_n_octavess=[5],
                                mssbcqtd_bins_per_octave=[12])
    gcfg = gpt_model.GPTConfig(layers=2, model_dim=64, heads=4)
    gen_tree = hifigan.generator_to_weight_norm(
        hifigan.init_tree(torch.Generator().manual_seed(4), vcfg))
    disc_tree = ckpt.export_tree(vocoder_stage.init_discriminators(
        torch.Generator().manual_seed(5), vcfg))
    dcfg = dvae.DVAEConfig(channels=80, num_tokens=32, codebook_dim=16, hidden_dim=8,
                           num_resnet_blocks=1)
    vae_tree = dvae.init_tree(torch.Generator().manual_seed(6), dcfg, trainable=True)
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((2, 1, 2 * 1920)) * 0.1).astype(np.float32)
    wav[1, :, 1920:] = 0
    batch = {"wav": wav, "wav_lengths": np.asarray([2 * 1920, 1920]),
             "conditioning": (rng.standard_normal((2, 1, 1, 24000)) * 0.1).astype(np.float32),
             "cond_lens": np.asarray([24000, 18000]), "text_lengths": np.asarray([2, 1])}
    vae_wav = (rng.standard_normal((2, 1, 12000)) * 0.1).astype(np.float32)
    vae_cfg = config.VAEConfig(num_channels=80, num_tokens=32, codebook_dim=16, hidden_dim=8,
                               num_resnet_blocks=1)
    runs = {}
    for dev in ("cpu", "cuda"):
        dev = resolve_device(dev)
        frozen = gpt_stage.make_frozen(cfg, _stage_trees(paths), np.ones(80, np.float32), dev)
        with torch.device("meta"):
            gpt = gpt_model.GPT(gcfg)
            generator = hifigan.Generator(vcfg, weight_norm=True)
            discs = hifigan.Discriminators(vcfg)
            vae = dvae.DVAE(dcfg, trainable=True)
        ckpt.assign(gpt, ckpt.load_gpt(paths["gpt"], gcfg.layers), dev)
        ckpt.assign(generator, gen_tree, dev)
        ckpt.assign(discs, disc_tree, dev)
        ckpt.assign(vae, vae_tree, dev)
        gp, dp, vp = (optim.FlatParams(m) for m in (generator, discs, vae))
        gen_opt, disc_opt = (optim.AdamW(2e-4, (0.8, 0.99), 1e-3, 0.01, None).init(p.flat)
                             for p in (gp, dp))
        state = vocoder_stage.VocoderTrainState(generator, discs, gp, dp, gen_opt, disc_opt)
        step, _ = vocoder_stage.make_train_step(vcfg)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        latents, _ = vocoder_stage.prepare_vocoder_batch(frozen, gpt.eval(), tb)
        with Launches(da, fa) as n:
            state, m = step(state, tb, frozen, gpt)
        vstate = vae_stage.VAETrainState(
            vae, vp, optim.AdamW(1e-4, (0.5, 0.9), 1e-3, 0.0, 0.5).init(vp.flat))
        vstep, _ = vae_stage.make_train_step(vae_stage.make_feature_fn(vae_cfg))
        vstate, vm = vstep(vstate, {"wav": torch.from_numpy(vae_wav).to(dev)},
                           torch.ones(80, device=dev))
        runs[dev.type] = ({k: float(v) for k, v in m.items()} | {
            f"vae_{k}": float(v) for k, v in vm.items()}, latents.cpu().numpy(),
            ckpt.export_tree(generator), ckpt.export_tree(discs), ckpt.export_tree(vae), n)
    (mc, lc, gc, dc, vc, _), (mg, lg, gg, dg, vg, ng) = runs["cpu"], runs["cuda"]
    if ng.k4 != gcfg.layers or ng.k5 or ng.k6:
        raise AssertionError(f"small GAN step: K4/K5/K6 launched {ng.k4}/{ng.k5}/{ng.k6} "
                             f"times, expected {gcfg.layers}/0/0")
    worst = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6) for k in mc)
    if worst > STAGE_LOSS_TOL:
        raise AssertionError(f"small stages: losses {mg} on the card vs {mc}")

    def leaves(t, prefix=""):
        for k_, v_ in t.items():
            if isinstance(v_, dict):
                yield from leaves(v_, f"{prefix}{k_}.")
            elif isinstance(v_, list):
                yield from leaves(dict(enumerate(v_)), f"{prefix}{k_}.")
            else:
                yield f"{prefix}{k_}", v_

    errs = {}
    for name, a, b, tol in (("generator", gg, gc, VOC_PARAM_TOL),
                            ("discriminators", dg, dc, VOC_PARAM_TOL),
                            ("dvae", vg, vc, VAE_PARAM_TOL)):
        a, b = dict(leaves(a)), dict(leaves(b))
        buf = {k for k in a if k.rsplit(".", 1)[-1] in ("u", "pv", "embed", "cluster_size",
                                                      "embed_avg")}
        err = max(float(np.abs(a[k] - b[k]).max()) for k in a if k not in buf)
        rel = max((float(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-30))
                   for k in buf), default=0.0)
        if err > tol or rel > 1e-5:
            raise AssertionError(f"small stages: {name} parameters differ by {err} "
                                 f"(tol {tol}), buffers by {rel} relative (tol 1e-5)")
        errs[name] = (err, rel)
    lat_err = float(np.abs(lg - lc).max())
    if lat_err > 1e-5:
        raise AssertionError(f"small GAN step: latents differ by {lat_err}")
    print("small f32 stages, card vs CPU: GAN step losses "
          f"{[mg[k] for k in ('loss_disc', 'loss_gen', 'mel_loss')]} vs "
          f"{[mc[k] for k in ('loss_disc', 'loss_gen', 'mel_loss')]}, dVAE step "
          f"{mg['vae_loss']} vs {mc['vae_loss']}, max rel loss err {worst:.2e} "
          f"(tol {STAGE_LOSS_TOL}), latents {lat_err:.2e} (tol 1e-5), |param err| / rel "
          f"buffer err {json.dumps({k: [f'{e:.2e}', f'{r:.2e}'] for k, (e, r) in errs.items()})} "
          f"(tol {VOC_PARAM_TOL} / {VAE_PARAM_TOL}, 1e-5), K4 launches {ng.k4}", flush=True)


def vocoder_recipe(tmp, paths, meta, steps):
    """``train_vocoder``'s recipe over the training assets (a metafile of
    64 x ``steps`` lines) with a flagship GPT (30 x 1024, 4 heads; seeded,
    written through ``export_gpt``), and (B, T) of the frozen GPT's latent
    pass under it: 32 conditioning latents, the 8-token text with start and
    stop, the audio codes with their pad of 4 and start and stop."""
    import random

    import numpy as np

    from genvc_tpu_torch import checkpoint as ckpt
    from genvc_tpu_torch.models import gpt as gpt_model
    from genvc_tpu_torch.train import gpt_stage, runner
    from genvc_tpu_torch.train_vocoder import recipe_config

    gpt_path = os.path.join(tmp, "gpt_flagship.pth")
    gcfg = gpt_model.GPTConfig(layers=30, model_dim=1024, heads=4)
    sd = ckpt.export_gpt(gpt_model.init_tree(torch.Generator().manual_seed(11), gcfg))
    torch.save({"model": {"gpt." + k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()}, "config": {}}, gpt_path)
    del sd
    vmeta = _repeat_meta(meta, os.path.join(tmp, "voc.txt"), 64 * steps)
    cfg = recipe_config(vmeta, vmeta, os.path.join(HERE, "pre_trained", "mel_stats.npy"),
                        paths["acoustic_dvae"], paths["content_dvae"], paths["contentvec"],
                        gpt_path, output_path=os.path.join(tmp, "exp_voc"), num_workers=8)
    cfg.print_step = 1
    frozen = gpt_stage.make_frozen(cfg, _stage_trees(paths), np.ones(80, np.float32),
                                   torch.device("cuda"))
    train_ds, _ = runner.datasets(cfg)
    batch = runner.to_device(train_ds.collate(list(range(cfg.batch_size)), random.Random(0)),
                             "cuda")
    feats = gpt_stage.prepare_features(frozen, batch)
    t = 32 + feats["text_inputs"].shape[1] + 2 + feats["audio_codes"].shape[1] + 2
    return cfg, (cfg.batch_size, t)


def check_flash_vocoder_shape(fa, b, t):
    """K4 at the vocoder stage's latent pass (the frozen f32 GPT: B = 64, T as
    the recipe gives it, the last key column masked as the pass masks it for
    these lengths) against its plain version; kernel, plain version and
    masked SDPA times, device times and the bound (bytes over 3.35 TB/s or
    f32 operations over 67 TFLOP/s)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    h, hd, dt = 4, 256, torch.float32
    q, k, v, valid = flash_inputs(b, t, hd, dt, 0, seed=500)
    valid[:, t - 1:] = False
    got_o, got_lse = fa.flash_attention_fwd(q, k, v, valid, None, True)
    torch.cuda.synchronize()
    want_o, want_lse = fa.flash_attention_plain(q, k, v, valid, None, True)
    err_o = (got_o - want_o).abs()
    err_lse = float((got_lse - want_lse).abs().max())
    tol = FLASH_TOL[dt]
    if not bool((err_o <= tol + tol * want_o.abs()).all()) or err_lse > LSE_TOL:
        raise AssertionError(f"flash_attention at the vocoder shape B={b} T={t}: max |err| "
                             f"O {float(err_o.max())}, LSE {err_lse}")
    mask = valid[:, None, None, :] & torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
    n_bytes = 4 * b * h * t * hd * 4 + b * h * t * 4 + b * t
    flops = 2 * b * h * t * (t + 1) * hd
    dev, _ = device_ms(lambda: fa.flash_attention_fwd(q, k, v, valid, None, True))
    lib_dev, _ = device_ms(lambda: sdpa(q, k, v, attn_mask=mask))
    rec = {"B": b, "T": t, "hd": hd, "dtype": "float32", "max_abs_err": float(err_o.max()),
           "max_abs_err_lse": err_lse, "tol": tol,
           "ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v, valid, None, True)),
           "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, valid, None, True),
                               iters=50),
           "library_ms": time_ms(lambda: sdpa(q, k, v, attn_mask=mask)),
           "device_ms": dev, "library_device_ms": lib_dev, "device_ratio": ratio(dev, lib_dev),
           "bound_ms": max(n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3,
           "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= flops / F32_FLOPS
           else "operations", "bytes": n_bytes, "flops": flops}
    print("flash_attention vocoder shape " + json.dumps(rec), flush=True)
    return rec


def device_busy_ms(fn, iters=2):
    """Device busy time of one call of ``fn`` in a ``torch.profiler`` trace
    of ``iters`` calls: the union of its kernels' time ranges (kernels of one
    call may overlap, so their summed durations can exceed the wall time),
    the summed durations, and the host's kernel launches, each per call."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in events
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a >= end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    n_launch = sum(1 for ev in events if ev.device_type != torch.autograd.DeviceType.CUDA
                   and "LaunchKernel" in ev.name)
    return (busy / iters / 1e3, sum(b - a for a, b in spans) / iters / 1e3,
            n_launch / iters)


def _repeat_meta(meta, path, lines):
    """A metafile of ``lines`` lines cycling over ``meta``'s wavs."""
    with open(meta) as f:
        rows = f.read().splitlines()
    with open(path, "w") as f:
        f.write("\n".join(rows[i % len(rows)] for i in range(lines)) + "\n")
    return path


def _timed_steps(step, n_timed):
    """1 warm-up and ``n_timed`` steps, each timed to a device sync."""
    out = []
    for i in range(1 + n_timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        if i:
            out.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(loss):
            raise AssertionError(f"step {i}: loss {float(loss)}")
    return out


VOCODER_STEPS = 3  # 1 warm-up + 2 timed


def check_vocoder_training(da, fa, cfg, paths, gpu, t_latent):
    """Phase 5a: the HiFi-GAN GAN step (stage 4) at the recipe's full width
    through ``run_vocoder_training`` (``vocoder_recipe``): batch 64 of
    8-token (0.64 s) segments, all four discriminator families at
    ``VocoderConfig()``, the 30 x 1024 frozen GPT, f32 with TF32 off; 1
    warm-up and 2 timed steps, then a checkpoint; K4 = 30 a step (the latent
    pass), K1 = K3 = K5 = K6 = 0. Then one fixed batch: steps timed to a
    device sync and two traced for device time and launches. Returns the
    runner run's launch counts."""
    import random

    import numpy as np

    from genvc_tpu_torch import checkpoint as ckpt
    from genvc_tpu_torch.models import gpt as gpt_model, hifigan
    from genvc_tpu_torch.train import gpt_stage, runner, vocoder_stage

    steps = VOCODER_STEPS
    torch.cuda.reset_peak_memory_stats()
    with Launches(da, fa) as n:
        t0 = time.perf_counter()
        state = runner.run_vocoder_training(cfg, max_steps=steps, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    expect("vocoder K4", n.k4, 30 * steps)
    expect_none("vocoder", n, ("k1", "k3", "k5", "k6"))
    counts = n.counts()
    with open(os.path.join(cfg.output_path, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    step_ms = [1e3 / r["steps_per_sec"] for r in log]
    if len(log) != steps or not all(np.isfinite([r["loss_gen"] for r in log])):
        raise AssertionError(f"vocoder: {len(log)} logged steps: {log}")
    if not os.path.exists(os.path.join(cfg.output_path, "ckpt", f"{steps}.pt")):
        raise AssertionError("vocoder: no checkpoint at the last step")

    # one fixed batch: steps timed to a device sync, one traced
    frozen = gpt_stage.make_frozen(cfg, _stage_trees(paths),
                                   ckpt.load_mel_norms(cfg.model_args.mel_norm_file),
                                   torch.device("cuda"))
    with torch.device("meta"):
        gpt = gpt_model.GPT(ckpt.gpt_config(cfg))
    ckpt.assign(gpt, ckpt.load_gpt(cfg.model_args.gpt_checkpoint, 30), "cuda")
    train_ds, _ = runner.datasets(cfg)
    batch = runner.to_device(train_ds.collate(list(range(64)), random.Random(0)), "cuda")
    step, _ = vocoder_stage.make_train_step(cfg.vocoder_config)

    def one():
        nonlocal state
        state, m = step(state, batch, frozen, gpt.eval())
        return m["loss_gen"]

    fixed_ms = _timed_steps(one, 3)
    busy_ms, summed_ms, launches = device_busy_ms(one)
    latents, wav = vocoder_stage.prepare_vocoder_batch(frozen, gpt, batch)
    rec = {"batch": 64, "segment_s": wav.shape[-1] / 24000, "latents": list(latents.shape),
           "latent_pass_T": t_latent, "families": list(hifigan.ALL_FAMILIES),
           "dtype": "f32, TF32 off", "runner_steps": steps, "runner_wall_s": wall,
           "runner_step_ms": step_ms, "runner_step_ms_median_timed": statistics.median(
               step_ms[1:]), "runner_step_ms_min_max_timed": [min(step_ms[1:]), max(step_ms[1:])],
           "fixed_batch_step_ms": fixed_ms, "fixed_batch_step_ms_median":
           statistics.median(fixed_ms), "device_busy_ms_per_step": busy_ms,
           "kernel_ms_summed_per_step": summed_ms, "launches_per_step": launches,
           "k4_launches_per_step": n.k4 / steps,
           "max_memory_allocated": peak, "losses": [r["loss_gen"] for r in log],
           "launches": counts, "gpu": gpu}
    print("vocoder training " + json.dumps(rec), flush=True)
    return counts


def check_dvae_training(da, fa, tmp, gpu, paths, meta):
    """Phase 5c: both dVAE stages at their recipes through
    ``run_vae_training`` (stage 1: batch 256 of 6 s crops at 24 kHz, mel
    features; stage 2: batch 64 of 6 s crops at 16 kHz through the 12-layer
    ContentVec), 3 steps each and a checkpoint, then 1 warm-up and 3 steps
    on a fixed batch timed to a device sync, with peak memory. No attention
    kernel runs here. Returns the runs' launch counts."""
    import random

    from genvc_tpu_torch.data.dataset import WaveformDVAEDataset
    from genvc_tpu_torch.train import runner, vae_stage
    from genvc_tpu_torch.train_audio_dvae import recipe_config as audio_recipe
    from genvc_tpu_torch.train_content_dvae import recipe_config as content_recipe

    recs, total = {}, None
    for name, make in (("audio", lambda m: audio_recipe(
                            m, m, os.path.join(HERE, "pre_trained", "mel_stats.npy"),
                            output_path=os.path.join(tmp, "exp_advae"), num_workers=8)),
                       ("content", lambda m: content_recipe(
                            m, m, paths["contentvec"],
                            output_path=os.path.join(tmp, "exp_cdvae"), num_workers=8))):
        probe = make("")
        steps = 3
        cfg = make(_repeat_meta(meta, os.path.join(tmp, f"{name}.txt"),
                                probe.batch_size * steps))
        torch.cuda.reset_peak_memory_stats()
        with Launches(da, fa) as n:
            t0 = time.perf_counter()
            state = runner.run_vae_training(cfg, max_steps=steps, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        expect_none(f"dvae {name}", n, ("k1", "k3", "k4", "k5", "k6"))
        if not os.path.exists(os.path.join(cfg.output_path, "ckpt", f"{steps}.pt")):
            raise AssertionError(f"dvae {name}: no checkpoint at the last step")
        total = n.counts() if total is None else {k: total[k] + v for k, v in
                                                   n.counts().items()}
        ds = WaveformDVAEDataset(cfg.train_metafile, False, cfg.audio.dvae_sample_rate,
                                 cfg.max_wav_len)
        batch = runner.to_device(ds.collate(list(range(cfg.batch_size)), random.Random(0)),
                                 "cuda")
        if cfg.feat_type == "Mel-spectrogram":
            feat_params = torch.ones(80, device="cuda")
        else:
            from genvc_tpu_torch import checkpoint as ckpt
            from genvc_tpu_torch.models import contentvec

            with torch.device("meta"):
                feat_params = contentvec.ContentVec(n_layers=12)
            ckpt.assign(feat_params, ckpt.load_contentvec(paths["contentvec"]), "cuda")
            feat_params.eval()
        step, _ = vae_stage.make_train_step(vae_stage.make_feature_fn(cfg))

        def one():
            nonlocal state
            state, m = step(state, batch, feat_params)
            return m["loss"]

        torch.cuda.reset_peak_memory_stats()
        fixed_ms = _timed_steps(one, 3)
        recs[name] = {"batch": cfg.batch_size, "crop_s": batch["wav"].shape[-1]
                      / cfg.audio.dvae_sample_rate, "feat_type": cfg.feat_type,
                      "channels": cfg.num_channels, "tokens": cfg.num_tokens,
                      "runner_steps": steps, "runner_wall_s": wall,
                      "fixed_batch_step_ms": fixed_ms,
                      "step_ms_median": statistics.median(fixed_ms),
                      "max_memory_allocated": torch.cuda.max_memory_allocated(), "gpu": gpu}
        del state
        torch.cuda.empty_cache()
    print("dvae training " + json.dumps(recs), flush=True)
    return total


# ---- phase 6: parallelism, ranks sharing the one card over gloo

# 6a / 6b hold the multi-rank GPT step against the one-process step on the
# same card, weights and batch, after PAR_STEPS steps (lr 1e-4 halved from
# the second, Adam's eps 1e-3 as the CPU tests: with the recipe's 1e-8 an
# element whose gradient sits at the noise floor takes a normalized update
# of ~lr that differs between any two summation orders). f32: the
# row-parallel and data sums in other orders (~1e-6 relative); the
# parameters within 1 % of the lr. bf16 on f32 masters: every product and
# each rank's partial sum round at 2^-8 before the all-reduce, so the loss
# within 2e-2 and the gradient norm within 5e-2 relative, the parameters
# within a fifth of the lr.
PAR_STEPS = 2
PAR_TOL = {"f32": {"loss": 1e-5, "grad_norm": 1e-4, "params": 1e-6},
           "bf16": {"loss": 2e-2, "grad_norm": 5e-2, "params": 2e-5}}
PAR_LR = 1e-4
# the all-reduce's sizes timed in the transport probe: one activation of
# the 6a step (B x T x D = 8 x 184 x 1024) and 2^24 elements (64 MB in f32)
TRANSPORT_SIZES = (8 * 184 * 1024, 2 ** 24)


def _gpt_programs(tmp, frozen, cfg, batch, world, n_model, layers):
    """The GPT step's one-process references, run here (f32, then bf16;
    the whole flat vector saved after the steps), and the rank programs that
    repeat them on a ``(world / n_model, n_model)`` mesh."""
    import dataclasses

    from genvc_tpu_torch import checkpoint as ckpt
    from genvc_tpu_torch.parallel import rank_checks

    gcfg = dataclasses.replace(ckpt.gpt_config(cfg), layers=layers)
    base = {"cfg": cfg, "frozen": frozen,
            "mel_norms": ckpt.load_mel_norms(cfg.model_args.mel_norm_file),
            "gpt_cfg": gcfg, "seed": 0, "batch": batch, "steps": PAR_STEPS,
            "attn_impl": "flash", "lr": PAR_LR, "eps": 1e-3, "weight_decay": 1e-6}
    dtypes = ("f32", "bf16")
    paths = {dt: os.path.join(tmp, f"par_ref_{world}_{dt}.pt") for dt in dtypes}
    refs = rank_checks.gpt_train(0, "cuda:0", dict(base, n_model=1, dtypes=dtypes,
                                                   save_flat=paths))
    torch.cuda.empty_cache()
    return [("gpt_train", dict(base, n_model=n_model, dtypes=dtypes, reference=paths))], \
        dict(zip(dtypes, refs))


def _check_gpt(outs, refs, world, n_model, layers, gpu):
    """Holds the ranks' GPT steps (``outs[rank] = [[f32 result, bf16
    result]]``, one ``gpt_train`` program) to PAR_TOL: loss and gradient norm every step, every rank's
    parameters against its shard of the saved vector; the model group's
    ranks read one batch and keep their replicated parameters bit-equal;
    each rank launches K4, K5 and K6 once a block a step at its local heads.
    Prints the record before raising; returns the launch totals."""
    rec = {"world": world, "n_data": world // n_model, "n_model": n_model, "layers": layers,
           "backend": outs[0][0][0]["backend"], "gpu": gpu}
    totals = {"flash_attention": 0, "flash_attention_dq": 0, "flash_attention_dkdv": 0}
    failures = []
    for i, dtype in enumerate(("f32", "bf16")):
        tol, ref = PAR_TOL[dtype], refs[dtype]
        per = [o[0][i] for o in outs]
        for o in per:
            where = f"parallel {world} ranks {dtype} rank {o['rank']}"
            for m, want in zip(o["metrics"], ref["metrics"]):
                for key, rel in (("loss", tol["loss"]), ("grad_norm/total", tol["grad_norm"])):
                    if abs(m[key] - want[key]) > rel * abs(want[key]):
                        failures.append(f"{where}: {key} {m[key]} vs one process {want[key]}")
            if o["ref_err"] > tol["params"]:
                failures.append(f"{where}: parameters {o['ref_err']} from one process's")
            for n in o["launches"]:
                if n != {k: layers for k in totals}:
                    failures.append(f"{where}: launches {n} a step, expected {layers} each")
                for k in totals:
                    totals[k] += n[k]
        for group in range(world // n_model):
            members = per[group * n_model:(group + 1) * n_model]
            if len({o["batch_digest"] for o in members}) != 1 or \
                    len({o["replicated_digest"] for o in members}) != 1:
                failures.append(f"parallel {world} ranks {dtype}: model group {group} read "
                                "different batches or holds different replicas")
        rec[dtype] = {
            "tol": tol, "loss": [[m["loss"] for m in o["metrics"]] for o in per],
            "one_process_loss": [m["loss"] for m in ref["metrics"]],
            "grad_norm": [[m["grad_norm/total"] for m in o["metrics"]] for o in per],
            "one_process_grad_norm": [m["grad_norm/total"] for m in ref["metrics"]],
            "param_max_abs_err": [o["ref_err"] for o in per],
            "step_ms": [o["ms"] for o in per], "one_process_step_ms": ref["ms"],
            "launches_per_rank_step": per[0]["launches"][-1],
            "collectives_per_rank_step": per[0]["collectives"][-1]}
    print(f"parallel_gpt_{world} " + json.dumps(rec), flush=True)
    if failures:
        raise AssertionError("; ".join(failures))
    return totals


def _stage_programs(paths, meta, voc_cfg, gpt_path):
    """6c: stages 1, 2 and 4 at their recipes' widths with the batch cut
    (stage 1: 8 x 2 s mel crops into the 1024-token dVAE; stage 2: 4 x 2 s
    through the 12-layer ContentVec into the 256-token dVAE; stage 4: 4 x
    0.64 s through the four discriminator families against the frozen
    30 x 1024 GPT), one step each: this process's step on the whole batch,
    and the rank programs that split it over the data ranks."""
    import random

    import numpy as np

    from genvc_tpu_torch import checkpoint as ckpt
    from genvc_tpu_torch.data.dataset import WaveformDVAEDataset
    from genvc_tpu_torch.models import dvae, hifigan
    from genvc_tpu_torch.parallel import rank_checks
    from genvc_tpu_torch.train import runner, vocoder_stage
    from genvc_tpu_torch.train_audio_dvae import recipe_config as audio_recipe
    from genvc_tpu_torch.train_content_dvae import recipe_config as content_recipe

    def np_tree(node):
        if isinstance(node, dict):
            return {k: np_tree(v) for k, v in node.items()}
        if isinstance(node, list):
            return [np_tree(v) for v in node]
        return node.detach().cpu().numpy() if torch.is_tensor(node) else node

    programs = []
    norms = np.ones(80, np.float32)
    for cfg, rows in ((audio_recipe(meta, meta, os.path.join(HERE, "pre_trained",
                                                             "mel_stats.npy")), 8),
                      (content_recipe(meta, meta, paths["contentvec"]), 4)):
        cfg.max_wav_len = 2 * cfg.audio.dvae_sample_rate
        ds = WaveformDVAEDataset(meta, False, cfg.audio.dvae_sample_rate, cfg.max_wav_len)
        spec = {"vae_cfg": cfg, "mel_norms": norms, "steps": 1,
                "tree": np_tree(dvae.init_tree(torch.Generator().manual_seed(21),
                                               ckpt.dvae_config(cfg), trainable=True)),
                "batch": {"wav": ds.collate(list(range(rows)), random.Random(0))["wav"]}}
        if cfg.feat_type != "Mel-spectrogram":
            spec["contentvec"] = paths["contentvec"]
        programs.append(("dvae_train", spec))
    vcfg = voc_cfg.vocoder_config
    train_ds, _ = runner.datasets(voc_cfg)
    programs.append(("gan_train", {
        "cfg": voc_cfg, "mel_norms": norms,
        "frozen": {k: paths[k] for k in ("contentvec", "acoustic_dvae", "content_dvae")},
        "gpt_cfg": ckpt.gpt_config(voc_cfg), "gpt_tree": gpt_path,
        "vocoder_cfg": vcfg, "families": None, "steps": 1, "lr": 2e-4, "eps": 1e-8,
        "gen_tree": np_tree(hifigan.generator_to_weight_norm(
            hifigan.init_tree(torch.Generator().manual_seed(22), vcfg))),
        "disc_tree": ckpt.export_tree(vocoder_stage.init_discriminators(
            torch.Generator().manual_seed(23), vcfg)),
        "batch": train_ds.collate(list(range(4)), random.Random(0))}))
    refs = [getattr(rank_checks, fn)(0, "cuda:0", spec) for fn, spec in programs]
    torch.cuda.empty_cache()
    return programs, refs


def _check_stages(outs, refs, programs, gpu):
    """6c's holds: the dVAE codebooks against the one-process step at
    ``tests/test_multichip.py``'s bounds (cluster_size 1e-5 / 1e-6, embed
    1e-4 / 1e-5) and equal across the ranks; the GAN step's losses within
    1e-4 relative and the spectral-norm buffers bit-equal across the ranks.
    Prints the record before raising."""
    import numpy as np

    from genvc_tpu_torch.models import hifigan

    rec, failures = {"gpu": gpu}, []
    for i, name in enumerate(("audio_dvae", "content_dvae")):
        got, want = outs[0][i]["tree"]["codebook"], refs[i]["tree"]["codebook"]
        if outs[0][i]["codebook_digest"] != outs[1][i]["codebook_digest"]:
            failures.append(f"{name}: the ranks' codebooks differ")
        errs = {}
        for key, rtol, atol in (("cluster_size", 1e-5, 1e-6), ("embed", 1e-4, 1e-5)):
            err = np.abs(got[key] - want[key])
            errs[key] = float(err.max())
            if not (err <= atol + rtol * np.abs(want[key])).all():
                failures.append(f"{name}: codebook {key} max |err| {errs[key]}")
        rec[name] = {"rows": len(programs[i][1]["batch"]["wav"]), "codebook_max_abs_err": errs,
                     "loss": outs[0][i]["metrics"][0]["loss"],
                     "one_process_loss": refs[i]["metrics"][0]["loss"],
                     "step_ms": [o[i]["ms"] for o in outs], "one_process_ms": refs[i]["ms"]}
    got, want = outs[0][2], refs[2]
    if got["sn_digest"] != outs[1][2]["sn_digest"] or not got["n_sn"]:
        failures.append("gan: the ranks' spectral-norm buffers differ")
    for key, v in want["metrics"][0].items():
        if abs(got["metrics"][0][key] - v) > 1e-4 * abs(v):
            failures.append(f"gan: {key} {got['metrics'][0][key]} vs one process {v}")
    rec["gan"] = {"rows": 4, "families": list(hifigan.ALL_FAMILIES),
                  "metrics": got["metrics"][0], "one_process_metrics": want["metrics"][0],
                  "sn_buffers": got["n_sn"], "step_ms": [o[2]["ms"] for o in outs],
                  "one_process_ms": want["ms"]}
    print("parallel_stages " + json.dumps(rec), flush=True)
    if failures:
        raise AssertionError("; ".join(failures))


def check_parallel(tmp, gpu, paths, meta, voc_cfg):
    """Phase 6a-c in two launches of ranks on cuda:0 over gloo. Two ranks:
    the transport probe (the three collectives on CUDA tensors, the
    all-reduce timed), 6a (the GPT step tensor-parallel at 30 x 1024) and 6c
    (stages 1, 2 and 4 data-parallel); four ranks: 6b (the GPT step 2 x 2 at
    2 layers). The one-process references run here first. Returns the
    phase's launch counts by path."""
    import random

    from genvc_tpu_torch.parallel import launch, rank_checks
    from genvc_tpu_torch.train import runner
    from genvc_tpu_torch.train_genVC import recipe_config

    # phase 4's fixed batch: 8 rows of 50-token texts (T = 184)
    cfg = recipe_config(meta, meta, os.path.join(HERE, "pre_trained", "mel_stats.npy"),
                        paths["acoustic_dvae"], paths["content_dvae"], paths["contentvec"],
                        output_path=os.path.join(tmp, "exp_par"), batch_size=8, num_workers=4)
    cfg.model_args.min_text_length = cfg.model_args.max_text_length = 50
    train_ds, _ = runner.datasets(cfg)
    batch = train_ds.collate(list(range(8)), random.Random(0))
    frozen = {k: paths[k] for k in ("contentvec", "acoustic_dvae", "content_dvae")}
    none = {"decode_attention_layer": 0, "decode_attention_update_layer": 0, "int8_matmul": 0}

    t0 = time.perf_counter()
    tp_programs, tp_refs = _gpt_programs(tmp, frozen, cfg, batch, 2, 2, 30)
    stage_programs, stage_refs = _stage_programs(paths, meta, voc_cfg,
                                                 os.path.join(tmp, "gpt_flagship.pth"))
    refs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = launch.run_ranks(
        rank_checks.sequence, 2, backend="gloo", devices=["cuda:0"] * 2, timeout=600,
        args=([("transport", {"sizes": TRANSPORT_SIZES})] + tp_programs + stage_programs,))
    ranks_s = time.perf_counter() - t0
    print("parallel transport " + json.dumps({
        "ranks": [o[0] for o in outs], "gpu": gpu}), flush=True)
    out = {"parallel_tp": dict(none, **_check_gpt([o[1:2] for o in outs], tp_refs, 2, 2, 30,
                                                  gpu))}
    _check_stages([o[2:] for o in outs], stage_refs, stage_programs, gpu)

    t0 = time.perf_counter()
    dp_programs, dp_refs = _gpt_programs(tmp, frozen, cfg, batch, 4, 2, 2)
    dp_refs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = launch.run_ranks(rank_checks.sequence, 4, backend="gloo", devices=["cuda:0"] * 4,
                            timeout=600, args=(dp_programs,))
    dp_ranks_s = time.perf_counter() - t0
    out["parallel_dp_tp"] = dict(none, **_check_gpt(outs, dp_refs, 4, 2, 2, gpu))
    print("parallel wall " + json.dumps({
        "references_2_rank_launch_s": refs_s, "launch_2_ranks_s": ranks_s,
        "references_4_rank_launch_s": dp_refs_s, "launch_4_ranks_s": dp_ranks_s}), flush=True)
    return out


def check_sharded_serving(pipe, server_cls, srcs, refs, hold_srcs, da, fa, gpu, unsharded):
    """6d: ``StreamServer(slots=8, mesh=make_mesh(n_data=2, devices=[cuda:0,
    cuda:0]))`` at flagship width, bf16, greedy. The hold: the 8 streams of
    ``hold_srcs``, one admission wave per shard, against two unsharded
    4-slot servers given each shard's streams, audio within 2e-4 (the pool's rows set K3's split
    and the products' shapes, so the unsharded reference of a 4-row shard is
    a 4-slot pool). Then 16 streams drained once after
    ``warmup_admission``: K3 30 a decode step of each shard (4 rows), no
    other kernel; aggregate RTF and first-audio p50 / p95 beside phase 3's
    unsharded drain (``unsharded``)."""
    import numpy as np

    from genvc_tpu_torch.decode.engine import SamplerConfig
    from genvc_tpu_torch.parallel.mesh import make_mesh

    layers = pipe.gpt_cfg.layers
    sampler = pipe.sampler
    pipe.sampler = SamplerConfig(temperature=1.0, top_k=1, top_p=1.0,
                                 repetition_penalty=1.0, do_sample=False)
    mesh = make_mesh(n_data=2, devices=["cuda:0", "cuda:0"])
    try:
        sharded = server_cls(pipe, slots=8, mesh=mesh)
        if [len(sh.carry) for sh in sharded._shards] != [4, 4]:
            raise AssertionError("sharded server: not 2 shards of 4 rows")
        if not sharded._shards[0].pipe is sharded._shards[1].pipe is pipe:
            raise AssertionError("sharded server: the shards on the pipe's card copied "
                                 "its weights")
        sids = [sharded.submit(s, r) for s, r in zip(hold_srcs, refs)]
        sharded.drain()
        worst = 0.0
        for part in range(2):
            plain = server_cls(pipe, slots=4)
            psids = [plain.submit(s, r) for s, r in zip(hold_srcs[4 * part:4 * part + 4],
                                                          refs[4 * part:4 * part + 4])]
            plain.drain()
            for sid, psid in zip(sids[4 * part:4 * part + 4], psids):
                got, want = sharded.result(sid)[0], plain.result(psid)[0]
                if got.shape != want.shape:
                    raise AssertionError(f"sharded server: {got.shape} vs {want.shape}")
                worst = max(worst, float(np.abs(got - want).max()) if got.size else 0.0)
        if worst > 2e-4:
            raise AssertionError(f"sharded server: audio {worst} from the unsharded servers'")

        server = server_cls(pipe, slots=8, mesh=mesh)
        server.warmup_admission()
        total_s = sum(s.shape[-1] for s in srcs) / 16000
        with Launches(da, fa) as n:
            t0 = time.perf_counter()
            sids = [server.submit(s, r, arrival_t=t0) for s, r in zip(srcs, refs)]
            server.drain()
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
        m = server.metrics()
        results = [server.result(sid) for sid in sids]
        for wav, _ in results:
            check_audio("sharded serving", wav, pipe.sample_rate)
        if m["completed"] != len(srcs):
            raise AssertionError(f"sharded serving: {m['completed']} of {len(srcs)} completed")
        expect("sharded serving K3", n.k3, layers * m["decode_steps"])
        expect_none("sharded serving", n, ("k1", "k4", "k5", "k6"))
    finally:
        pipe.sampler = sampler
    lat_ms = np.asarray([stats["latency_s"] for _, stats in results]) * 1e3
    rec = {"slots": 8, "shards": 2, "rows_per_shard": 4, "devices": ["cuda:0", "cuda:0"],
           "hold_streams": 8, "hold_max_abs_err": worst, "hold_tol": 2e-4,
           "streams": len(srcs), "source_s": total_s, "wall_s": elapsed,
           "aggregate_rtf": elapsed / total_s,
           "first_audio_ms_p50": float(np.percentile(lat_ms, 50)),
           "first_audio_ms_p95": float(np.percentile(lat_ms, 95)),
           "decode_steps": m["decode_steps"], "k3_launches": n.k3,
           "k3_per_shard_step": n.k3 / m["decode_steps"],
           "unsharded_drain_rtf_median": unsharded, "gpu": gpu}
    print("sharded_serving " + json.dumps(rec), flush=True)
    return n.counts()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    from genvc_tpu_torch import _build
    from genvc_tpu_torch.decode import engine
    from genvc_tpu_torch.dsp.audio_io import load_audio
    from genvc_tpu_torch.inference import pipeline
    from genvc_tpu_torch.ops import decode_attention as da
    from genvc_tpu_torch.models import gpt as gpt_model
    from genvc_tpu_torch.ops import flash_attention as fa
    from genvc_tpu_torch.ops import mla, moe
    from genvc_tpu_torch.ops import nn as tnn
    from genvc_tpu_torch.ops import quant
    from genvc_tpu_torch.serving.server import StreamServer

    begin = time.perf_counter()
    marks = [begin]

    def mark(name):  # wall time of each phase, printed at its end
        marks.append(time.perf_counter())
        print(f"{name}: {marks[-1] - marks[-2]:.1f} s", flush=True)

    gpu = gpu_line()
    print(f"gpu: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32

    # ---- phase 1: build and check every kernel
    t0 = time.perf_counter()
    kernels = ["decode_attention", "flash_attention", "flash_attention_bwd", "layer_norm",
               "mla_decode", "moe_experts"]
    logs = _build.build_all(kernels)
    print(f"built {kernels} in {time.perf_counter() - t0:.1f} s", flush=True)
    ptxas = {name: ptxas_summary(log) for name, log in logs.items()}
    for name, funcs in ptxas.items():
        for func, info in funcs.items():
            print(f"  ptxas {name}: {func} {json.dumps(info)}")
    # dynamic shared memory per block at the training shapes (B=8, H=4, hd=256)
    bwd_build = {"functions": ptxas["flash_attention_bwd"], "dynamic_smem_bytes": {
        f"{part}_{dt}_T{t}": fa.bwd_smem_bytes(8, 4, t, 256, part == "dkdv", dt == "bf16")
        for part in ("dq", "dkdv") for dt in ("bf16", "f32") for t in (184, 328)}}
    print("flash_attention_bwd build " + json.dumps(bwd_build), flush=True)
    k1, k1_beam = check_decode_attention(da)
    reorder_rec = check_beam_reorder(da, engine, gpu)
    k3_recs = check_decode_attention_update(da)
    k3 = k3_recs[8, "bfloat16"]
    check_fp8_overflow(da)
    k4, k4_train, k4_tp = check_flash_attention(fa)
    k56, k56_328, k56_tp = check_flash_backward(fa)
    check_layer_norm(tnn, gpu)
    check_rms_norm(tnn, gpu)
    check_mla_decode(mla, gpu)
    check_moe_experts(moe, gpu)
    mark("phase 1")

    # ---- phase 2: a small f32 configuration, card vs CPU
    with tempfile.TemporaryDirectory() as tmp:
        check_native_audio(tmp)
    src = load_audio(os.path.join(HERE, "samples", "EF4_ENG_0112_1.wav"), 16000)
    ref = load_audio(os.path.join(HERE, "samples", "EM1_ENG_0037_1.wav"), 24000)
    src2 = load_audio(os.path.join(HERE, "samples", "EM1_ENG_0037_1.wav"), 16000)
    ref2 = load_audio(os.path.join(HERE, "samples", "EF4_ENG_0112_1.wav"), 24000)
    if any(x is None for x in (src, ref, src2, ref2)):
        raise RuntimeError("could not load the sample wavs")
    check_int8_linear(quant, gpu)
    check_f32_query_over_e4m3(da)
    check_small_against_cpu(pipeline, engine, StreamServer, da, fa, quant, src, ref, src2)
    with tempfile.TemporaryDirectory() as tmp:
        check_small_train_against_cpu(da, fa, tmp)
        cli_profile = check_cli_profile(pipeline, da, fa, tmp, gpu)
    mark("phase 2")

    # ---- phase 3: every path at flagship width, bf16
    cfg = pipeline.flagship_config()
    t0 = time.perf_counter()
    tree = pipeline.random_tree(cfg, seed=0, device="cuda")
    pipe = pipeline.build_pipeline(tree, cfg, device="cuda", dtype=torch.bfloat16)
    pipe.gen_cap_tokens_per_code = 1.875
    torch.cuda.synchronize()
    print(f"flagship pipeline built in {time.perf_counter() - t0:.1f} s", flush=True)
    layers = pipe.gpt_cfg.layers  # K1 and K4 each run once per GPT block
    by_path = {"cli_profile": cli_profile}

    # streaming, one utterance
    pipe.synthesize_streaming(src, ref, verbose=False)  # warm-up (cuDNN plans)
    lat, rtf = [], []
    for run in range(3):
        with Launches(da, fa) as n:
            wav, latency, r = pipe.synthesize_streaming(src, ref, verbose=False)
        steps = pipe.last_timing["decode_steps"]
        check_audio("streaming", wav, pipe.sample_rate)
        expect("streaming K1", n.k1, layers * steps)
        expect_none("streaming", n, ("k3", "k4", "k5", "k6"))
        # the LayerNorm kernel: 2 a block + ln_f + final_norm each decode
        # step, the rest in prefills and ContentVec
        if n.ln < (2 * layers + 2) * steps:
            raise AssertionError(f"streaming LayerNorm: {n.ln} launches over {steps} "
                                 "decode steps")
        print(f"streaming run {run}: LayerNorm launches {n.ln} "
              f"({(2 * layers + 2) * steps} in the decode steps)", flush=True)
        lat.append(latency * 1e3)
        rtf.append(r)
        print(f"streaming run {run}: {wav.size} samples, first-chunk latency "
              f"{latency * 1e3:.2f} ms, RTF {r:.4f}, decode steps {steps}, "
              f"K1 launches {n.k1}", flush=True)
    by_path["streaming"] = n.counts()
    bf16 = {"streaming_latency_ms_median": statistics.median(lat),
            "streaming_rtf_median": statistics.median(rtf)}
    print(json.dumps({"streaming": {"latency_ms_median": statistics.median(lat),
                                    "rtf_median": statistics.median(rtf),
                                    "runs": len(lat), "gpu": gpu}}), flush=True)

    # offline, one utterance of two segments (6 s + 1.68 s)
    tiled = np.tile(src, (1, 5))
    seconds = tiled.shape[-1] / 16000
    pipe.synthesize(tiled, ref)  # warm-up
    rtf = []
    for run in range(1):
        with Launches(da, fa) as n:
            t0 = time.perf_counter()
            wav = pipe.synthesize(tiled, ref)
            elapsed = time.perf_counter() - t0
        timing = pipe.last_timing
        check_audio("offline", wav, pipe.sample_rate)
        expect("offline K1", n.k1, layers * timing["decode_steps"])
        expect("offline K4", n.k4, layers * timing["latent_passes"])
        expect_none("offline", n, ("k3", "k5", "k6"))
        rtf.append(elapsed / seconds)
        print(f"offline run {run}: {seconds:.2f} s source, {wav.size} samples, "
              f"{elapsed * 1e3:.1f} ms, RTF {rtf[-1]:.4f}, decode steps "
              f"{timing['decode_steps']}, latent passes {timing['latent_passes']}, "
              f"K1 launches {n.k1}, K4 launches {n.k4}", flush=True)
    by_path["offline"] = n.counts()
    bf16["offline_rtf_median"] = statistics.median(rtf)
    print(json.dumps({"offline": {"rtf_median": statistics.median(rtf), "runs": len(rtf),
                                  "source_s": seconds, "gpu": gpu}}), flush=True)

    # batch, offline and streamed: 4 utterances of 7.68, 1.54, 4.12 and 8.24 s
    srcs = [tiled, src, src2, np.tile(src2, (1, 2))]
    refs = [ref, ref2, ref, ref2]
    total_s = sum(s.shape[-1] for s in srcs) / 16000
    for name, run_batch in (
            ("batch", lambda: pipe.synthesize_batch(srcs, refs)),
            ("streaming_batch",
             lambda: pipe.synthesize_streaming_batch(srcs, refs, verbose=False)[0])):
        run_batch()  # warm-up
        rtf = []
        for run in range(1):
            with Launches(da, fa) as n:
                t0 = time.perf_counter()
                wavs = run_batch()
                elapsed = time.perf_counter() - t0
            timing = pipe.last_timing
            for w in wavs:
                check_audio(name, w, pipe.sample_rate)
            expect(f"{name} K1", n.k1, layers * timing["decode_steps"])
            if name == "batch":
                expect(f"{name} K4", n.k4, layers * timing["latent_passes"])
            expect_none(name, n, ("k3", "k5", "k6") if name == "batch"
                        else ("k3", "k4", "k5", "k6"))
            rtf.append(elapsed / total_s)
            print(f"{name} run {run}: 4 utterances, {total_s:.2f} s of source, "
                  f"{elapsed * 1e3:.1f} ms, aggregate RTF {rtf[-1]:.4f}, decode steps "
                  f"{timing['decode_steps']}, K1 launches {n.k1}, K4 launches {n.k4}",
                  flush=True)
        by_path[name] = n.counts()
        print(json.dumps({name: {"aggregate_rtf_median": statistics.median(rtf),
                                 "runs": len(rtf), "utterances": len(srcs),
                                 "source_s": total_s, "gpu": gpu}}), flush=True)
    by_path.update(check_search_modes(pipe, engine, src, ref, da, fa, gpu, reorder_rec))
    # serving: 16 streams (the batch's 4 sources x 4) into 8 slots at once
    by_path["serving"], bf16["drain_rtf_median"] = check_serving(
        pipe, StreamServer, srcs * 4, [ref, ref2] * 8, da, fa, gpu, runs=1)
    mark("phase 3")
    # phase 6d (run here, on this pipeline): the pool sharded over 2 shards
    by_path["sharded_serving"] = check_sharded_serving(
        pipe, StreamServer, srcs * 4, [ref, ref2] * 8, [src, src2] * 4, da, fa, gpu,
        bf16["drain_rtf_median"])
    mark("phase 6d")

    # ---- phase 3b: the quantized serving configuration at flagship width
    by_path.update(check_quantized(pipeline, engine, gpt_model, StreamServer, da, fa, gpu,
                                   tree, cfg, pipe, bf16, src, ref, tiled, srcs * 4,
                                   [ref, ref2] * 8))
    del pipe, tree
    torch.cuda.empty_cache()
    mark("phase 3b")

    # ---- phase 4: GPT training at flagship width
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths, meta = write_training_assets(tmp)
        print(f"training assets written in {time.perf_counter() - t0:.1f} s", flush=True)
        by_path["training"], remat_launches, content_launches = check_training(
            da, fa, tmp, gpu, paths, meta)
        by_path.update(remat_launches)
        by_path.update(content_launches)
        mark("phase 4")

        # ---- phase 5: the other training stages
        check_small_stages_against_cpu(da, fa, tmp)
        voc_cfg, (b_voc, t_voc) = vocoder_recipe(tmp, paths, meta, VOCODER_STEPS)
        k4_voc = check_flash_vocoder_shape(fa, b_voc, t_voc)
        by_path["vocoder"] = check_vocoder_training(da, fa, voc_cfg, paths, gpu, t_voc)
        by_path["dvae"] = check_dvae_training(da, fa, tmp, gpu, paths, meta)
        mark("phase 5")

        # ---- phase 6: parallelism, ranks sharing the card over gloo (6d ran
        # in phase 3, on its pipeline)
        by_path.update(check_parallel(tmp, gpu, paths, meta, voc_cfg))
        mark("phase 6a-c")
    print(f"chip_smoke: {time.perf_counter() - begin:.1f} s", flush=True)

    def launches(kernel):
        return {path: counts[kernel] for path, counts in by_path.items()}

    print(json.dumps({"kernels": [{
        "name": "decode_attention_layer", "route": "cuda",
        "design": "cache length split over blocks, two passes",
        "source": "genvc_tpu_torch/csrc/decode_attention.cu",
        "replaces": "genvc_tpu/ops/decode_attention.py:160",
        "launches": sum(launches("decode_attention_layer").values()),
        "launches_by_path": launches("decode_attention_layer"),
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"], "bound_by": "bytes",
        "library_ms": k1["library_ms"], "ratio": k1["ratio"],
        "cuda_launches_per_call": k1["cuda_launches_per_call"],
        "beam_shape": {key: k1_beam[key] for key in (
            "B", "T", "ms", "device_ms", "library_ms", "library_device_ms", "device_ratio",
            "bound_ms", "max_abs_err")},
        "on_reordered_cache_max_abs_err": reorder_rec["k1_on_reordered_max_abs_err"],
        "beam_reorder": {key: reorder_rec[key] for key in (
            "B", "T", "device_ms", "bound_ms", "launches_per_call")}}, {
        "name": "decode_attention_update_layer", "route": "cuda",
        "design": "K1's split over the cache length, two passes, the row write "
                  "folded into the logits pass by the block whose key range holds it",
        "source": "genvc_tpu_torch/csrc/decode_attention.cu",
        "replaces": "genvc_tpu/ops/decode_attention.py:281",
        "launches": sum(launches("decode_attention_update_layer").values()),
        "launches_by_path": launches("decode_attention_update_layer"),
        "max_abs_err": max(r["max_abs_err"] for r in k3_recs.values()), "ms": k3["ms"],
        "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"], "bound_by": "bytes",
        "library_ms": k3["library_ms"], "device_ms": k3["device_ms"],
        "library_device_ms": k3["library_device_ms"],
        "keys_per_split": k3["keys_per_split"],
        "cuda_launches_per_call": k3["cuda_launches_per_call"],
        "by_shape": {f"B{b}_{c}": {key: r[key] for key in (
            "device_ms", "bound_ms", "library_device_ms", "device_ratio")}
            for (b, c), r in k3_recs.items()}}, {
        "name": "flash_attention", "route": "cuda",
        "design": "bf16 mma.sync tiles, cp.async double buffer",
        "source": "genvc_tpu_torch/csrc/flash_attention.cu",
        "replaces": "genvc_tpu/ops/flash_attention.py:134",
        "launches": sum(launches("flash_attention").values()),
        "launches_by_path": launches("flash_attention"),
        "max_abs_err": k4["max_abs_err"], "ms": k4["ms"],
        "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"], "library_ms": k4["library_ms"], "ratio": k4["ratio"],
        "training_shape": {key: k4_train[key] for key in (
            "B", "T", "ms", "library_ms", "library_causal_ms", "ratio", "ratio_causal",
            "bound_ms")},
        "tp_shape": {key: k4_tp[key] for key in (
            "B", "H", "T", "ms", "plain_ms", "library_ms", "library_causal_ms", "device_ms",
            "library_device_ms", "library_causal_device_ms", "bound_ms", "bound_by",
            "max_abs_err")},
        "vocoder_shape": k4_voc}] + [{
        # K5 / K6: plain_ms and library_ms (SDPA's backward) are of the whole
        # backward, dq, dk and dv together; ms and bound_ms of the kernel alone
        "name": name, "route": "cuda", "design": design,
        "source": "genvc_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": replaces,
        "launches": sum(launches(name).values()), "launches_by_path": launches(name),
        "max_abs_err": max(k56["max_abs_err"][g] for g in grads),
        "ms": k56[f"{part}_ms"], "plain_ms": k56["plain_ms"],
        "bound_ms": k56["bound_ms"][part], "bound_by": k56["bound_by"][part],
        "library_ms": k56["library_ms"], "device_ms": k56[f"{part}_device_ms"],
        "library_device_ms": k56["library_device_ms"],
        "pair_device_ratio": k56["device_ratio"],
        "T328": {key: k56_328[key] for key in (
            f"{part}_ms", f"{part}_device_ms", "library_ms", "library_device_ms",
            "device_ratio")} | {"bound_ms": k56_328["bound_ms"][part]},
        "tp_shape": {key: k56_tp[key] for key in (
            "B", "H", "T", f"{part}_ms", f"{part}_device_ms", "plain_ms", "library_ms",
            "library_device_ms", "device_ratio")} | {
            "bound_ms": k56_tp["bound_ms"][part], "bound_by": k56_tp["bound_by"][part],
            "max_abs_err": max(k56_tp["max_abs_err"][g] for g in grads)},
        "ptxas": {f: info for f, info in bwd_build["functions"].items() if tag in f},
        "dynamic_smem_bytes": {t: bwd_build["dynamic_smem_bytes"][f"{part}_bf16_T{t}"]
                               for t in (184, 328)}}
        for name, replaces, part, grads, tag, design in (
            ("flash_attention_dq", "genvc_tpu/ops/flash_attention.py:187", "dq", ("dq",),
             "dq_mma", "bf16 mma.sync: 8 warps per 32-row query tile (longest walks "
             "first), S and dP for a 16-row group x 16-key slice of every 64-key K/V "
             "tile (cp.async double buffer), dS through shared memory as bf16, each "
             "warp then 64 columns of its group's dQ over all keys; f32 SIMT"),
            ("flash_attention_dkdv", "genvc_tpu/ops/flash_attention.py:197", "dkdv",
             ("dk", "dv"), "dkdv_mma", "bf16 mma.sync, transposed: 8 warps per 64-key "
             "tile (32 when 64-key tiles leave SMs idle) walking 64-row Q/dO tiles "
             "(cp.async double buffer); S^T, dP^T split over warps by queries, P^T and "
             "dS^T through shared memory, dK and dV split by columns; f32 SIMT"))]}),
          flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
