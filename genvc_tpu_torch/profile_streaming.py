"""Where the time of one flagship streaming run goes on the card.

    python -m genvc_tpu_torch.profile_streaming [--runs 3] [--serving]
    python -m genvc_tpu_torch.profile_streaming --training [--attn_impl xla]

Builds the flagship bf16 pipeline with seeded random weights (as
``chip_smoke.py`` does), warms it up, then traces ``--runs`` calls of
``synthesize_streaming`` on the repo's sample wavs with ``torch.profiler``
(CPU + CUDA), each after one untraced run. Prints, per run: the untraced and
traced wall times, the device's busy time (union of kernel intervals) and its
idle share against either wall time (the tracer's own host cost inflates the
traced one), the wall time of each pipeline span
(``genvc.cond_latents`` / ``genvc.prefill`` / ``genvc.decode`` /
``genvc.vocode``), kernels launched per decode step, and the kernels that
take the most device time. The last line is one JSON summary.

``--serving`` traces a ``StreamServer`` drain instead: 8 streams of the
1.54 s sample (references alternating) submitted at once to an 8-slot pool,
after a warm-up drain; its spans are ``genvc.admit`` (wave prefill and
insertion), ``genvc.tick`` (enqueueing a pool tick) and ``genvc.fetch``
(waiting for the oldest tick's results).

``--training`` traces GPT training steps instead (stage 3 at flagship width,
bf16 on f32 masters, seeded random weights, B = 8 rows of 50-token texts cut
from the tiled samples, 6 s of conditioning each, ``attn_impl`` "flash" or
"xla"), one step per run; its spans are ``genvc.features`` (the frozen
tokenizers), ``genvc.forward``, ``genvc.backward`` and ``genvc.optimizer``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import time

import torch

from genvc_tpu_torch import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _busy_us(intervals) -> float:
    busy, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def analyse(prof, steps: int) -> dict:
    """Device busy time, launches (in all and per step: decode steps, or one
    training step), span wall times and the top kernels of a trace."""
    kernels, spans = [], collections.defaultdict(float)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        tr = ev.time_range
        if ev.name.startswith("genvc."):
            # the spans also appear on the device timeline as annotations
            if ev.device_type == torch.autograd.DeviceType.CPU:
                spans[ev.name] += tr.end - tr.start
        elif ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((tr.start, tr.end))
            by_name[ev.name][0] += tr.end - tr.start
            by_name[ev.name][1] += 1
    if not kernels:
        raise RuntimeError("the trace holds no device activity")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "device_busy_ms": _busy_us(kernels) / 1e3,
        "kernel_launches": len(kernels),
        "launches_per_step": len(kernels) / max(steps, 1),
        "span_ms": {k: v / 1e3 for k, v in sorted(spans.items())},
        "top_kernels": [{"name": n[:90], "ms": t / 1e3, "count": c}
                        for n, (t, c) in top],
    }


def serving_call(pipe, src, ref, ref2):
    """One drain of 8 streams into an 8-slot server; returns (first-audio
    latency median s, aggregate RTF, decode steps)."""
    from genvc_tpu_torch.serving.server import StreamServer

    server = StreamServer(pipe, slots=8)
    t0 = time.perf_counter()
    sids = [server.submit(src, r, arrival_t=t0) for r in [ref, ref2] * 4]
    server.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lat = statistics.median(server.result(sid)[1]["latency_s"] for sid in sids)
    return lat, wall / (8 * src.shape[-1] / 16000), server.metrics()["decode_steps"]


def training_setup(dev, attn_impl):
    """A flagship GPT training step and its inputs; returns a call that runs
    one step and returns (step s, 0.0, 1)."""
    import numpy as np

    from genvc_tpu_torch import checkpoint as ckpt
    from genvc_tpu_torch.dsp.audio_io import load_audio
    from genvc_tpu_torch.models import contentvec, dvae, gpt as gpt_model
    from genvc_tpu_torch.train import gpt_stage, optim
    from genvc_tpu_torch.train_genVC import recipe_config

    cfg = recipe_config("", "", os.path.join(REPO, "pre_trained", "mel_stats.npy"), "", "", "")
    gen = torch.Generator(device=dev).manual_seed(0)
    trees = {"contentvec": contentvec.init_tree(gen, 12)}
    for name, vc in (("acoustic_dvae", cfg.acoustic_dvae_config),
                     ("content_dvae", cfg.content_dvae_config)):
        trees[name] = dvae.init_tree(gen, dvae.DVAEConfig(
            channels=vc.num_channels, num_tokens=vc.num_tokens, codebook_dim=vc.codebook_dim,
            hidden_dim=vc.hidden_dim, num_resnet_blocks=vc.num_resnet_blocks,
            kernel_size=vc.kernel_size, num_layers=vc.num_layers))
    frozen = gpt_stage.make_frozen(cfg, trees, np.load(cfg.model_args.mel_norm_file), dev)
    gcfg = ckpt.gpt_config(cfg)
    with torch.device("meta"):
        model = gpt_model.GPT(gcfg)
    ckpt.assign(model, gpt_model.init_tree(gen, gcfg), dev)
    flat = optim.FlatParams(model)
    tx = optim.adamw_grouped(1e-4, params=flat).init(flat.flat)
    state = gpt_stage.GPTTrainState(model, flat, tx)
    step, _ = gpt_stage.make_train_step(compute_dtype=torch.bfloat16, attn_impl=attn_impl)
    srcs = [load_audio(os.path.join(REPO, "samples", f), 24000)[0]
            for f in ("EF4_ENG_0112_1.wav", "EM1_ENG_0037_1.wav")]
    long = [np.tile(s, -(-150000 // s.size)) for s in srcs]
    b, t_wav, t_cond = 8, 50 * 1920, 144000
    batch = {"wav": np.stack([np.roll(long[i % 2], 4801 * i)[None, :t_wav] for i in range(b)]),
             "conditioning": np.stack([np.roll(long[i % 2], 977 * i)[None, None, :t_cond]
                                       for i in range(b)]),
             "wav_lengths": np.full(b, t_wav), "cond_lens": np.full(b, t_cond),
             "text_lengths": np.full(b, 50)}
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}

    def call():
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, frozen)
        float(m["loss"])
        return time.perf_counter() - t0, 0.0, 1
    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--serving", action="store_true",
                    help="trace an 8-stream StreamServer drain instead")
    ap.add_argument("--training", action="store_true",
                    help="trace flagship GPT training steps instead")
    ap.add_argument("--attn_impl", default="flash", choices=["flash", "xla"],
                    help="the training step's attention (with --training)")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")

    from genvc_tpu_torch.dsp.audio_io import load_audio
    from genvc_tpu_torch.inference import pipeline

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    if args.training:
        call = training_setup(dev, args.attn_impl)
    else:
        cfg = pipeline.flagship_config()
        pipe = pipeline.build_pipeline(pipeline.random_tree(cfg, seed=0, device=dev), cfg,
                                       device=dev, dtype=torch.bfloat16)
        pipe.gen_cap_tokens_per_code = 1.875
        src = load_audio(os.path.join(REPO, "samples", "EF4_ENG_0112_1.wav"), 16000)
        ref = load_audio(os.path.join(REPO, "samples", "EM1_ENG_0037_1.wav"), 24000)
        ref2 = load_audio(os.path.join(REPO, "samples", "EF4_ENG_0112_1.wav"), 24000)

        def call():
            """(latency s, RTF, decode steps) of one traced unit of work."""
            if args.serving:
                return serving_call(pipe, src, ref, ref2)
            _, latency, rtf = pipe.synthesize_streaming(src, ref, verbose=False)
            return latency, rtf, pipe.last_timing["decode_steps"]

    call()  # warm-up
    if args.training:
        call()  # a second: the first step at a shape pays allocator and cuBLAS setup

    results = []
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for run in range(args.runs):
        # an untraced run first: the tracer's own cost inflates the wall time
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        untraced_ms = (time.perf_counter() - t0) * 1e3
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            latency, rtf, steps = call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        res = analyse(prof, steps)
        res.update(traced_wall_ms=wall_ms, untraced_wall_ms=untraced_ms,
                   traced_latency_ms=latency * 1e3, traced_rtf=rtf, decode_steps=steps,
                   idle_share_traced=1.0 - res["device_busy_ms"] / wall_ms,
                   idle_share_untraced=1.0 - res["device_busy_ms"] / untraced_ms)
        results.append(res)
        print(f"run {run}: " + json.dumps(res), flush=True)

    path = ("serving, 8 streams x 1.54 s, 8 slots" if args.serving
            else f"training, B=8 x 50 tokens, bf16, attn {args.attn_impl}" if args.training
            else "streaming, 1.54 s")
    summary = {"gpu": gpu, "runs": len(results), "path": path,
               "untraced_wall_ms_median": statistics.median(r["untraced_wall_ms"] for r in results),
               "traced_wall_ms_median": statistics.median(r["traced_wall_ms"] for r in results),
               "device_busy_ms_median": statistics.median(r["device_busy_ms"] for r in results),
               "idle_share_traced_median": statistics.median(r["idle_share_traced"] for r in results),
               "idle_share_untraced_median": statistics.median(
                   r["idle_share_untraced"] for r in results),
               "launches_per_step": results[-1]["launches_per_step"],
               "span_ms_last": results[-1]["span_ms"]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
