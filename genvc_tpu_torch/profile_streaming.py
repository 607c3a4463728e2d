"""Where the time of one flagship streaming run goes on the card.

    python -m genvc_tpu_torch.profile_streaming [--runs 3] [--serving]

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
        "launches_per_decode_step": len(kernels) / max(steps, 1),
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--serving", action="store_true",
                    help="trace an 8-stream StreamServer drain instead")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")

    from genvc_tpu_torch.dsp.audio_io import load_audio
    from genvc_tpu_torch.inference import pipeline

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
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

    summary = {"gpu": gpu, "runs": len(results),
               "path": "serving, 8 streams x 1.54 s, 8 slots" if args.serving
               else "streaming, 1.54 s",
               "untraced_wall_ms_median": statistics.median(r["untraced_wall_ms"] for r in results),
               "traced_wall_ms_median": statistics.median(r["traced_wall_ms"] for r in results),
               "device_busy_ms_median": statistics.median(r["device_busy_ms"] for r in results),
               "idle_share_traced_median": statistics.median(r["idle_share_traced"] for r in results),
               "idle_share_untraced_median": statistics.median(
                   r["idle_share_untraced"] for r in results),
               "launches_per_decode_step": results[-1]["launches_per_decode_step"],
               "span_ms_last": results[-1]["span_ms"]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
