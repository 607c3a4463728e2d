"""One caller streaming conversions back to back:
``GenVCPipeline.synthesize_streaming`` in a closed loop.

Set-up draws the weights on the card, builds the pipeline and converts one
ready request (every shape the calls use: the prefill, the decode step, the
4- and 8-latent windows and the tail). The window then runs the mix's
requests, cycling with a new order each pass, and starts no call after
``--seconds``. ``ttfa_ms_p50`` is the median first-chunk latency of the
calls, from each call's start to its first crossfaded chunk on the host, both
read on the harness's clock; ``audio_s_per_s`` the source seconds
of the calls over the time from the window's start to the end of the last.
With ``--trace 1`` the first ``trace_calls`` calls are traced, and traced
again on the next calls, at most ``trace_tries`` times, while the trace lost
device records.
"""

from __future__ import annotations

import gc
import statistics

import torch

from perfbench import program, trace, traffic, weights
from perfbench.drivers import common
from perfbench.reference import check


def run(cell: dict, args, process_start: float) -> dict:
    from genvc_tpu_torch.ops import decode_attention as da

    cfg, mix = cell["config"], cell["traffic"]
    seed = args.seed
    pipe = program.build(cfg, common.draw_tree(cfg, seed), weights.torch_seed(seed), common.DEVICE)
    rec = program.StreamRecorder(pipe)
    warm = traffic.Request(cell["warm_src_seconds"], cell["warm_ref_seconds"], 0, 0.1, 1, 0.2)
    for _ in range(cell["warm_calls"]):
        src, ref = common.inputs(warm)
        pipe.synthesize_streaming(src, ref, verbose=False)
    rec.take()
    passes = [traffic.requests(mix, seed, stream=p) for p in range(cell["passes"])]
    queue = [common.inputs(r) + (r,) for reqs in passes for r in reqs]
    torch.cuda.synchronize()

    calls, traces, tries = [], [], 0
    t0 = common.now()
    setup_s = t0 - process_start
    i = 0
    while common.now() - t0 < args.seconds:
        if i >= len(queue):
            raise RuntimeError("the mix ran out of requests: raise the cell's passes")
        tracing = (args.trace and tries < cell["trace_tries"]
                   and (not traces or not traces[-1][1]))
        group = queue[i: i + cell["trace_calls"]] if tracing else queue[i: i + 1]
        k1 = da.decode_attention_layer.launches
        done = []
        if tracing:
            region: list = []
            with trace.traced(region):
                for src, ref, req in group:
                    done.append(_call(pipe, rec, src, ref, req))
            n_k1 = da.decode_attention_layer.launches - k1
            tr = region[0]
            whole = tr.whole() and tr.count("decode_split_logits") == n_k1
            traces.append((tr, whole, done))
            tries += 1
            if not whole:
                common.note(f"trace {tries}: {tr.count('decode_split_logits')} K1 records "
                            f"for {n_k1} launches, {len(tr.kernels)} device records for "
                            f"{tr.launches} launches: taken again")
        else:
            done.append(_call(pipe, rec, *group[0]))
        calls += done
        i += len(group)
    t_end = calls[-1]["end"]
    if args.trace and not (traces and traces[-1][1]):
        raise RuntimeError(f"no whole trace in {tries} tries")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    rec.close()
    del pipe, rec, queue
    gc.collect()
    torch.cuda.empty_cache()

    picked = common.sample(calls, cell["check_requests"], seed)
    for c in picked:
        c["served"] = program.host_segments(c["served"])
    judged = common.judge(cfg, seed, picked, control=getattr(args, "control", False))
    numbers = judged["program"]
    end_to_end = {
        "setup_s": setup_s,
        "ttfa_ms_p50": statistics.median(c["latency_s"] for c in calls) * 1e3,
        "audio_s_per_s": sum(c["src_s"] for c in calls) / (t_end - t0),
    }
    common.note(f"window: {len(calls)} calls, {t_end - t0:.3f} s, setup {setup_s:.3f} s")
    record = None
    if args.trace:
        tr, _, traced_calls = traces[-1]
        record = {"cell": "stream", "cfg": cfg, "trace": tr, "calls": traced_calls}
    return {"correct": check.verdict(numbers), "attempted": len(calls), "failed": 0,
            "end_to_end": end_to_end, "memory_peak_bytes": peak, "numbers": numbers,
            "limits": dict(check.LIMITS), "record": record,
            "control": judged.get("control")}


def _call(pipe, rec, src, ref, req) -> dict:
    rec.first_chunk_t = None
    start = common.now()
    wav, _, _ = pipe.synthesize_streaming(src, ref, verbose=False)
    end = common.now()
    if rec.first_chunk_t is None:
        raise RuntimeError("a call emitted no chunk of audio")
    served = rec.take()
    return {"start": start, "end": end, "latency_s": rec.first_chunk_t - start,
            "src_s": src.shape[-1] / 16000,
            "src": src, "ref": ref, "served": served, "audio": wav,
            "decode_steps": pipe.last_timing.get("decode_steps", 0), "ref_samples": ref.shape[-1]}
