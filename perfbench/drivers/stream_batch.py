"""Eight callers streamed in lockstep: ``GenVCPipeline.synthesize_streaming_batch``
over groups of the mix's requests, back to back in a closed loop, on the
DeepSeek-V3 backbone (``configs/genvc-moonlight-bf16.json``).

Set-up draws the weights on the card (the GPT family in bf16,
:mod:`perfbench.weights_moonlight`), builds the pipeline, builds the
kernels and converts one group of ready requests (every shape the window
uses: the prefill at the group's width, the decode step and its CUDA graph,
the 4- and 8-latent windows and the tail; with ``--trace 1`` once more with
the recorder on, whose step is a graph of its own). The window then runs
the mix's passes (a new order each pass, cut into groups of ``batch``
requests) whole, and starts no pass after ``--seconds``: a group runs as
long as its longest row, so a window cut between groups would measure
whichever groups fit.
``ttfa_ms_p50`` is the median over rows of the
time from the group's start to the row's first crossfaded chunk, stamped by
the harness's own wrapper of the chunk hand-off (a row's first chunk is the
hand-off with no overlap yet); ``audio_s_per_s`` the source seconds of the
groups over the time from the window's start to the end of the last. With
``--trace 1`` the first group is traced with the profiler and the
program's recorder on, and traced again on the next group, at most
``trace_tries`` times, while the trace lost device records; the window ends
with the first whole trace (the groups after a profiled one run several
times slower, and a traced run reports only per-layer readings).

``correct``: ``check_rows`` rows drawn from the seed (the longest always
among them) are judged by :mod:`perfbench.reference.check_moonlight` after
the window, from a fresh draw of the weights.
"""

from __future__ import annotations

import gc
import statistics

import numpy as np
import torch

from perfbench import codebooks, program, trace, traffic, weights, weights_moonlight
from perfbench.drivers import common
from perfbench.reference import check_moonlight as check

KERNELS = ("layer_norm", "mla_decode", "moe_experts")


def _program():
    """The program's modules the cell needs; a clear error where the
    program has no DeepSeek-V3 backbone."""
    try:
        from genvc_tpu_torch.models import mla_moe  # noqa: F401
        from genvc_tpu_torch.ops import mla, moe  # noqa: F401
    except ImportError as e:
        raise RuntimeError("this program has no DeepSeek-V3 backbone "
                           f"(genvc_tpu_torch.models.mla_moe): {e}") from None
    from genvc_tpu_torch import _build, config, tracing
    from genvc_tpu_torch.decode import engine
    from genvc_tpu_torch.inference import pipeline

    return {"mla_moe": mla_moe, "mla": mla, "moe": moe, "build": _build, "tracing": tracing,
            "engine": engine, "pipeline": pipeline, "config": config}


def draw_tree(cfg: dict, seed: int) -> dict:
    """The inference weights of ``seed``, codebooks placed, no stop token."""
    tree = codebooks.fill(weights_moonlight.draw(cfg, seed, common.DEVICE), cfg, seed,
                          common.ROOT)
    tree["gpt"]["mel_head"]["b"][cfg["gpt"]["stop_audio_token"]] = common.NO_STOP_BIAS
    return tree


def build(cfg: dict, tree: dict, seed: int, mods: dict):
    """The program's pipeline: the front end configured as ``genvc-bf16``'s
    (``program.genvc_config``), the backbone from its config.json numbers."""
    g = cfg["gpt"]
    if g["dtype"] != "bfloat16" or g["kv_cache_dtype"] != "bfloat16":
        raise ValueError("the cell serves the backbone and its cache in bf16")
    backbone = mods["config"].MLAMoEConfig(**weights_moonlight.gpt_group(cfg)["backbone"])
    pipe = mods["pipeline"].build_pipeline(tree, program.genvc_config(cfg),
                                           device=common.DEVICE, dtype=torch.bfloat16,
                                           seed=seed, backbone=backbone)
    pipe.gen_cap_tokens_per_code = cfg["stream"]["gen_cap_tokens_per_code"]
    pipe.first_chunk_tokens = cfg["stream"]["first_chunk_tokens"]
    return pipe


class BatchRecorder:
    """Records, per lockstep round of a group, the rows' content codes and
    their pre-quantization values, the prefill tokens, every decode window's
    tokens and the experts each mixture layer chose (as device tensors: a
    step replayed from its CUDA graph gives a copy of the route buffers its
    capture made); and the host time of each row's first crossfaded chunk.
    Calls the program's own functions unchanged."""

    def __init__(self, pipe, mods: dict):
        import time

        self.rounds: list[dict] = []
        self.first_chunks: list[float] = []
        self._mods = mods
        engine, pipeline, mla_moe = mods["engine"], mods["pipeline"], mods["mla_moe"]
        self._decode_chunk = program.hook(engine, "decode_chunk")
        self._handle_chunk = program.hook(pipeline, "_handle_chunk")
        self._route = program.hook(mla_moe, "route")
        self._replay = program.hook(engine._LatentGraphs, "replay")
        self._captured: list = []   # the route buffers of the graph being captured
        self._graph_routes: dict = {}
        start = program.hook(pipe, "_start_segment")
        latents: list = []
        program.record_latents(pipe.content_dvae, latents)

        def start_segment(*args, **kwargs):
            latents.clear()
            self.rounds.append({"routes": []})
            out = start(*args, **kwargs)
            _, tok0, _, codes, n_codes = out
            self.rounds[-1].update(codes=codes, z=latents[-1], n=list(n_codes), parts=[tok0])
            return out

        def decode_chunk(*args, **kwargs):
            out = self._decode_chunk(*args, **kwargs)
            self.rounds[-1]["parts"].append(out[0])
            return out

        def handle_chunk(wav_gen, wav_overlap, overlap_len):
            out = self._handle_chunk(wav_gen, wav_overlap, overlap_len)
            if wav_overlap is None:
                self.first_chunks.append(time.perf_counter())
            return out

        def route(*args, **kwargs):
            idx, w = self._route(*args, **kwargs)
            if idx.is_cuda and torch.cuda.is_current_stream_capturing():
                self._captured.append(idx)  # a graph's own buffer, read after each replay
            elif self.rounds:
                self.rounds[-1]["routes"].append(idx)
            return idx, w

        def replay(graphs, on):
            out = self._replay(graphs, on)
            key = (id(graphs), on)
            if self._captured:  # the replay that follows a capture
                self._graph_routes[key] = (graphs, self._captured)
                self._captured = []
            if self.rounds:
                self.rounds[-1]["routes"].extend(
                    torch.stack(self._graph_routes[key][1]).unbind(0))
            return out

        pipe._start_segment = start_segment
        engine.decode_chunk = decode_chunk
        pipeline._handle_chunk = handle_chunk
        mla_moe.route = route
        engine._LatentGraphs.replay = replay

    def close(self):
        self._mods["engine"].decode_chunk = self._decode_chunk
        self._mods["pipeline"]._handle_chunk = self._handle_chunk
        self._mods["mla_moe"].route = self._route
        self._mods["engine"]._LatentGraphs.replay = self._replay

    def take(self):
        out = (self.rounds, self.first_chunks)
        self.rounds, self.first_chunks = [], []
        return out


def row_segments(rounds: list[dict], row: int, moe_layers: int, latents: int) -> list[dict]:
    """Row ``row``'s segments as host arrays: codes, pre-quantization values,
    n, every token served and, per mixture layer, the experts chosen at each
    position of the row's own sequence ((positions, k): the prefill's valid
    columns, its ``latents`` speaker latents, start, codes and stop, then the
    start token's column, then each decode step)."""
    out = []
    for r in rounds:
        if row >= len(r["n"]) or not r.get("active", [True] * len(r["n"]))[row]:
            continue
        calls = r["routes"]
        cols = torch.cat([torch.arange(latents + r["n"][row] + 2), torch.tensor([-1])])
        pre = torch.stack([c.view(len(r["n"]), -1, c.shape[-1])[row][cols.to(c.device)]
                           for c in calls[:moe_layers]])
        steps = calls[moe_layers:]
        routes = pre
        if steps:
            dec = torch.stack(steps).view(-1, moe_layers, *steps[0].shape)[:, :, row]
            routes = torch.cat([pre, dec.transpose(0, 1)], dim=1)
        out.append({"codes": r["codes"][row].cpu().numpy(),
                    "z": r["z"][row][: r["n"][row]].float().cpu().numpy(), "n": r["n"][row],
                    "tokens": np.concatenate([p[row].reshape(-1).cpu().numpy()
                                              for p in r["parts"]]),
                    "routes": list(routes.cpu().numpy())})
    return out


def run(cell: dict, args, process_start: float) -> dict:
    mods = _program()
    cfg, mix, bsz = cell["config"], cell["traffic"], cell["batch"]
    seed = args.seed
    if common.DEVICE != "cpu":
        mods["build"].build_all(KERNELS)
    pipe = build(cfg, draw_tree(cfg, seed), weights.torch_seed(seed), mods)
    g = weights_moonlight.gpt_group(cfg)
    moe_layers = g["layers"] - g["backbone"]["first_k_dense_replace"]
    latents = cfg["perceiver"]["latents"]
    rec = BatchRecorder(pipe, mods)
    warm = traffic.Request(cell["warm_src_seconds"], cell["warm_ref_seconds"], 0, 0.1, 1, 0.2)
    ins = [common.inputs(warm) for _ in range(bsz)]
    for _ in range(cell["warm_groups"]):
        pipe.synthesize_streaming_batch([s for s, _ in ins], [r for _, r in ins], verbose=False)
    if args.trace:  # the step's graph with the recorder on is captured here too
        rec_tr = mods["tracing"]
        rec_tr.reset()
        rec_tr.enable()
        try:
            pipe.synthesize_streaming_batch([s for s, _ in ins], [r for _, r in ins],
                                            verbose=False)
            mods["moe"].flush_touched()
        finally:
            rec_tr.disable()
            rec_tr.reset()
    rec.take()
    passes = []
    for p in range(cell["passes"]):
        reqs = [common.inputs(r) + (r,) for r in traffic.requests(mix, seed, stream=p)]
        passes.append([reqs[i: i + bsz] for i in range(0, len(reqs) - bsz + 1, bsz)])
    if common.DEVICE != "cpu":
        torch.cuda.synchronize()

    groups, traces, tries = [], [], 0
    t0 = common.now()
    setup_s = t0 - process_start
    queue, next_pass = [], 0
    while queue or common.now() - t0 < args.seconds:
        if not queue:
            if next_pass == len(passes):
                raise RuntimeError("the mix ran out of requests: raise the cell's passes")
            queue, next_pass = list(passes[next_pass]), next_pass + 1
        group = queue.pop(0)
        tracing = (args.trace and tries < cell["trace_tries"]
                   and (not traces or not traces[-1][1]))
        if tracing:
            region: list = []
            rec_tr = mods["tracing"]
            rec_tr.reset()
            rec_tr.enable()
            n_mla = mods["mla"].mla_decode.launches
            try:
                with trace.traced(region):
                    done = _group(pipe, rec, group)
                mods["moe"].flush_touched()  # the group has read back: one more read
            finally:
                rec_tr.disable()
            counters = rec_tr.snapshot()["counters"]
            tr = region[0]
            n_mla = mods["mla"].mla_decode.launches - n_mla
            whole = tr.whole() and tr.count("mla_split") == n_mla
            traces.append((tr, whole, done, counters))
            tries += 1
            if not whole:
                common.note(f"trace {tries}: {tr.count('mla_split')} mla_split records for "
                            f"{n_mla} calls, {len(tr.kernels)} device records for "
                            f"{tr.launches} launches: taken again")
        else:
            done = _group(pipe, rec, group)
        groups.append(done)
        if args.trace and traces[-1][1]:
            break  # a traced run reports the traced group's readings alone
    t_end = groups[-1]["end"]
    if args.trace and not (traces and traces[-1][1]):
        raise RuntimeError(f"no whole trace in {tries} tries")
    if common.DEVICE != "cpu":
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if common.DEVICE != "cpu" else 0
    rec.close()

    rows = [{"group": gi, "row": j, "src_s": grp["src_s"][j]}
            for gi, grp in enumerate(groups) for j in range(len(grp["src_s"]))]
    picked = common.sample(rows, cell["check_rows"], seed)
    for p in picked:
        grp = groups[p["group"]]
        src, ref, _ = grp["inputs"][p["row"]]
        p.update(src=src, ref=ref, audio=grp["audio"][p["row"]],
                 served=row_segments(grp["rounds"], p["row"], moe_layers, latents))
    record = None
    if args.trace:
        tr, _, traced, counters = traces[-1]
        record = {"cell": "stream-b8", "cfg": cfg, "trace": tr, "counters": counters,
                  # the traced group as the stream driver's one call, for the
                  # readers the two cells share
                  "calls": [{"decode_steps": traced["decode_steps"], "start": traced["start"],
                             "end": traced["end"]}],
                  "group": {"prefix_width": pipe._prefix_width, "batch": bsz,
                            "rounds": [{"n": r["n"], "steps": sum(int(t.shape[1])
                                                                  for t in r["parts"][1:])}
                                       for r in traced["rounds"]],
                            "rows": [{"src": traced["inputs"][j][0],
                                      "ref_samples": traced["inputs"][j][1].shape[-1],
                                      "served": row_segments(traced["rounds"], j, moe_layers,
                                                            latents)}
                                     for j in range(len(traced["src_s"]))]}}
    latencies = [t for grp in groups for t in grp["latency_s"]]
    n_groups = len(groups)
    attempted = sum(len(grp["src_s"]) for grp in groups)
    src_total = sum(sum(grp["src_s"]) for grp in groups)
    del pipe, rec, queue, groups, traces
    gc.collect()
    if common.DEVICE != "cpu":
        torch.cuda.empty_cache()

    judged = judge(cfg, seed, picked, control=getattr(args, "control", False))
    numbers = judged["program"]
    common.note(f"routes taken by layer: {numbers.pop('route_agree_by_layer', None)}; "
                f"differing sets' lowest score under the 6th (quantiles 0.5, 0.9, 0.99, 1): "
                f"{numbers.pop('route_below_q', None)}")
    end_to_end = {"setup_s": setup_s, "ttfa_ms_p50": statistics.median(latencies) * 1e3,
                  "audio_s_per_s": src_total / (t_end - t0)}
    common.note(f"window: {attempted} requests in {n_groups} groups, "
                f"{t_end - t0:.3f} s, setup {setup_s:.3f} s")
    return {"correct": check.verdict(numbers), "attempted": attempted, "failed": 0,
            "end_to_end": end_to_end, "memory_peak_bytes": peak, "numbers": numbers,
            "limits": dict(check.LIMITS), "record": record, "control": judged.get("control")}


def _group(pipe, rec, group) -> dict:
    """One group through ``synthesize_streaming_batch``: its rows' inputs,
    audio, first-chunk latencies and recorded rounds."""
    srcs, refs = [s for s, _, _ in group], [r for _, r, _ in group]
    start = common.now()
    wavs, _, _ = pipe.synthesize_streaming_batch(srcs, refs, verbose=False)
    end = common.now()
    rounds, firsts = rec.take()
    if len(firsts) != len(group):
        raise RuntimeError(f"{len(firsts)} first chunks for {len(group)} rows")
    seg_len = int(pipe._seg_len_16k)
    for r_i, r in enumerate(rounds):
        r["active"] = [s.shape[-1] > r_i * seg_len for s in srcs]
    return {"start": start, "end": end, "inputs": group, "audio": wavs, "rounds": rounds,
            "latency_s": [t - start for t in firsts],
            "src_s": [s.shape[-1] / 16000 for s in srcs],
            "decode_steps": pipe.last_timing.get("decode_steps", 0)}


def judge(cfg: dict, seed: int, picked: list, control: bool = False) -> dict:
    """The compared numbers over ``picked`` rows, from a fresh draw of the
    weights; with ``control`` also the control's."""
    tree = draw_tree(cfg, seed)
    g = weights_moonlight.gpt_group(cfg)
    norms = common.mel_norms(cfg)
    r_ref = check.Reference(tree, cfg, g, norms)
    r_ctl = check.Reference(tree, cfg, g, norms, control=True) if control else None
    prog, ctl = [], []
    for p in picked:
        r = r_ref.request(p["src"], p["ref"], p["served"])
        prog.append(check.program_numbers(r, p["served"], p["audio"]))
        if r_ctl is not None:
            c = r_ctl.request(p["src"], p["ref"], p["served"], judge_routes=False)
            r_c = r_ref.request(p["src"], p["ref"], check.served_as(c, p["served"]))
            ctl.append(check.control_numbers(r_c, c))
    del tree
    out = {"program": check.summarise(prog)}
    if ctl:
        out["control"] = check.summarise(ctl)
        out["control"].pop("route_agree_by_layer", None)
        common.note(f"control: differing sets' lowest score under the 6th: "
                    f"{out['control'].pop('route_below_q', None)}")
    return out
