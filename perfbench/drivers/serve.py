"""Independent users on a one-card server: ``StreamServer.submit`` / ``step``
in an open loop.

Set-up draws the weights, builds the pipeline and the server, warms every
admission wave (``warmup_admission``) and the pool's tick with one stream,
then runs ``lead_in_seconds`` of the same arrival process (not counted), so
the window opens on a populated pool. In the window each request is
submitted when due, with ``arrival_t`` its due time, and the loop steps the
server whenever it holds work. A request's time to first audio runs from
its due time to its first crossfaded chunk on the host, stamped on the
harness's clock by the chunk callback that ``submit`` takes; one without
first audio when the window closes counts at its age then. With ``--trace 1`` the
window's first ``trace_seconds`` are traced, between two device
synchronisations, and traced again at most ``trace_tries`` times while the
trace lost device records.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import time

import torch

from perfbench import program, trace, traffic, weights
from perfbench.drivers import common
from perfbench.reference import check


class OpenLoop:
    def __init__(self, server, reqs, t0: float):
        self.server, self.t0 = server, t0
        self.reqs = [common.inputs(r) + (r,) for r in reqs]
        self.next = 0
        self.sids: list[int] = []
        self.due: list[float] = []
        self.late: list[float] = []
        self.idle: list[tuple[float, float]] = []
        self.submits: list[tuple[float, int]] = []
        self.first_audio: dict[int, float] = {}

    def _on_chunk(self, sid, chunk):
        self.first_audio.setdefault(sid, common.now())

    def run_until(self, t_stop: float):
        server = self.server
        while True:
            now = common.now()
            if now >= t_stop:
                return
            while self.next < len(self.reqs) and self.t0 + self.reqs[self.next][2].at <= now:
                src, ref, req = self.reqs[self.next]
                due = self.t0 + req.at
                self.late.append(common.now() - due)
                self.sids.append(server.submit(src, ref, on_chunk=self._on_chunk,
                                               arrival_t=due))
                self.due.append(due)
                self.submits.append((common.now(), ref.shape[-1]))
                self.next += 1
            if self.next >= len(self.reqs):
                raise RuntimeError("the mix ran out of requests before the window closed")
            if not server.step():
                wake = min(t_stop, self.t0 + self.reqs[self.next][2].at)
                a = common.now()
                time.sleep(max(0.0, wake - a))
                self.idle.append((a, common.now()))


def _traced(loop, t_stop: float):
    """Run the open loop to ``t_stop`` under the profiler: (trace, whole,
    host start, host end, K3 launches)."""
    from genvc_tpu_torch.ops import decode_attention as da

    k3 = da.decode_attention_update_layer.launches
    region: list = []
    a = common.now()
    with trace.traced(region):
        loop.run_until(t_stop)
    b = common.now()
    n_k3 = da.decode_attention_update_layer.launches - k3
    return region[0], None, a, b, n_k3


def _whole(t) -> bool:
    tr, _, _, _, n_k3 = t
    return tr.whole() and tr.count("decode_split_logits") == n_k3


def run(cell: dict, args, process_start: float) -> dict:
    from genvc_tpu_torch.ops import decode_attention as da

    cfg, mix = cell["config"], cell["traffic"]
    seed = args.seed
    sv = cfg["server"]
    pipe = program.build(cfg, common.draw_tree(cfg, seed), weights.torch_seed(seed), common.DEVICE)
    server = program.recording_server(pipe, sv["slots"], sv["adm_batch"], sv["depth"])
    server.warmup_admission()
    src, ref = common.inputs(traffic.Request(cell["warm_src_seconds"],
                                             cell["warm_ref_seconds"], 0, 0.1, 1, 0.2))
    server.submit(src, ref)
    server.drain()
    n = int(math.ceil(mix["rate"] * (args.seconds + cell["lead_in_seconds"]) * 1.5)) + 16
    lead = OpenLoop(server, traffic.requests(mix, seed, n=n, stream=1), common.now())
    lead.run_until(lead.t0 + cell["lead_in_seconds"])
    loop = OpenLoop(server, traffic.requests(mix, seed, n=n), 0.0)

    traces = []
    loop.t0 = t0 = common.now()
    setup_s = t0 - process_start
    t_close = t0 + args.seconds
    if args.trace:
        loop.run_until(t_close - cell["trace_seconds"])
        traces.append(_traced(loop, t_close))
    loop.run_until(t_close)
    t_close = common.now()
    window_sids = list(loop.sids)
    ttfa = []
    for sid, due in zip(loop.sids, loop.due):
        first = loop.first_audio.get(sid)
        ttfa.append((first if first is not None and first <= t_close else t_close) - due)
    while args.trace and not _whole(traces[-1]) and len(traces) < cell["trace_tries"]:
        tr = traces[-1][0]
        common.note(f"trace {len(traces)}: {tr.count('decode_split_logits')} K3 records for "
                    f"{traces[-1][4]} launches, {len(tr.kernels)} device records for "
                    f"{tr.launches} launches: taken again after the window")
        traces.append(_traced(loop, common.now() + cell["trace_seconds"]))
    if args.trace and not _whole(traces[-1]):
        raise RuntimeError(f"no whole trace in {len(traces)} tries")
    # finish the window's requests for the check: a late answer is late, not wrong
    t_wait = common.now() + cell["finish_seconds"]
    while (not all(server.finished(s) for s in window_sids)
           and common.now() < t_wait and server.step()):
        pass
    done = [s for s in window_sids if server.finished(s)]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    late = sorted(loop.late)
    common.note(f"generator lateness over {len(late)} submissions: median "
                f"{statistics.median(late) * 1e3:.3f} ms, max {late[-1] * 1e3:.3f} ms")
    print(json.dumps({"generator_late_ms": {"median": statistics.median(late) * 1e3,
                                            "max": late[-1] * 1e3, "n": len(late)},
                      "offered_rate": traffic.mean_rate([r for _, _, r in loop.reqs[: len(late)]])}),
          flush=True)

    results = {sid: server.result(sid) for sid in done}
    items = []
    for sid in done:
        wav, stats = results[sid]
        i = loop.sids.index(sid)
        src, ref, _ = loop.reqs[i]
        items.append({"sid": sid, "src_s": src.shape[-1] / 16000, "src": src, "ref": ref,
                      "audio": wav})
    picked = common.sample(items, cell["check_requests"], seed)
    for p in picked:
        p["served"] = server.served(p["sid"])
    record = None
    if args.trace:
        tr, _, a, b, _ = traces[-1]
        record = {"cell": "serve", "cfg": cfg, "trace": tr, "start": a, "end": b,
                  "dispatches": [d for d in server.dispatches if a <= d[0] <= b],
                  "admissions": [x for x in server.admissions if a <= x[0] <= b],
                  "submits": [x for x in loop.submits if a <= x[0] <= b],
                  "idle": loop.idle,
                  "queue_wait_s": [results[s][1]["queue_wait_s"] for s, due in
                                   zip(window_sids, loop.due) if s in results and due < a]}
    queue_wait = [results[s][1]["queue_wait_s"] for s in done]
    del server, pipe, lead, loop, results
    gc.collect()
    torch.cuda.empty_cache()

    judged = common.judge(cfg, seed, picked, control=getattr(args, "control", False))
    numbers = judged["program"]
    end_to_end = {"setup_s": setup_s,
                  "ttfa_ms_p50": statistics.median(ttfa) * 1e3,
                  "ttfa_ms_p90": common.quantile(ttfa, 90) * 1e3}
    common.note(f"window: {len(ttfa)} requests due, {len(done)} finished, queue wait "
                f"median {statistics.median(queue_wait) * 1e3 if queue_wait else 0:.1f} ms, "
                f"setup {setup_s:.3f} s")
    return {"correct": check.verdict(numbers), "attempted": len(ttfa), "failed": 0,
            "end_to_end": end_to_end, "memory_peak_bytes": peak, "numbers": numbers,
            "limits": dict(check.LIMITS), "record": record,
            "control": judged.get("control")}
