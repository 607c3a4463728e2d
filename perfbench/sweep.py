"""The knee of a serving cell: the highest offered rate at which the queue
does not grow over the window and 90 % of requests see first audio within
the SLO (500 ms, the JAX package's ``bench_serving.py``).

    python3 -m perfbench.sweep --workload genvc-bf16.serve-poisson \
        --rates 1.5 2 2.5 3 3.5 4 --seconds 40 --out FILE

One process: the cell's weights, pipeline and server are built once; each
rate then runs the cell's mix (its lengths, with the rate replaced) as an
open loop for ``--seconds`` after the server has drained, and appends one
JSON line to ``--out``: offered rate, requests due, time to first audio p50
and p90 (a request without audio at the close counts at its age), the
waiting queue's mean over the first and last third of the window and at the
close, and whether the rate meets the SLO without a growing queue.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=2_900_000_001)
    ap.add_argument("--slo_ms", type=float, default=500.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch

    from perfbench import manifest, program, traffic, weights
    from perfbench.drivers import common, serve

    if not torch.cuda.is_available():
        print("perfbench.sweep: no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(manifest.load(os.getcwd()), args.workload)
    cfg, mix = cell["config"], dict(cell["traffic"])
    sv = cfg["server"]
    pipe = program.build(cfg, common.draw_tree(cfg, args.seed), weights.torch_seed(args.seed),
                         common.DEVICE)
    server = program.recording_server(pipe, sv["slots"], sv["adm_batch"], sv["depth"])
    server.warmup_admission()
    gpu = torch.cuda.get_device_name(0)
    for k, rate in enumerate(args.rates):
        server.drain()
        n = int(rate * args.seconds * 1.5) + 16
        loop = serve.OpenLoop(server, traffic.requests(mix, args.seed + k, n=n, rate=rate), 0.0)
        backlog = []
        step = server.step

        def counted_step():
            backlog.append((common.now(), len(server._queue)))
            return step()

        server.step = counted_step
        loop.t0 = t0 = common.now()
        loop.run_until(t0 + args.seconds)
        t_close = common.now()
        server.step = step
        ttfa = []
        for sid, due in zip(loop.sids, loop.due):
            ttfa.append(loop.first_audio.get(sid, t_close) - due)
        third = args.seconds / 3
        first = [q for t, q in backlog if t < t0 + third] or [0]
        last = [q for t, q in backlog if t >= t0 + 2 * third] or [0]
        grows = statistics.mean(last) > statistics.mean(first) + 1.0 and len(server._queue) > 2
        p90 = common.quantile(ttfa, 90) * 1e3
        row = {"workload": args.workload, "gpu": gpu, "rate": rate,
               "offered_rate": traffic.mean_rate([r for _, _, r in loop.reqs[: len(loop.sids)]]),
               "seconds": args.seconds, "due": len(ttfa),
               "ttfa_ms_p50": statistics.median(ttfa) * 1e3, "ttfa_ms_p90": p90,
               "queue_first_third": statistics.mean(first),
               "queue_last_third": statistics.mean(last), "queue_at_close": len(server._queue),
               "generator_late_ms_max": max(loop.late) * 1e3, "grows": grows,
               "meets_slo": p90 <= args.slo_ms and not grows}
        print(json.dumps(row), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
