"""Run one cell of the benchmark once.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything about the cell is data found by name: its entry in
``BENCHMARK.json``, ``perfbench/cells/<cell>.json`` (the entry it drives and
that entry's settings), ``perfbench/configs/<config>.json`` and
``perfbench/traffic/<traffic>.json``; with ``--trace 1`` each per-layer
metric the cell reports is read by ``perfbench/metrics/<metric>.py``. The
last line of standard output is one JSON object; the numbers that decide
``correct`` are also the last lines of standard error.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "genvc_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    each compared whole (``genvc_tpu_torch`` is not ``genvc_tpu``)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def warm_profiler():
    """Start the profiler once in set-up: its first start initialises the
    device tracer, which holds the host up for seconds."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int = 2):
    print(msg, file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> int:
    args = parse(argv)
    from perfbench import manifest

    root = os.getcwd()
    try:
        bench = manifest.load(root)
        cell = manifest.cell(bench, args.workload)
    except (OSError, KeyError, ValueError) as e:
        fail(f"perfbench: {e}")
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        fail(f"perfbench: the cell needs {cell['chips']} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present")
    if args.trace:
        warm_profiler()
    driver = importlib.import_module(f"perfbench.drivers.{cell['driver']}")
    out = driver.run(cell, args, PROCESS_START)

    found = forbidden_modules()
    if found:
        fail(f"perfbench: the run loaded {', '.join(found)}", 3)

    if args.trace:
        metrics = {}
        for m in manifest.per_layer(bench, args.workload):
            reader = manifest.metric_reader(root, m["name"])
            value = reader(out["record"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(out["end_to_end"][m["name"]]), "unit": m["unit"]}
                   for m in manifest.end_to_end(bench, args.workload)}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": device}
    if args.trace:
        tr = out["record"]["trace"]
        device.update(busy_s=tr.busy_s(), window_s=tr.wall_s)
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    compared = {k: out["numbers"][k] for k in out["limits"]}
    result["checks"] = {k: {"value": v if math.isfinite(v) else None,
                            "limit": out["limits"][k]} for k, v in compared.items()}
    for k, v in compared.items():
        print(f"check {k} {v!r} limit {out['limits'][k]!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
