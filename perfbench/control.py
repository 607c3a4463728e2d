"""Readings that set the limits of ``correct``: the program's compared
numbers and the control's on many seeds, at a cell's own size and load.

    python3 -m perfbench.control --workload <cell> --seeds 12 [--seconds 10] [--out FILE]

Runs the cell's driver once per seed in one process (so the kernels build
once), each with a short window at the cell's own load, and judges the
sampled requests (or the checked training steps) twice: the program against
the reference, and the control (the reference one precision lower in each
family: TF32 below float32, float8 e4m3 products below bf16) against the
reference; a training cell also reads the reference with half of each batch
left out. Prints one JSON line per seed and, last, each number's largest
program reading and smallest control reading.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first_seed", type=int, default=3_000_000_000)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from perfbench import manifest

    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(manifest.load(os.getcwd()), args.workload)
    driver = importlib.import_module(f"perfbench.drivers.{cell['driver']}")
    rows = []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        run_args = argparse.Namespace(seed=seed, seconds=args.seconds, trace=0, control=True)
        out = driver.run(cell, run_args, time.perf_counter())
        row = {"seed": seed, "program": out["numbers"], "control": out["control"],
               "attempted": out["attempted"]}
        if out.get("half_batch"):
            row["half_batch"] = out["half_batch"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    keys = rows[0]["program"]
    summary = {k: {"program_max": max(r["program"][k] for r in rows),
                   "control_min": min(r["control"][k] for r in rows)} for k in keys}
    if "half_batch" in rows[0]:
        for k in keys:
            summary[k]["half_batch_min"] = min(r["half_batch"][k] for r in rows)
    print(json.dumps({"workload": args.workload, "seeds": len(rows), "readings": summary}),
          flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps({"workload": args.workload, **r}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
