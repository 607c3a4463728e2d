"""Run a function on ``world`` rank processes joined in one process group:
the tests' and ``chip_smoke.py``'s launcher (``torchrun`` is the users').

    results = run_ranks(fn, world=2, backend="gloo", devices=["cpu", "cpu"],
                        args=(x,))

Each rank is a spawned process: one CPU thread, its device made current when
it is a card, the group joined through a ``file://`` rendezvous in a fresh
temporary directory (no port to collide between concurrent launches).
``fn(rank, device, *args)`` must be importable (a module-level function of
the package), and its result picklable; the results come back in rank
order. A rank that raises makes ``run_ranks``
raise with that rank's traceback; every process is stopped before it
returns, and a rank that dies without a result is found within a second.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback


def _child(rank, world, backend, init_file, device, fn, args, results):
    import torch
    import torch.distributed as dist

    from genvc_tpu_torch.parallel.mesh import initialize_distributed

    try:
        torch.set_num_threads(1)
        dev = torch.device(device)
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(dev.index or 0) if dev.type == "cuda" else "0")
        initialize_distributed(backend, init_method=f"file://{init_file}",
                               world_size=world, rank=rank, device=dev)
        try:
            out = fn(rank, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, backend: str = "gloo", devices=None, args=(),
              timeout: float = 900.0) -> list:
    """``[fn(0, devices[0], *args), ...]``, each on its own rank process.
    ``devices``: one per rank (default the CPU for every rank)."""
    import torch.multiprocessing as mp

    devices = [str(d) for d in (devices or ["cpu"] * world)]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="genvc_ranks_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_child, daemon=True,
                             args=(r, world, backend, init_file, devices[r], fn, args,
                                   results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out, errors = {}, []
        deadline = time.monotonic() + timeout
        try:
            while len(out) + len(errors) < world:
                try:
                    rank, ok, val = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode is not None and r not in out]
                    if dead and results.empty():
                        raise RuntimeError(f"rank {dead[0]} of {world} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"run_ranks: no result within {timeout} s") from None
                    continue
                if ok:
                    out[rank] = val
                else:
                    errors.append((rank, val))
                    break  # the others may wait on the failed rank forever
        finally:
            for p in procs:
                p.join(timeout=30 if not errors else 1)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
        if errors:
            rank, tb = errors[0]
            raise RuntimeError(f"rank {rank} of {world} failed:\n{tb}")
    return [out[r] for r in range(world)]
