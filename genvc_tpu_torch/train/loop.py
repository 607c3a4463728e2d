"""Training-loop harness: checkpoint / resume, logging, eval cadence
(``genvc_tpu/train/loop.py``).

Epoch loop -> per-step ``train_step`` -> metric averaging -> periodic
keep-N checkpoints (``torch.save``) -> per-epoch eval -> console, jsonl and
optional wandb logging. Metric names match the reference trainers. Under
``torch.distributed`` every rank runs the loop; rank 0 alone logs and
writes checkpoints.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from genvc_tpu_torch.parallel import collectives


def is_main_process() -> bool:
    """Rank 0, or the only process (JAX's ``process_index() == 0``)."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class MetricAverager:
    def __init__(self):
        self.sums = {}
        self.count = 0

    def update(self, metrics: dict):
        for k, v in metrics.items():
            self.sums[k] = self.sums.get(k, 0.0) + float(v)
        self.count += 1

    def averages(self) -> dict:
        if not self.count:
            return {}
        return {k: v / self.count for k, v in self.sums.items()}


class Logger:
    """Console, a ``train_log.jsonl`` under ``out_dir``, and wandb when asked
    for (imported only then); on rank 0 only (the reference gates on
    ``use_wandb and get_rank() == 0``)."""

    def __init__(self, use_wandb=False, project="", run_name="",
                 out_dir: str | None = None):
        self.is_main = is_main_process()
        self.wandb = None
        if use_wandb and self.is_main:
            try:
                import wandb

                wandb.init(project=project, name=run_name)
                self.wandb = wandb
            except Exception as e:  # logging must not stop training
                self.print(f"wandb disabled: {e!r}")
        self.jsonl = None
        if out_dir and self.is_main:
            os.makedirs(out_dir, exist_ok=True)
            self.jsonl = open(os.path.join(out_dir, "train_log.jsonl"), "a")

    def log(self, metrics: dict, step: int | None = None):
        if self.wandb is not None:
            self.wandb.log(metrics)
        if self.jsonl is not None:
            rec = dict(metrics)
            if step is not None:
                rec["step"] = step
            self.jsonl.write(json.dumps(rec, default=float) + "\n")
            self.jsonl.flush()

    def print(self, msg: str):
        if self.is_main:
            print(msg, flush=True)

    def log_histograms(self, tree: dict, step: int | None = None, prefix: str = "grad"):
        """Per-top-level-module value summaries of a tree (gradients or
        parameters, in the JAX package's layout, e.g. ``checkpoint.export_tree``
        of a module): the reference's ``wandb.watch(model)`` surface
        (gpt_trainer.py:48). Each module's values, gathered in the JAX
        package's leaf order (dict keys sorted), go to wandb as a histogram
        and to the jsonl as ``<prefix>/<module>/min``, ``/max`` and ``/l2``.
        It copies the tree to the host: call it on a cadence, not every
        step."""
        for mod, sub in tree.items():
            leaves = [np.asarray(x.detach().cpu() if torch.is_tensor(x) else x).ravel()
                      for x in _leaves(sub)]
            if not leaves:
                continue
            flat = np.concatenate(leaves)
            if self.wandb is not None:
                self.wandb.log({f"{prefix}/{mod}": self.wandb.Histogram(flat)}, step=step)
            if self.jsonl is not None:
                rec = {f"{prefix}/{mod}/min": float(flat.min()),
                       f"{prefix}/{mod}/max": float(flat.max()),
                       f"{prefix}/{mod}/l2": float(np.linalg.norm(flat))}
                if step is not None:
                    rec["step"] = step
                self.jsonl.write(json.dumps(rec) + "\n")
                self.jsonl.flush()

    def close(self):
        if self.jsonl is not None:
            self.jsonl.close()
            self.jsonl = None


def _leaves(node):
    """A tree's leaves in ``jax.tree.leaves`` order: dict keys sorted, lists
    in order; ``None`` is no leaf."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _leaves(node[k])
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _leaves(v)
    elif node is not None:
        yield node


class CheckpointManager:
    """Keep-N checkpoints ``<step>.pt`` in ``directory`` with resume (the
    reference's save_n_checkpoints / save_step / restore_path semantics).
    ``save`` writes ``state.state_dict()``.

    Under ``torch.distributed`` (``device``: this rank's, for the barrier)
    every rank calls ``save``: the state dict is built on every rank (a
    tensor-parallel state gathers its shards there, in the whole model's
    layout), rank 0 writes it, and the ranks meet at a barrier, so no rank
    reads a checkpoint before it exists. Every rank reads ``restore``."""

    def __init__(self, directory: str, keep_n: int = 2, device=None):
        self.directory = os.path.abspath(directory)
        self.keep_n = keep_n
        self.device = device
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := re.fullmatch(r"(\d+)\.pt", f)))

    def save(self, step: int, state):
        sd = state.state_dict()  # on every rank: it may gather
        if is_main_process():
            path = os.path.join(self.directory, f"{step}.pt")
            tmp = path + ".tmp"
            torch.save(sd, tmp)
            os.replace(tmp, path)  # a reader never sees a half-written file
            for old in self.steps()[:-self.keep_n]:
                os.unlink(os.path.join(self.directory, f"{old}.pt"))
        collectives.barrier(self.device or "cpu")

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self):
        """(the latest saved state dict, its step), or (None, None) when there
        is none. The files are this program's own (pickled numpy trees)."""
        step = self.latest_step()
        if step is None:
            return None, None
        path = os.path.join(self.directory, f"{step}.pt")
        return torch.load(path, map_location="cpu", weights_only=False), step


def fit(state, train_step: Callable, train_loader, *,
        epochs: int, logger: Logger, eval_step: Optional[Callable] = None,
        eval_loader=None, ckpt: Optional[CheckpointManager] = None,
        save_step: int = 5000, print_step: int = 50,
        to_device: Callable = lambda b: b, start_step: int = 0,
        on_epoch_end: Optional[Callable] = None,
        max_steps: Optional[int] = None,
        max_eval_batches: Optional[int] = None):
    """Run the training loop; returns the final state.

    max_steps caps TOTAL optimizer steps (resumed ones included): training
    stops mid-epoch when reached, skipping that epoch's eval and
    ``on_epoch_end(state, epoch, step)``, which otherwise runs after each
    epoch's eval. max_eval_batches caps the per-epoch eval pass.
    """
    step = start_step
    done = max_steps is not None and step >= max_steps
    for epoch in range(epochs):
        if done:
            break
        avg = MetricAverager()
        t0 = time.time()
        for batch in train_loader:
            state, metrics = train_step(state, to_device(batch))
            step += 1
            avg.update(metrics)
            if step % print_step == 0:
                m = {k: round(float(v), 4) for k, v in metrics.items()}
                rate = print_step / max(time.time() - t0, 1e-9)
                t0 = time.time()
                logger.print(f"epoch {epoch} step {step} {m} ({rate:.2f} it/s)")
                logger.log({**{k: float(v) for k, v in metrics.items()},
                            "steps_per_sec": rate}, step=step)
            if ckpt is not None and step % save_step == 0:
                ckpt.save(step, state)
            if max_steps is not None and step >= max_steps:
                done = True
                break
        if done:
            break
        log = {f"avg_{k}": v for k, v in avg.averages().items()}
        if eval_step is not None and eval_loader is not None:
            eavg = MetricAverager()
            for i, batch in enumerate(eval_loader):
                if max_eval_batches is not None and i >= max_eval_batches:
                    break
                eavg.update(eval_step(state, to_device(batch)))
            log.update({f"Eval_avg_{k}": v for k, v in eavg.averages().items()})
        log["epoch"] = epoch
        logger.log(log, step=step)
        logger.print(f"epoch {epoch} done: "
                     f"{ {k: round(v, 4) for k, v in log.items() if k != 'epoch'} }")
        if on_epoch_end is not None:
            on_epoch_end(state, epoch, step)
    if ckpt is not None:
        ckpt.save(step, state)
    return state
