"""Training-loop harness: checkpoint / resume, logging, eval cadence
(``genvc_tpu/train/loop.py``).

Epoch loop -> per-step ``train_step`` -> metric averaging -> periodic
keep-N checkpoints (``torch.save``) -> per-epoch eval -> console, jsonl and
optional wandb logging. Metric names match the reference trainers. One card,
one process.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Callable, Optional

import torch


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
    for (imported only then)."""

    def __init__(self, use_wandb=False, project="", run_name="",
                 out_dir: str | None = None):
        self.wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(project=project, name=run_name)
                self.wandb = wandb
            except Exception as e:  # logging must not stop training
                self.print(f"wandb disabled: {e!r}")
        self.jsonl = None
        if out_dir:
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
        print(msg, flush=True)

    def close(self):
        if self.jsonl is not None:
            self.jsonl.close()
            self.jsonl = None


class CheckpointManager:
    """Keep-N checkpoints ``<step>.pt`` in ``directory`` with resume (the
    reference's save_n_checkpoints / save_step / restore_path semantics).
    ``save`` writes ``state.state_dict()``."""

    def __init__(self, directory: str, keep_n: int = 2):
        self.directory = os.path.abspath(directory)
        self.keep_n = keep_n
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := re.fullmatch(r"(\d+)\.pt", f)))

    def save(self, step: int, state):
        path = os.path.join(self.directory, f"{step}.pt")
        tmp = path + ".tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path)  # a reader never sees a half-written file
        for old in self.steps()[:-self.keep_n]:
            os.unlink(os.path.join(self.directory, f"{old}.pt"))

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
        max_steps: Optional[int] = None,
        max_eval_batches: Optional[int] = None):
    """Run the training loop; returns the final state.

    max_steps caps TOTAL optimizer steps (resumed ones included): training
    stops mid-epoch when reached, skipping that epoch's eval. max_eval_batches
    caps the per-epoch eval pass. (The JAX package's ``on_epoch_end`` hook
    renders listening samples; that is not ported, ROADMAP A12.)
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
    if ckpt is not None:
        ckpt.save(step, state)
    return state
