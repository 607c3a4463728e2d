"""Optimizers and schedules of the training recipes (``genvc_tpu/train/optim.py``)
with optax's semantics.

* AdamW with weight decay only on weights (reference trainers/gpt_trainer.py:
  389-451): biases, LayerNorm parameters and the embedding tables are left
  out; the Perceiver's ``latents`` and RMSNorm ``gamma`` are raw
  ``nn.Parameter``s in the reference and so decay.
* Clipping is ``optax.clip_by_global_norm``: gradients are scaled, as
  g / g_norm * max_norm, only when g_norm >= max_norm (not torch's
  ``clip_grad_norm_``, which always multiplies by max / (norm + 1e-6)).
* The learning rate of update n (0-based) is the schedule at n, read before
  the count is incremented, and ``multistep_schedule`` is
  ``optax.piecewise_constant_schedule``: a milestone m scales the rate from
  count m on (not torch's ``MultiStepLR``).
* Every trainable parameter is updated, also one whose gradient is zero (the
  Perceiver under ``fix_condition_embeddings``): Adam's moments decay and
  weight decay applies, as optax does for every leaf of the tree. Here that
  holds by construction: the parameters are views of one flat f32 vector
  (:class:`FlatParams`) whose gradient is one dense tensor, zeros included.

The update runs on the flat vector as a handful of whole-vector elementwise
operations, in optax's order of rounding.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

_NO_DECAY_TOP = {"text_embedding", "mel_embedding", "text_pos", "mel_pos"}


def decays(path: Sequence[str]) -> bool:
    """The torch rule: decay everything except biases, LayerNorm scale / bias
    and the embedding tables. ``path`` is the parameter's key path."""
    key = path[-1] if path else ""
    if key in ("b", "bias", "scale"):
        return False
    return not any(p in _NO_DECAY_TOP for p in path)


def weight_decay_mask(params) -> dict:
    """True = apply weight decay, for a parameter tree in the JAX package's
    layout (nested dicts and lists)."""

    def rec(tree, path):
        if isinstance(tree, dict):
            return {k: rec(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            out = [rec(v, path + (str(i),)) for i, v in enumerate(tree)]
            return type(tree)(out) if isinstance(tree, tuple) else out
        return decays(path)

    return rec(params, ())


def multistep_schedule(base_lr: float, milestones_steps: Sequence[int], gamma: float):
    """MultiStepLR as ``optax.piecewise_constant_schedule``: lr * gamma for
    every milestone m with count >= m."""
    bounds = sorted(int(m) for m in milestones_steps)

    def sched(count):
        v = base_lr
        for m in bounds:
            if count >= m:
                v *= gamma
        return v
    return sched


def exponential_epoch_schedule(base_lr: float, gamma: float, steps_per_epoch: int):
    def sched(step):
        return base_lr * gamma ** (step // max(steps_per_epoch, 1))
    return sched


class FlatParams:
    """A module's parameters as views of one flat f32 leaf tensor ``flat``
    (which requires grad), the weight-decayed ones first so that optax's mask
    is one slice. The module's own parameters are re-pointed at detached
    views of ``flat``, so they always hold the current values; the training
    forward takes :meth:`tensors` through ``torch.func.functional_call``."""

    def __init__(self, module: nn.Module):
        named = list(module.named_parameters())
        named.sort(key=lambda np_: not decays(np_[0].split(".")))  # stable
        self.names = [n for n, _ in named]
        self.shapes = [tuple(p.shape) for _, p in named]
        self.sizes = [p.numel() for _, p in named]
        self.n_decay = sum(s for (n, _), s in zip(named, self.sizes)
                           if decays(n.split(".")))
        self.flat = torch.cat([p.detach().reshape(-1).float() for _, p in named])
        self.flat.requires_grad_(True)
        for name, view in self.views(self.flat.detach()).items():
            mod_name, _, leaf = name.rpartition(".")
            setattr(module.get_submodule(mod_name), leaf,
                    nn.Parameter(view, requires_grad=False))

    def views(self, src) -> dict:
        """Name -> view of the flat vector ``src`` (the parameters, a
        gradient, a moment) in the parameter's shape."""
        return {n: t.view(s) for n, t, s in
                zip(self.names, torch.split(src, self.sizes), self.shapes)}

    def tensors(self, dtype=None) -> dict:
        """Name -> parameter, differentiable in ``flat``; ``dtype`` casts the
        whole vector first (bf16 compute on f32 masters). One split, so the
        backward is one concatenation with zeros for unused parameters."""
        src = self.flat if dtype in (None, torch.float32) else self.flat.to(dtype)
        return self.views(src)


def global_norm(x):
    """optax.global_norm of the tree whose leaves are the flat vector's
    segments (one reduction)."""
    return torch.linalg.vector_norm(x)


class AdamW:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(lr_schedule,
    b1, b2, eps, weight_decay, mask))`` on a flat f32 vector. ``n_decay``:
    the decayed elements are ``[:n_decay]`` (None: all of them)."""

    def __init__(self, lr_schedule, betas=(0.9, 0.96), eps=1e-8, weight_decay=1e-6,
                 max_grad_norm: float | None = 1.0, n_decay: int | None = None):
        self.lr_schedule = lr_schedule if callable(lr_schedule) else (lambda _: lr_schedule)
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm if max_grad_norm and max_grad_norm > 0 else None
        self.n_decay = n_decay
        self.count = 0
        self.mu = self.nu = None

    def init(self, flat):
        self.count = 0
        self.mu = torch.zeros_like(flat, dtype=torch.float32)
        self.nu = torch.zeros_like(flat, dtype=torch.float32)
        return self

    @torch.no_grad()
    def step(self, flat, grad):
        """One update of ``flat`` in place from ``grad`` (consumed)."""
        g = grad
        if self.max_grad_norm is not None:
            g_norm = global_norm(g)
            keep = g_norm < self.max_grad_norm
            # select(trigger, g, (g / g_norm) * max_norm), without a host read
            g = (g / torch.where(keep, 1.0, g_norm)) * torch.where(
                keep, 1.0, torch.full_like(g_norm, self.max_grad_norm))
        lr = self.lr_schedule(self.count)
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        self.mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
        self.nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
        u = (self.mu / bc1).div_((self.nu / bc2).sqrt_().add_(self.eps))
        n = flat.numel() if self.n_decay is None else self.n_decay
        if self.weight_decay and n:
            u[:n].add_(flat[:n], alpha=self.weight_decay)
        flat.add_(u, alpha=-lr)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict):
        self.count = int(state["count"])
        self.mu.copy_(state["mu"])
        self.nu.copy_(state["nu"])


def adamw_grouped(lr_schedule, betas=(0.9, 0.96), eps=1e-8, weight_decay=1e-6,
                  max_grad_norm: float | None = 1.0, params: FlatParams | None = None):
    """The GPT stage's optimizer; with ``params`` the decay skips biases,
    norms and embeddings, without it every element decays."""
    return AdamW(lr_schedule, betas, eps, weight_decay, max_grad_norm,
                 None if params is None else params.n_decay)


# The JAX package's single-traversal variant of the same recipe. On the flat
# vector the chained and fused forms are one update, so the two names give
# the same optimizer here.
adamw_clip_fused = adamw_grouped


def vocoder_adamw(lr_schedule, betas=(0.8, 0.99)):
    """torch ``AdamW(params, lr, betas)`` defaults: decoupled weight decay
    0.01 on every parameter, eps 1e-8, no clipping."""
    return AdamW(lr_schedule, betas, 1e-8, 0.01, None, None)
