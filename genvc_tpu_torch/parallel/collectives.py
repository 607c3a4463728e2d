"""The collectives of the parallel paths, over ``torch.distributed`` groups.

Only ``all_reduce``, ``all_gather`` and ``broadcast`` are used: gloo does not
offer every collective on CUDA tensors. Each call adds one to its entry of
:data:`counts` and its payload to ``counts["bytes"]``.

Megatron's conjugate pair sits around the tensor-parallel products:
:func:`copy_to_model` (identity forward, all-reduce of the gradient over the
model group backward) at the input of each column-parallel product, and
:func:`reduce_from_model` (all-reduce forward, identity backward) after each
row-parallel one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

counts = {"all_reduce": 0, "all_gather": 0, "broadcast": 0, "bytes": 0}


def reset_counts() -> None:
    counts.update(all_reduce=0, all_gather=0, broadcast=0, bytes=0)


def _run(kind, t, fn):
    counts[kind] += 1
    counts["bytes"] += t.numel() * t.element_size()
    return fn()


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` summed (or averaged, ``op="mean"``) over ``group``, in place;
    returns ``t``. ``group`` None is a group of one: nothing happens."""
    if group is None:
        return t
    _run("all_reduce", t, lambda: dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group))
    if op == "mean":
        t.div_(dist.get_world_size(group))
    elif op != "sum":
        raise ValueError(f"op {op!r}: 'sum' or 'mean'")
    return t


def all_reduce_values(values: dict, group, op: str = "sum") -> dict:
    """A dict of 0-dim tensors (a step's metrics) reduced over ``group`` in
    one all-reduce."""
    if group is None:
        return values
    return dict(zip(values, all_reduce(torch.stack(list(values.values())), group, op)))


def all_gather(t: torch.Tensor, group) -> list:
    """Every member's ``t`` (same shape), in the group's rank order."""
    if group is None:
        return [t]
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    _run("all_gather", t, lambda: dist.all_gather(out, t, group=group))
    return out


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` from global rank ``src``, in place."""
    _run("broadcast", t, lambda: dist.broadcast(t, src, group=group))
    return t


def barrier(device) -> None:
    """Every rank waits for the others: a one-element all-reduce on
    ``device`` (no ``dist.barrier``, whose NCCL form guesses the device)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        all_reduce(torch.zeros(1, device=device), dist.group.WORLD)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x, group):
    """Identity; the gradient is summed over ``group`` (the input of a
    column-parallel product)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    """``x`` summed over ``group``; the gradient passes unchanged (after a
    row-parallel product)."""
    return _ReduceFromModel.apply(x, group)
