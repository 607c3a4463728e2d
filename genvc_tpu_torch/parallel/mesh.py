"""Device mesh and sharding rules (``genvc_tpu/parallel/mesh.py``).

The JAX package runs one controller over a 2-D ``(data, model)`` mesh:
batches shard over ``data`` and GSPMD inserts the gradient reduction; the
GPT's block weights shard Megatron-style over ``model`` (column-parallel
``c_attn`` / ``c_fc``, row-parallel ``c_proj``). Here the same mesh is one
process per device, joined by ``torch.distributed``:

* rank ``r`` sits at ``(r // n_model, r % n_model)``, row-major as
  ``make_mesh`` reshapes JAX's device list;
* its **model group** holds the ``n_model`` consecutive ranks of its row (the
  Megatron all-reduces), its **data group** the ranks with its model index
  (the gradient all-reduce);
* a single process may also build a mesh over several devices (the sharded
  ``StreamServer``); it has no groups.

The transport is chosen up front, never by catching a failure: NCCL when
each rank has its own card, gloo on the CPU and when ranks share one card
(NCCL refuses two ranks on one device). Each rank votes from what it sees
(:func:`choose_backend`) and all take one backend from every vote
(:func:`agree_backend`) before the group is made.

The layout of a tensor-parallel GPT lives here: which dimension of each
leaf splits (:func:`split_dim`, head-aligned for ``c_attn``:
:func:`is_qkv`), a leaf's shard and its inverse (:func:`take_shard`,
:func:`join_shards`). :func:`shard_tree` cuts a whole tree for a rank; the
way back is the flat vector's (``train.optim.FlatParams.gather``).

Deviations from the JAX mesh: a repeated device is accepted (two server
shards on one card), and a batch that the data axis does not divide raises
instead of leaving devices idle (the ranks are fixed by the launcher).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")


@dataclasses.dataclass(eq=False)
class Mesh:
    """``devices``: an ``(n_data, n_model)`` object array of ``torch.device``;
    ``rank`` this process's rank (0 in a single process); ``data_group`` /
    ``model_group`` its process groups (None where the axis has one member
    or in a single process); ``backend`` the transport (None: one process)."""

    devices: np.ndarray
    rank: int = 0
    data_group: object = None
    model_group: object = None
    backend: str | None = None
    axis_names: tuple = AXES

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def n_data(self) -> int:
        return self.devices.shape[0]

    @property
    def n_model(self) -> int:
        return self.devices.shape[1]

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices[self.data_index, self.model_index]


def default_device() -> torch.device:
    """This rank's card: ``cuda:<LOCAL_RANK>`` (``cuda:0`` outside a
    launcher)."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def choose_backend(device) -> str:
    """This rank's own view: NCCL when it runs on a card of its own
    (``cuda:<LOCAL_RANK>``, as many cards as ``LOCAL_WORLD_SIZE`` local
    ranks); gloo on the CPU and when ranks share a card. The ranks settle
    on one backend from every rank's view (:func:`agree_backend`)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", 1)))
    own_card = (dev.index if dev.index is not None else 0) == int(
        os.environ.get("LOCAL_RANK", 0))
    return "nccl" if own_card and local <= torch.cuda.device_count() else "gloo"


def agree_backend(votes: list) -> str:
    """The one backend of every rank's ``(backend, explicit)`` vote: the
    common one when all agree; gloo when automatic choices differ (one rank
    on a shared card makes NCCL impossible for all); a ``ValueError`` when
    a backend asked for explicitly is not everyone's."""
    names = {b for b, _ in votes}
    if len(names) == 1:
        return names.pop()
    if any(explicit for _, explicit in votes):
        raise ValueError(f"the ranks ask for different backends: {sorted(names)}")
    return "gloo"


def initialize_distributed(backend: str | None = None, init_method: str | None = None,
                           world_size: int | None = None, rank: int | None = None,
                           device=None) -> str | None:
    """Join the process group (``genvc_tpu`` ``initialize_distributed``).

    Reads torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` / ``MASTER_PORT`` through ``init_method="env://"``) where
    an argument is not given. Does nothing and returns None when the world
    has one process; else returns the backend. Each rank votes ``backend``,
    or :func:`choose_backend` of ``device`` (default :func:`default_device`);
    the votes are exchanged through the rendezvous store before the group is
    made, and every rank takes :func:`agree_backend` of them, so no two
    ranks join with different backends. A CUDA device becomes the
    process's current device."""
    world = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    if world <= 1:
        return None
    if dist.is_initialized():
        return dist.get_backend()
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    dev = default_device() if device is None else torch.device(device)
    vote = backend or choose_backend(dev)
    store, rank, world = next(dist.rendezvous(init_method or "env://", rank, world))
    votes_store = dist.PrefixStore("genvc_backend", store)
    votes_store.set(str(rank), f"{vote},{int(backend is not None)}")
    votes = []
    for r in range(world):
        b, explicit = votes_store.get(str(r)).decode().split(",")
        votes.append((b, explicit == "1"))
    agreed = agree_backend(votes)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(agreed, store=dist.PrefixStore("default_pg", store),
                            world_size=world, rank=rank)
    return agreed


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(n_data: int | None = None, n_model: int = 1, devices=None,
              device=None) -> Mesh:
    """The ``(data, model)`` mesh.

    In a process group of more than one rank: ``n_data * n_model`` must equal
    the world size (``n_data`` defaults to world / ``n_model``); ``devices``
    (one per rank, in rank order) defaults to every rank's ``device`` (this
    rank's; default the current CUDA device, or the CPU without one),
    exchanged with one ``all_gather``. Every rank must call this, in the same
    order, since it creates the groups.

    In one process: ``devices`` (default every CUDA device) is reshaped
    row-major into ``(n_data, n_model)``; a device may repeat."""
    if world_size() > 1:
        if devices is None:
            own = device if device is not None else (
                torch.device("cuda", torch.cuda.current_device())
                if torch.cuda.is_available() else "cpu")
            devices = [None] * world_size()
            dist.all_gather_object(devices, str(own))
        return _process_mesh(n_data, n_model, devices)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=[...] "
                               "to build a mesh over CPU devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    n_data = n // n_model if n_data is None else int(n_data)
    if n_model < 1 or n_data < 1 or n_data * n_model > n:
        raise ValueError(f"mesh ({n_data}, {n_model}) needs {n_data * n_model} "
                         f"devices; {n} given")
    return Mesh(_grid(devices[: n_data * n_model], n_data, n_model))


def _grid(devices, n_data, n_model) -> np.ndarray:
    arr = np.empty((n_data, n_model), dtype=object)
    for i, d in enumerate(devices):
        arr[i // n_model, i % n_model] = d
    return arr


def _process_mesh(n_data, n_model, devices) -> Mesh:
    world, rank = dist.get_world_size(), dist.get_rank()
    n_data = world // n_model if n_data is None else int(n_data)
    if n_model < 1 or n_data * n_model != world:
        raise ValueError(f"mesh ({n_data}, {n_model}) does not divide the "
                         f"world of {world} ranks")
    devices = [torch.device(d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    # every rank creates every group, in one order
    model_groups = ([dist.new_group(list(range(d * n_model, (d + 1) * n_model)))
                     for d in range(n_data)] if n_model > 1 else None)
    data_groups = ([dist.new_group(list(range(m, world, n_model)))
                    for m in range(n_model)] if n_data > 1 else None)
    return Mesh(_grid(devices, n_data, n_model), rank=rank,
                data_group=data_groups[rank % n_model] if data_groups else None,
                model_group=model_groups[rank // n_model] if model_groups else None,
                backend=dist.get_backend())


# ---------------------------------------------------------------- GPT specs

_COLUMN = ("core/blocks/attn/c_attn/w", "core/blocks/attn/c_attn/b",
           "core/blocks/mlp/c_fc/w", "core/blocks/mlp/c_fc/b")
_ROW = ("core/blocks/attn/c_proj/w", "core/blocks/mlp/c_proj/w")


def _norm_path(path: str) -> str:
    """``core.blocks.3.attn.c_attn.w`` or ``/core/blocks/attn/...`` ->
    ``core/blocks/attn/c_attn/w``: list indices dropped."""
    parts = path.replace(".", "/").split("/")
    return "/".join(p for p in parts if p and not p.isdigit())


def split_dim(path: str, ndim: int) -> int | None:
    """The dimension of a GPT leaf split over ``model``, or None when it is
    replicated: the path rules of ``gpt_param_specs`` (the stacked layer axis
    leads and is never split; a per-layer leaf has no such axis)."""
    p = _norm_path(path)
    if any(r in p for r in _COLUMN):
        return ndim - 1
    if any(r in p for r in _ROW):
        return ndim - 2
    return None


def is_qkv(path: str) -> bool:
    """``c_attn``'s columns are [q | k | v]: its shards are head-aligned, each
    rank holding its heads' columns of all three, so local attention is
    whole (JAX's contiguous column blocks are resharded by GSPMD instead)."""
    return "attn/c_attn" in _norm_path(path)


def gpt_param_specs(tree) -> dict:
    """The tree of specs of a GPT parameter tree in the JAX layout: for each
    leaf a tuple of ``ndim`` entries, ``"model"`` at the split dimension and
    None elsewhere (``()``-like all-None for a replicated leaf)."""

    def spec(path, leaf):
        nd = np.ndim(leaf) if not torch.is_tensor(leaf) else leaf.dim()
        d = split_dim(path, nd)
        return tuple("model" if i == d else None for i in range(nd))

    return _map_with_path(tree, spec)


def _map_with_path(tree, fn, path=""):
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(v, fn, f"{path}/{i}") for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(path, tree)


def _map2(tree, specs, fn, path=""):
    if isinstance(tree, dict):
        return {k: _map2(v, specs[k], fn, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map2(v, s, fn, f"{path}/{i}") for i, (v, s) in enumerate(zip(tree, specs))]
    return fn(path, tree, specs)


def _spec_dim(spec) -> int | None:
    return spec.index("model") if "model" in spec else None


def take_shard(x, dim: int, n: int, m: int, qkv: bool = False):
    """Shard ``m`` of ``n`` of ``x`` (numpy or torch) along ``dim``, a
    contiguous copy; with ``qkv`` the dimension is [q | k | v] and the shard
    takes the m-th block of each third."""
    shp = tuple(x.shape)
    if shp[dim] % (3 * n if qkv else n):
        raise ValueError(f"dimension {dim} of {shp} does not divide over {n} shards")
    if qkv:
        y = x.reshape(*shp[:dim], 3, n, shp[dim] // (3 * n), *shp[dim + 1:])
        y = y[(slice(None),) * (dim + 1) + (m,)]
        y = y.reshape(*shp[:dim], shp[dim] // n, *shp[dim + 1:])
    else:
        size = shp[dim] // n
        y = x[(slice(None),) * dim + (slice(m * size, (m + 1) * size),)]
    return y.contiguous() if torch.is_tensor(y) else np.ascontiguousarray(y)


def join_shards(parts, dim: int, qkv: bool = False):
    """The inverse of :func:`take_shard` over all ``len(parts)`` shards."""
    cat = torch.cat if torch.is_tensor(parts[0]) else (
        lambda xs, dim: np.concatenate(xs, axis=dim))
    if not qkv:
        return cat(list(parts), dim=dim)
    n, shp = len(parts), tuple(parts[0].shape)
    ps = [p.reshape(*shp[:dim], 3, 1, shp[dim] // 3, *shp[dim + 1:]) for p in parts]
    return cat(ps, dim=dim + 1).reshape(*shp[:dim], shp[dim] * n, *shp[dim + 1:])


def shard_tree(tree, specs, mesh: Mesh, rank: int | None = None):
    """The shard of ``tree`` (numpy arrays or tensors, JAX layout) that rank
    ``rank`` (default ``mesh.rank``) holds: each split leaf cut to its
    model index's part, replicated leaves as they are."""
    m = (mesh.rank if rank is None else int(rank)) % mesh.n_model
    n = mesh.n_model

    def leaf(path, x, spec):
        d = _spec_dim(spec)
        return x if d is None or n == 1 else take_shard(x, d, n, m, is_qkv(path))

    return _map2(tree, specs, leaf)


def batch_sharding(mesh: Mesh, batch_size: int) -> slice:
    """The rows of a global batch that this rank's data index holds."""
    if batch_size % mesh.n_data:
        raise ValueError(f"batch of {batch_size} rows does not divide over "
                         f"{mesh.n_data} data ranks")
    per = batch_size // mesh.n_data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of every leaf of a global batch (rows lead)."""
    b = len(next(iter(batch.values())))
    rows = batch_sharding(mesh, b)
    return {k: v[rows] for k, v in batch.items()}


def launch(device: str | None = None) -> torch.device:
    """The training CLIs' start: this rank's device (``device``, else
    :func:`default_device`, ``cuda:<LOCAL_RANK>``) and, under a launcher
    such as ``torchrun``, the process group joined with the backend
    :func:`choose_backend` picks; one process joins nothing."""
    dev = default_device() if device is None else torch.device(device)
    initialize_distributed(device=dev)
    return dev


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
