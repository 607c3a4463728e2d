"""Per-rank programs of the parallel paths, for :func:`launch.run_ranks`:
the tests run them on CPU ranks over gloo and ``chip_smoke.py`` on ranks
that share one card. Each takes ``(rank, device, spec)`` (``spec`` a dict
of picklable inputs: configs, numpy trees and batches), runs one parallel
path through the port's entry points and returns what the caller holds
against its single-process reference: metrics, digests, launch counts,
times. Called in one process (no group), each runs the same path on a
(1, 1) mesh: the reference.
"""

from __future__ import annotations

import hashlib
import time

import torch

from genvc_tpu_torch import checkpoint as ckpt
from genvc_tpu_torch import resolve_device
from genvc_tpu_torch.parallel import collectives
from genvc_tpu_torch.parallel import mesh as mesh_lib

_DTYPES = {None: None, "f32": None, "bf16": torch.bfloat16}


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order (host copies)."""
    h = hashlib.sha256()
    for t in tensors:
        t = torch.as_tensor(t).detach().cpu().contiguous()
        h.update(str((t.dtype, tuple(t.shape))).encode())
        h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
    return h.hexdigest()


def _frozen(spec, dev):
    """The frozen tokenizers of ``spec["frozen"]``: their trees, or the paths
    of their stage checkpoints (read here: a tree sent to each spawned rank
    is pickled through its pipe)."""
    from genvc_tpu_torch.train import gpt_stage

    tree = spec["frozen"]
    if all(isinstance(v, str) for v in tree.values()):
        tree = {"contentvec": ckpt.load_contentvec(tree["contentvec"]),
                "acoustic_dvae": ckpt.load_dvae(tree["acoustic_dvae"]),
                "content_dvae": ckpt.load_dvae(tree["content_dvae"])}
    return gpt_stage.make_frozen(spec["cfg"], tree, spec["mel_norms"], dev)


def _mesh(device, n_model=1):
    """The process group's mesh, or in one process a (1, 1) mesh on
    ``device`` (the one-process reference of a parallel run)."""
    if mesh_lib.world_size() > 1:
        return mesh_lib.make_mesh(n_model=n_model, device=device)
    return mesh_lib.make_mesh(1, 1, devices=[device])


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _kernel_counts():
    from genvc_tpu_torch.ops import flash_attention as fa

    return {"flash_attention": fa.flash_attention.launches,
            "flash_attention_dq": fa.flash_attention_dq.launches,
            "flash_attention_dkdv": fa.flash_attention_dkdv.launches}


def _zero_kernel_counts():
    from genvc_tpu_torch.ops import flash_attention as fa

    fa.flash_attention.launches = fa.flash_attention_dq.launches = 0
    fa.flash_attention_dkdv.launches = 0


def core_forward(rank, device, spec):
    """The GPT core's forward on a ``(world / n_model, n_model)`` mesh:
    ``spec``: ``gpt_cfg``, ``core`` (the JAX-layout core tree, numpy),
    ``emb`` (the global (B, T, D) input), ``n_model``. Returns (this rank's
    first row, its rows of the output)."""
    from genvc_tpu_torch.models import gpt as gpt_model

    dev, n_model = resolve_device(device), spec["n_model"]
    mesh = _mesh(dev, n_model)
    tree = {"core": spec["core"]}
    tree = mesh_lib.shard_tree(tree, mesh_lib.gpt_param_specs(tree), mesh)["core"]
    with torch.device("meta"):
        core = gpt_model.Core(spec["gpt_cfg"], n_model)
    ckpt.assign(core, tree, dev)
    rows = mesh_lib.batch_sharding(mesh, len(spec["emb"]))
    with torch.no_grad():
        out = gpt_model.core_forward(core, torch.as_tensor(spec["emb"][rows]).to(dev),
                                     spec["gpt_cfg"], model_group=mesh.model_group)
    return rows.start, out.cpu().numpy()


def gpt_train(rank, device, spec):
    """GPT training steps (stage 3) on a ``(world / n_model, n_model)`` mesh
    through ``gpt_stage.make_train_step(mesh=...)``, once for each compute
    dtype, each from the same initial weights (the frozen modules built
    once).

    ``spec``: ``cfg`` (GenVCConfig of the frozen modules), ``frozen`` (see
    :func:`_frozen`), ``mel_norms``, ``gpt_cfg``, ``gpt_tree`` (JAX layout,
    whole) or ``seed``
    (``gpt.init_tree`` on the rank's device), ``batch`` (the global batch,
    numpy), ``n_model``, ``steps``, ``dtypes`` ("f32", "bf16"),
    ``attn_impl``, ``lr`` (halved from count 1), ``eps``, ``weight_decay``;
    optional ``save_flat`` (dtype -> file: rank 0 ``torch.save``s the whole
    flat vector after the steps there), ``reference`` (dtype -> such a file,
    of a one-process run) and ``return_params`` (rank 0 returns the whole
    tree).

    Returns a list, one dict a dtype: per step the metrics (floats), the
    wall ms (synchronised), the attention kernels' launches and the
    collectives' counts; the batch digest; the digest of the replicated
    segments of the flat vector; with a reference, the max abs difference
    of this rank's flat vector from its shard of the reference after the
    steps (``ref_err``)."""
    from genvc_tpu_torch.models import gpt as gpt_model
    from genvc_tpu_torch.train import gpt_stage, optim
    from genvc_tpu_torch.train.runner import to_device

    dev, n_model = resolve_device(device), spec["n_model"]
    mesh = _mesh(dev, n_model)
    frozen = _frozen(spec, dev)
    gcfg = spec["gpt_cfg"]
    batch = to_device(mesh_lib.shard_batch(spec["batch"], mesh), dev)
    results = []
    for dtype in spec["dtypes"]:
        tree = spec.get("gpt_tree")
        if tree is None:
            tree = gpt_model.init_tree(torch.Generator(device=dev).manual_seed(spec["seed"]),
                                       gcfg)
        if n_model > 1:
            tree = mesh_lib.shard_tree(tree, mesh_lib.gpt_param_specs(tree), mesh)
        with torch.device("meta"):
            model = gpt_model.GPT(gcfg, n_model)
        ckpt.assign(model, tree, dev)
        del tree
        params = optim.FlatParams(model)
        opt = optim.adamw_grouped(optim.multistep_schedule(spec["lr"], [1], 0.5),
                                  eps=spec["eps"], weight_decay=spec["weight_decay"],
                                  params=params, model_group=mesh.model_group).init(params.flat)
        state = gpt_stage.GPTTrainState(model, params, opt, 0, mesh)
        step, _ = gpt_stage.make_train_step(compute_dtype=_DTYPES[dtype],
                                            attn_impl=spec.get("attn_impl", "flash"),
                                            grad_norms=True, mesh=mesh)
        out = {"rank": rank, "dtype": dtype, "data_index": mesh.data_index,
               "model_index": mesh.model_index, "backend": mesh.backend,
               "batch_digest": digest(batch.values()),
               "metrics": [], "ms": [], "launches": [], "collectives": []}
        for _ in range(spec["steps"]):
            _zero_kernel_counts()
            collectives.reset_counts()
            _sync(dev)
            t0 = time.perf_counter()
            state, m = step(state, batch, frozen)
            m = {k: float(v) for k, v in m.items()}
            _sync(dev)
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["metrics"].append(m)
            out["launches"].append(_kernel_counts())
            out["collectives"].append(dict(collectives.counts))
        if spec.get("reference"):
            want = params.shard(torch.load(spec["reference"][dtype], map_location="cpu"), rank)
            out["ref_err"] = float((params.flat.detach() - want.to(dev)).abs().max())
            del want
        if spec.get("save_flat"):
            full = params.gather(params.flat, mesh)
            if rank == 0:
                torch.save(full, spec["save_flat"][dtype])
            del full
        rep = [seg for seg, sh in zip(torch.split(params.flat.detach(), params.sizes),
                                      params.sharded) if not sh]
        out["replicated_digest"] = digest(rep)
        if spec.get("return_params"):
            whole = (gpt_stage.whole_gpt(gcfg, params, params.gather(params.flat, mesh))
                     if n_model > 1 else model)
            out["params"] = ckpt.export_tree(whole) if rank == 0 else None
        results.append(out)
        del state, model, params, opt
    return results


def vq_ema(rank, device, spec):
    """One dVAE training forward on this rank's rows of ``spec["x"]`` with
    the codebook statistics all-reduced over the data group; returns the new
    codebook (numpy). ``spec``: ``dvae_cfg``, ``tree`` (trainable dVAE)."""
    from genvc_tpu_torch.models import dvae

    dev = resolve_device(device)
    mesh = _mesh(dev)
    with torch.device("meta"):
        model = dvae.DVAE(spec["dvae_cfg"], trainable=True)
    ckpt.assign(model, spec["tree"], dev)
    x = torch.as_tensor(mesh_lib.shard_batch({"x": spec["x"]}, mesh)["x"]).to(dev)
    with torch.no_grad():
        cb = model.forward_train(x, mesh.data_group)[3]
    return {k: v.cpu().numpy() for k, v in cb.items()}


def gan_train(rank, device, spec):
    """GAN steps (stage 4) with the batch split over the data ranks
    (``vocoder_stage.make_train_step(data_group=...)``). ``spec``: ``cfg``,
    ``frozen`` (see :func:`_frozen`), ``mel_norms``, ``gpt_cfg``, ``gpt_tree``
    (or the path of a GPT checkpoint),
    ``vocoder_cfg``, ``gen_tree``, ``disc_tree``, ``families``, ``batch``,
    ``steps``, ``lr``, ``eps``. Returns the metrics per step, the
    generator's and the discriminators' trees after the steps (rank 0), and
    the digest of every spectral-norm buffer (to hold them equal across
    ranks)."""
    from genvc_tpu_torch.models import gpt as gpt_model, hifigan
    from genvc_tpu_torch.train import optim, vocoder_stage
    from genvc_tpu_torch.train.runner import to_device

    dev = resolve_device(device)
    mesh = _mesh(dev)
    frozen = _frozen(spec, dev)
    vcfg = spec["vocoder_cfg"]
    with torch.device("meta"):
        gpt = gpt_model.GPT(spec["gpt_cfg"])
        generator = hifigan.Generator(vcfg, weight_norm=True)
        discs = hifigan.Discriminators(vcfg)
    gpt_tree = spec["gpt_tree"]
    if isinstance(gpt_tree, str):
        gpt_tree = ckpt.load_gpt(gpt_tree, spec["gpt_cfg"].layers)
    ckpt.assign(gpt, gpt_tree, dev)
    ckpt.assign(generator, spec["gen_tree"], dev)
    ckpt.assign(discs, spec["disc_tree"], dev)
    gpt.eval()
    gp, dp = optim.FlatParams(generator), optim.FlatParams(discs)
    opt = lambda p: optim.AdamW(spec["lr"], (0.8, 0.99), spec["eps"], 0.01, None).init(p.flat)
    state = vocoder_stage.VocoderTrainState(generator, discs, gp, dp, opt(gp), opt(dp))
    step, _ = vocoder_stage.make_train_step(vcfg, families=spec.get("families"),
                                            data_group=mesh.data_group)
    batch = to_device(mesh_lib.shard_batch(spec["batch"], mesh), dev)
    metrics, ms = [], []
    for _ in range(spec["steps"]):
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch, frozen, gpt)
        metrics.append({k: float(v) for k, v in m.items()})
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    sn = [b for n, b in discs.named_buffers() if n.endswith((".u", ".pv"))]
    return {"metrics": metrics, "ms": ms, "sn_digest": digest(sn), "n_sn": len(sn),
            "gen": ckpt.export_tree(generator) if rank == 0 else None,
            "disc": ckpt.export_tree(discs) if rank == 0 else None}


def dvae_train(rank, device, spec):
    """dVAE training steps (stages 1-2) with the batch split over the data
    ranks. ``spec``: ``vae_cfg`` (VAEConfig), ``tree`` (trainable dVAE),
    ``batch`` ({"wav": (B, 1, T)}), ``mel_norms`` (mel features) or
    ``contentvec`` (the path of its checkpoint, ContentVec features),
    ``steps``. Returns the
    metrics per step and (rank 0) the tree after."""
    from genvc_tpu_torch.models import dvae
    from genvc_tpu_torch.train import optim, vae_stage

    dev = resolve_device(device)
    mesh = _mesh(dev)
    cfg = spec["vae_cfg"]
    with torch.device("meta"):
        model = dvae.DVAE(ckpt.dvae_config(cfg), trainable=True)
    ckpt.assign(model, spec["tree"], dev)
    params = optim.FlatParams(model)
    state = vae_stage.VAETrainState(model, params, vae_stage.make_optimizer(cfg, params))
    step, _ = vae_stage.make_train_step(vae_stage.make_feature_fn(cfg), mesh.data_group)
    wav = torch.as_tensor(mesh_lib.shard_batch(spec["batch"], mesh)["wav"]).to(dev)
    if cfg.feat_type == "Mel-spectrogram":
        feat_params = torch.as_tensor(spec["mel_norms"], device=dev)
    else:
        from genvc_tpu_torch.models import contentvec

        cv_tree = ckpt.load_contentvec(spec["contentvec"])
        with torch.device("meta"):
            feat_params = contentvec.ContentVec(n_layers=ckpt._n_layers(cv_tree))
        ckpt.assign(feat_params, cv_tree, dev)
        feat_params.eval()
    metrics, ms = [], []
    for _ in range(spec["steps"]):
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, {"wav": wav}, feat_params)
        metrics.append({k: float(v) for k, v in m.items()})
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"metrics": metrics, "ms": ms,
            "tree": ckpt.export_tree(model) if rank == 0 else None,
            "codebook_digest": digest(model.codebook.buffers())}


def sequence(rank, device, programs):
    """Several programs of this module in one launch: ``programs`` is a list
    of (function name, spec); returns their results in order."""
    return [globals()[name](rank, device, spec) for name, spec in programs]


def gpt_runner(rank, device, spec):
    """``run_gpt_training(cfg, max_steps, n_model, device)`` on this rank,
    with a digest of each batch the step receives. Returns (the final step,
    the batch digests, the metrics of the last step, rank 0's whole tree)."""
    from genvc_tpu_torch.train import gpt_stage, runner

    digests = []
    prepare = gpt_stage.prepare_features

    def recording(frozen, batch, *a, **kw):
        digests.append(digest(batch.values()))
        return prepare(frozen, batch, *a, **kw)

    gpt_stage.prepare_features = recording
    try:
        state = runner.run_gpt_training(spec["cfg"], max_steps=spec["max_steps"],
                                        max_eval_batches=spec.get("max_eval_batches"),
                                        n_model=spec["n_model"], device=device)
    finally:
        gpt_stage.prepare_features = prepare
    sd = state.state_dict()  # a collective under tensor parallelism
    return {"step": state.step, "digests": digests,
            "params": sd["params"] if rank == 0 else None,
            "opt_count": state.opt.count}


def transport(rank, device, spec):
    """The three collectives on this rank's device over the world group,
    checked (``all_reduce`` sums, ``all_gather`` orders, ``broadcast``
    copies), then the all-reduce's wall ms (synchronised, median of 5 after
    2 warm-ups) at ``spec["sizes"]`` elements, f32 and bf16."""
    import statistics

    import torch.distributed as dist

    dev, world = resolve_device(device), dist.get_world_size()
    x = torch.full((4,), float(rank + 1), device=dev)
    collectives.all_reduce(x, dist.group.WORLD)
    gathered = collectives.all_gather(torch.tensor([rank], device=dev), dist.group.WORLD)
    b = collectives.broadcast(torch.tensor([rank + 10.0], device=dev), 0)
    ok = (x.tolist() == [world * (world + 1) / 2] * 4
          and [int(g) for g in gathered] == list(range(world)) and b.item() == 10.0)
    if not ok:
        raise AssertionError(f"rank {rank}: collectives gave {x.tolist()}, "
                             f"{[int(g) for g in gathered]}, {b.item()}")
    ms = {}
    for n in spec["sizes"]:
        for dt in (torch.float32, torch.bfloat16):
            t = torch.ones(n, dtype=dt, device=dev)
            times = []
            for i in range(7):
                _sync(dev)
                t0 = time.perf_counter()
                collectives.all_reduce(t, dist.group.WORLD)
                _sync(dev)
                if i >= 2:
                    times.append((time.perf_counter() - t0) * 1e3)
            ms[f"{n}_{str(dt).replace('torch.', '')}"] = statistics.median(times)
    return {"backend": dist.get_backend(), "device": str(dev), "all_reduce_ms": ms}
