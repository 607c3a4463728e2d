"""Stage runners (``genvc_tpu/train/runner.py``): each ``run_*_training``
mirrors one reference entry script end to end — frozen modules from the
stage checkpoints, the trainable modules, the data, the optimizers and the
loop with keep-N checkpoints and resume.

In a process group (``parallel.mesh.initialize_distributed``, e.g. under
``torchrun``) every runner trains data-parallel over the ranks: the global
batch stays ``batch_size`` and each data rank reads ``batch_size / n_data``
rows from its own stride of the data. The GPT runner's ``n_model`` shards
the GPT Megatron-style over groups of ``n_model`` consecutive ranks, which
read identical batches.

* :func:`run_vae_training`: the acoustic and content dVAEs (stages 1-2);
* :func:`run_gpt_training`: the GPT (stage 3);
* :func:`run_vocoder_training`: the HiFi-GAN GAN (stage 4), against the
  frozen GPT's latents.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from genvc_tpu_torch import checkpoint as ckpt_lib
from genvc_tpu_torch import resolve_device
from genvc_tpu_torch.config import GenVCConfig, VAEConfig
from genvc_tpu_torch.data.dataset import VCDatasetConfig, VCWaveDataset, WaveformDVAEDataset
from genvc_tpu_torch.data.loader import BatchLoader
from genvc_tpu_torch.models import contentvec, dvae, gpt as gpt_model, hifigan
from genvc_tpu_torch.parallel import mesh as mesh_lib
from genvc_tpu_torch.train import gpt_stage, loop, optim, vae_stage, vocoder_stage


def datasets(cfg: GenVCConfig):
    """(train, eval) datasets of the stage."""
    ma = cfg.model_args

    def ds(meta, is_eval):
        return VCWaveDataset(VCDatasetConfig(
            meta_file=meta, sample_rate=cfg.audio.sample_rate,
            text_frame_rate=cfg.text_frame_rate,
            min_text_len=ma.min_text_length, max_text_len=ma.max_text_length,
            min_conditioning_length=ma.min_conditioning_length,
            max_conditioning_length=ma.max_conditioning_length,
            use_masking_gt_prompt_approach=ma.gpt_use_masking_gt_prompt_approach,
            is_eval=is_eval))
    return ds(cfg.train_metafile, False), ds(cfg.test_metafile, True)


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


def _device_banner(dev, mesh=None) -> str:
    out = f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})"
                              if dev.type == "cuda" else "")
    if mesh is not None:
        out += (f"; mesh data={mesh.n_data} x model={mesh.n_model} over "
                f"{mesh.n_data * mesh.n_model} ranks, backend {mesh.backend}")
    return out


def _data_mesh(batch_size: int, n_model: int, dev) -> mesh_lib.Mesh | None:
    """The ``(data, model)`` mesh of the process group (None for one
    process): ``n_model`` consecutive ranks per model group, the rest data
    parallel. JAX's ``_data_mesh`` shrinks the data axis until it divides
    the batch; the ranks here are fixed by the launcher, so a batch the
    data axis does not divide raises."""
    world = mesh_lib.world_size()
    if n_model < 1 or world % n_model:
        raise ValueError(f"n_model={n_model} does not divide the world of {world} "
                         "ranks: launch n_model x n_data ranks (torchrun "
                         "--nproc_per_node N)")
    n_data = world // n_model
    if batch_size % n_data:
        raise ValueError(f"batch of {batch_size} rows does not divide over {n_data} "
                         f"data ranks (world size {world}, n_model {n_model})")
    if world == 1:
        return None
    return mesh_lib.make_mesh(n_data=n_data, n_model=n_model, device=dev)


def _loaders(cfg, train_ds, eval_ds, mesh=None):
    """Each data rank reads a disjoint stride of the sample order, its
    ``1 / n_data`` share of each global batch (``_loader_shards``); the
    ranks of one model group read the same stride, so the same batches."""
    n, i = (1, 0) if mesh is None else (mesh.n_data, mesh.data_index)
    for what, b in (("batch_size", cfg.batch_size), ("eval_batch_size", cfg.eval_batch_size)):
        if b % n:
            raise ValueError(f"{what} {b} does not divide over {n} data ranks")
    lockstep = mesh is not None  # a lost batch raises, never desynchronises ranks
    return (BatchLoader(train_ds, cfg.batch_size // n, num_workers=cfg.num_loader_workers,
                        num_shards=n, shard_index=i, lockstep=lockstep),
            BatchLoader(eval_ds, cfg.eval_batch_size // n, shuffle=False,
                        num_workers=cfg.num_loader_workers, num_shards=n, shard_index=i,
                        lockstep=lockstep))


def _check_names(restored_names, params: optim.FlatParams):
    if restored_names != params.names:
        raise ValueError("checkpoint parameter layout differs from the model's")


def run_vae_training(cfg: VAEConfig, max_steps: int | None = None,
                     max_eval_batches: int | None = None, device="cuda"):
    """Train a dVAE (stage 1: mel features; stage 2: ContentVec features),
    data-parallel over the process group if there is one; returns the final
    :class:`vae_stage.VAETrainState`. At each epoch's end the first eval
    batch's input and reconstruction are plotted under
    ``<output_path>/eval_plots`` (and logged to wandb when on), on rank 0."""
    dev = resolve_device(device)
    mesh = _data_mesh(cfg.batch_size, 1, dev)
    logger = loop.Logger(cfg.use_wandb, cfg.wandb_project, cfg.wandb_run_name,
                         cfg.output_path)
    logger.print(_device_banner(dev, mesh))
    if cfg.feat_type == "Mel-spectrogram":
        feat_params = torch.as_tensor(ckpt_lib.load_mel_norms(cfg.mel_norm_file), device=dev)
    else:
        cv_tree = ckpt_lib.load_contentvec(cfg.contentvec_model_path)
        with torch.device("meta"):
            feat_params = contentvec.ContentVec(n_layers=ckpt_lib._n_layers(cv_tree))
        ckpt_lib.assign(feat_params, cv_tree, dev)
        feat_params.eval()
    feat_fn = vae_stage.make_feature_fn(cfg)

    dcfg = ckpt_lib.dvae_config(cfg)
    ckpt = loop.CheckpointManager(os.path.join(cfg.output_path, "ckpt"),
                                  cfg.save_n_checkpoints, dev)
    restored, step0 = ckpt.restore()
    if restored is not None:
        tree = restored["params"]
    elif cfg.vae_checkpoint:
        tree = ckpt_lib.load_dvae(cfg.vae_checkpoint)
    else:
        tree = dvae.init_tree(torch.Generator(device=dev).manual_seed(1994), dcfg,
                              trainable=True)
    with torch.device("meta"):
        model = dvae.DVAE(dcfg, trainable=True)
    ckpt_lib.assign(model, tree, dev)
    params = optim.FlatParams(model)
    opt = vae_stage.make_optimizer(cfg, params)
    if restored is not None:
        _check_names(restored["names"], params)
        opt.load_state_dict(restored["opt_state"])
        logger.print(f"resumed from step {step0}")
    state = vae_stage.VAETrainState(model, params, opt, int(step0 or 0))
    train_step, eval_step = vae_stage.make_train_step(
        feat_fn, None if mesh is None else mesh.data_group)

    rate = cfg.audio.dvae_sample_rate
    train_loader, eval_loader = _loaders(
        cfg, WaveformDVAEDataset(cfg.train_metafile, False, rate, cfg.max_wav_len),
        WaveformDVAEDataset(cfg.test_metafile, True, rate, cfg.max_wav_len), mesh)

    def on_epoch_end(state, epoch, step):
        # input-vs-reconstruction images (reference VAE_trainer eval_step and
        # its wandb table, VAE_trainer.py:134-141); a failure is logged, the
        # training goes on
        if not logger.is_main:
            return
        try:
            from genvc_tpu_torch.utils import plot_feat

            batch = to_device(next(iter(eval_loader)), dev)
            with torch.no_grad():
                feat = feat_fn(feat_params, batch["wav"])
                recon = state.model.forward_train(feat)[2]
            img_dir = os.path.join(cfg.output_path, "eval_plots")
            os.makedirs(img_dir, exist_ok=True)
            paths = {name: os.path.join(img_dir, f"e{epoch}_{name}.png")
                     for name in ("input", "recon")}
            plot_feat(feat[0].cpu().numpy(), paths["input"])
            plot_feat(recon[0].cpu().numpy(), paths["recon"])
            if logger.wandb is not None:
                logger.wandb.log({f"eval/{name}": logger.wandb.Image(p)
                                  for name, p in paths.items()})
        except Exception as e:
            logger.print(f"eval plot failed: {e!r}")

    try:
        return loop.fit(state, lambda s, b: train_step(s, b, feat_params), train_loader,
                        epochs=cfg.epochs, logger=logger,
                        eval_step=lambda s, b: eval_step(s, b, feat_params),
                        eval_loader=eval_loader, ckpt=ckpt, save_step=cfg.save_step,
                        to_device=lambda b: to_device(b, dev), start_step=state.step,
                        on_epoch_end=on_epoch_end, max_steps=max_steps,
                        max_eval_batches=max_eval_batches)
    finally:
        logger.close()


def run_gpt_training(cfg: GenVCConfig, max_steps: int | None = None,
                     max_eval_batches: int | None = None, n_model: int = 1,
                     bf16: bool = False, remat=False, content_bf16: bool = False,
                     attn_impl: str = "flash", device="cuda"):
    """Train the GPT (stage 3); returns the final
    :class:`gpt_stage.GPTTrainState`.

    bf16=True runs the trainable GPT in bfloat16 on f32 masters (the frozen
    tokenizers stay f32; ``content_bf16`` runs the frozen ContentVec in bf16).
    ``attn_impl="flash"`` (default) runs the attention kernels, forward and
    backward; "xla" the dense path under autograd. ``remat`` (True or
    "dots") checkpoints the GPT's blocks. At each epoch's end the listening
    samples of the first eval batch are written to
    ``<output_path>/eval_samples/e<epoch>_self.wav`` and
    ``e<epoch>_cross<row>.wav`` (and logged to wandb when on), on rank 0.

    In a process group the ranks form a ``(world / n_model, n_model)`` mesh:
    ``n_model`` > 1 shards the GPT Megatron-style over each model group
    (``parallel.mesh.shard_tree``), the rest is data parallel. Checkpoints
    hold the whole model, so a run resumes at any ``n_model``. ``n_model``
    must divide the GPT's heads and the world size, and the data axis the
    batch (``ValueError``)."""
    gcfg = ckpt_lib.gpt_config(cfg)
    if n_model < 1 or gcfg.heads % n_model:
        raise ValueError(f"{gcfg.heads} heads do not divide over n_model={n_model}")
    dev = resolve_device(device)
    mesh = _data_mesh(cfg.batch_size, n_model, dev)
    logger = loop.Logger(cfg.use_wandb, cfg.wandb_project, cfg.wandb_run_name,
                         cfg.output_path)
    logger.print(_device_banner(dev, mesh))
    tp = mesh is not None and mesh.n_model > 1

    ma = cfg.model_args
    frozen = gpt_stage.make_frozen(cfg, {
        "contentvec": ckpt_lib.load_contentvec(cfg.contentvec_model_path),
        "acoustic_dvae": ckpt_lib.load_dvae(cfg.acoustic_dvae_checkpoint),
        "content_dvae": ckpt_lib.load_dvae(cfg.content_dvae_checkpoint),
    }, ckpt_lib.load_mel_norms(ma.mel_norm_file), dev)

    if ma.gpt_checkpoint:
        tree = ckpt_lib.load_gpt(ma.gpt_checkpoint, gcfg.layers)
    else:
        gen = torch.Generator(device=dev).manual_seed(cfg.training_seed)
        tree = gpt_model.init_tree(gen, gcfg)
    ckpt = loop.CheckpointManager(os.path.join(cfg.output_path, "ckpt"),
                                  cfg.save_n_checkpoints, dev)
    restored, step0 = ckpt.restore()
    if restored is not None:
        tree = restored["params"]
    if tp:
        tree = mesh_lib.shard_tree(tree, mesh_lib.gpt_param_specs(tree), mesh)
    with torch.device("meta"):
        model = gpt_model.GPT(gcfg, n_model)
    ckpt_lib.assign(model, tree, dev)
    params = optim.FlatParams(model)

    train_loader, eval_loader = _loaders(cfg, *datasets(cfg), mesh)
    # MultiStepLR on epoch milestones -> step milestones (reference
    # lr_scheduler_params: milestones [10, 25, 35, 50], gamma 0.5)
    steps_per_epoch = max(len(train_loader), 1)
    lsp = cfg.lr_scheduler_params or {}
    sched = optim.multistep_schedule(
        cfg.lr if isinstance(cfg.lr, float) else cfg.lr[0],
        [m * steps_per_epoch for m in lsp.get("milestones", [10, 25, 35, 50])],
        lsp.get("gamma", 0.5))
    op = cfg.optimizer_params or {"betas": [0.9, 0.96], "eps": 1e-8,
                                  "weight_decay": 1e-6}
    tx = optim.adamw_grouped(sched, betas=tuple(op["betas"]), eps=op["eps"],
                             weight_decay=op["weight_decay"],
                             max_grad_norm=cfg.max_grad_norm, params=params,
                             model_group=mesh.model_group if tp else None).init(params.flat)
    if restored is not None:
        _check_names(restored["names"], params)
        opt_state = restored["opt_state"]
        if tp:  # checkpoints hold the whole model's moments
            opt_state = dict(opt_state, **{k: params.shard(opt_state[k], mesh.rank)
                                           for k in ("mu", "nu")})
        tx.load_state_dict(opt_state)
        logger.print(f"resumed from step {step0}")
    state = gpt_stage.GPTTrainState(model, params, tx, int(step0 or 0), mesh)

    train_step, eval_step = gpt_stage.make_train_step(
        text_ce_weight=ma.gpt_loss_text_ce_weight,
        mel_ce_weight=ma.gpt_loss_mel_ce_weight,
        fix_condition_embeddings=ma.gpt_fix_condition_embeddings,
        compute_dtype=torch.bfloat16 if bf16 else None, remat=remat, attn_impl=attn_impl,
        # per-module gradient norms ride the wandb gate, like the reference's
        # wandb.watch(model) (gpt_trainer.py:48)
        grad_norms=cfg.use_wandb,
        content_dtype=torch.bfloat16 if content_bf16 else None, mesh=mesh)

    def on_epoch_end(state, epoch, step):
        # listening samples: a self-reconstruction and a cross-speaker
        # conversion (reference generate_eval_sample, gpt_trainer.py:146-170);
        # a failure is logged, the training goes on. A sharded GPT is
        # gathered first, on every rank (a collective), then rank 0 samples.
        model = state.model
        if tp:
            full = state.params.gather(state.params.flat, mesh)
        if not logger.is_main:
            return
        try:
            if tp:
                model = gpt_stage.whole_gpt(gcfg, state.params, full, dev)
            from genvc_tpu_torch.dsp.audio_io import write_wav
            from genvc_tpu_torch.train.eval_samples import generate_eval_samples

            feats = gpt_stage.prepare_features(frozen, to_device(next(iter(eval_loader)), dev))
            self_wav, cross_wav, tgt = generate_eval_samples(
                model, frozen.acoustic_dvae, feats, frozen.mel_norms,
                torch.Generator(device=dev).manual_seed(epoch))
            sample_dir = os.path.join(cfg.output_path, "eval_samples")
            os.makedirs(sample_dir, exist_ok=True)
            sr = cfg.audio.sample_rate
            write_wav(os.path.join(sample_dir, f"e{epoch}_self.wav"), self_wav, sr)
            write_wav(os.path.join(sample_dir, f"e{epoch}_cross{tgt}.wav"), cross_wav, sr)
            if logger.wandb is not None:
                logger.wandb.log({
                    "eval/self_recon": logger.wandb.Audio(self_wav, sample_rate=sr),
                    "eval/cross_speaker": logger.wandb.Audio(cross_wav, sample_rate=sr)})
        except Exception as e:
            logger.print(f"eval sample generation failed: {e!r}")

    try:
        return loop.fit(state, lambda s, b: train_step(s, b, frozen), train_loader,
                        epochs=cfg.epochs, logger=logger,
                        eval_step=lambda s, b: eval_step(s, b, frozen),
                        eval_loader=eval_loader, ckpt=ckpt, save_step=cfg.save_step,
                        print_step=cfg.print_step, to_device=lambda b: to_device(b, dev),
                        start_step=state.step, on_epoch_end=on_epoch_end,
                        max_steps=max_steps, max_eval_batches=max_eval_batches)
    finally:
        logger.close()


def run_vocoder_training(cfg: GenVCConfig, max_steps: int | None = None,
                         max_eval_batches: int | None = None, bf16_discs: bool = False,
                         device="cuda"):
    """Train the HiFi-GAN generator and its four discriminator families
    (stage 4) against the frozen GPT's latents; returns the
    final :class:`vocoder_stage.VocoderTrainState`. The generator starts from
    ``model_args.hifigan_checkpoint`` when given (kept in weight-norm form),
    else from a seeded init; ``bf16_discs`` runs the discriminator conv
    stacks in bf16 (the front ends and the losses stay f32). In a process
    group the step is data-parallel over the ranks."""
    ma = cfg.model_args
    if not ma.gpt_checkpoint:
        raise ValueError("the vocoder stage needs a frozen GPT checkpoint "
                         "(model_args.gpt_checkpoint)")
    dev = resolve_device(device)
    mesh = _data_mesh(cfg.batch_size, 1, dev)
    logger = loop.Logger(cfg.use_wandb, cfg.wandb_project, cfg.wandb_run_name,
                         cfg.output_path)
    logger.print(_device_banner(dev, mesh))
    frozen = gpt_stage.make_frozen(cfg, {
        "contentvec": ckpt_lib.load_contentvec(cfg.contentvec_model_path),
        "acoustic_dvae": ckpt_lib.load_dvae(cfg.acoustic_dvae_checkpoint),
        "content_dvae": ckpt_lib.load_dvae(cfg.content_dvae_checkpoint),
    }, ckpt_lib.load_mel_norms(ma.mel_norm_file), dev)
    gcfg = ckpt_lib.gpt_config(cfg)
    with torch.device("meta"):
        gpt = gpt_model.GPT(gcfg)
    ckpt_lib.assign(gpt, ckpt_lib.load_gpt(ma.gpt_checkpoint, gcfg.layers), dev)
    gpt.eval()

    vcfg = cfg.vocoder_config
    ckpt = loop.CheckpointManager(os.path.join(cfg.output_path, "ckpt"),
                                  cfg.save_n_checkpoints, dev)
    restored, step0 = ckpt.restore()
    gen = torch.Generator(device=dev).manual_seed(cfg.training_seed)
    with torch.device("meta"):
        generator = hifigan.Generator(vcfg, weight_norm=True)
    if restored is not None:
        gen_tree = restored["gen_params"]
    elif ma.hifigan_checkpoint:
        sd, _ = ckpt_lib.load_torch_bundle(ma.hifigan_checkpoint)
        gen_tree = ckpt_lib.convert_hifigan(ckpt_lib.strip_prefix(sd, "hifigan."), fold=False)
    else:
        gen_tree = hifigan.generator_to_weight_norm(hifigan.init_tree(gen, vcfg))
    ckpt_lib.assign(generator, gen_tree, dev)
    discs = vocoder_stage.init_discriminators(gen, vcfg)
    if restored is not None:
        ckpt_lib.assign(discs, restored["disc_params"], dev)
    gen_params, disc_params = optim.FlatParams(generator), optim.FlatParams(discs)

    train_loader, eval_loader = _loaders(cfg, *datasets(cfg), mesh)
    op = cfg.optimizer_params or {"betas": [0.8, 0.99]}
    # ExponentialLR per epoch (reference get_scheduler,
    # hifigan_trainer.py:574-591, gamma = lr_decay)
    sched = optim.exponential_epoch_schedule(
        cfg.lr if isinstance(cfg.lr, float) else cfg.lr[0], cfg.lr_decay,
        max(len(train_loader), 1))
    gen_opt, disc_opt = (optim.vocoder_adamw(sched, betas=tuple(op["betas"])).init(p.flat)
                         for p in (gen_params, disc_params))
    if restored is not None:
        _check_names(restored["gen_names"], gen_params)
        _check_names(restored["disc_names"], disc_params)
        gen_opt.load_state_dict(restored["gen_opt"])
        disc_opt.load_state_dict(restored["disc_opt"])
        logger.print(f"resumed from step {step0}")
    state = vocoder_stage.VocoderTrainState(generator, discs, gen_params, disc_params,
                                            gen_opt, disc_opt, int(step0 or 0))
    train_step, eval_step = vocoder_stage.make_train_step(
        vcfg, scale_factor=int(ma.gpt_code_stride_len // vcfg.hop_length),
        disc_dtype=torch.bfloat16 if bf16_discs else None,
        data_group=None if mesh is None else mesh.data_group)
    try:
        return loop.fit(state, lambda s, b: train_step(s, b, frozen, gpt), train_loader,
                        epochs=cfg.epochs, logger=logger,
                        eval_step=lambda s, b: eval_step(s, b, frozen, gpt),
                        eval_loader=eval_loader, ckpt=ckpt, save_step=cfg.save_step,
                        print_step=cfg.print_step, to_device=lambda b: to_device(b, dev),
                        start_step=state.step, max_steps=max_steps,
                        max_eval_batches=max_eval_batches)
    finally:
        logger.close()
