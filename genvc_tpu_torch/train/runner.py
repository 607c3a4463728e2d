"""Stage runner of the GPT training stage (``genvc_tpu/train/runner.py``
``run_gpt_training``): frozen modules from the stage checkpoints, the
trainable GPT, the data, the optimizer and the loop, on one card."""

from __future__ import annotations

import os

import numpy as np
import torch

from genvc_tpu_torch import checkpoint as ckpt_lib
from genvc_tpu_torch import resolve_device
from genvc_tpu_torch.config import GenVCConfig
from genvc_tpu_torch.data.dataset import VCDatasetConfig, VCWaveDataset
from genvc_tpu_torch.data.loader import BatchLoader
from genvc_tpu_torch.models import gpt as gpt_model
from genvc_tpu_torch.train import gpt_stage, loop, optim


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


def run_gpt_training(cfg: GenVCConfig, max_steps: int | None = None,
                     max_eval_batches: int | None = None, n_model: int = 1,
                     bf16: bool = False, remat=False, content_bf16: bool = False,
                     attn_impl: str = "flash", device="cuda"):
    """Train the GPT (stage 3) on one device; returns the final
    :class:`gpt_stage.GPTTrainState`.

    bf16=True runs the trainable GPT in bfloat16 on f32 masters (the frozen
    tokenizers stay f32). ``attn_impl="flash"`` (default) runs the attention
    kernels, forward and backward; "xla" the dense path under autograd.
    Tensor parallelism (``n_model > 1``), remat and a bf16 ContentVec are not
    ported and raise."""
    if n_model > 1:
        raise NotImplementedError("tensor parallelism (n_model > 1) is not ported "
                                  "yet (ROADMAP A13)")
    if remat:
        raise NotImplementedError("remat is not ported yet (ROADMAP A12)")
    if content_bf16:
        raise NotImplementedError("content_bf16 is not ported yet (ROADMAP A12)")
    dev = resolve_device(device)
    logger = loop.Logger(cfg.use_wandb, cfg.wandb_project, cfg.wandb_run_name,
                         cfg.output_path)
    logger.print(f"device: {dev}"
                 + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))

    ma = cfg.model_args
    frozen = gpt_stage.make_frozen(cfg, {
        "contentvec": ckpt_lib.load_contentvec(cfg.contentvec_model_path),
        "acoustic_dvae": ckpt_lib.load_dvae(cfg.acoustic_dvae_checkpoint),
        "content_dvae": ckpt_lib.load_dvae(cfg.content_dvae_checkpoint),
    }, ckpt_lib.load_mel_norms(ma.mel_norm_file), dev)

    gcfg = ckpt_lib.gpt_config(cfg)
    if ma.gpt_checkpoint:
        tree = ckpt_lib.load_gpt(ma.gpt_checkpoint, gcfg.layers)
    else:
        gen = torch.Generator(device=dev).manual_seed(cfg.training_seed)
        tree = gpt_model.init_tree(gen, gcfg)
    ckpt = loop.CheckpointManager(os.path.join(cfg.output_path, "ckpt"),
                                  cfg.save_n_checkpoints)
    restored, step0 = ckpt.restore()
    if restored is not None:
        tree = restored["params"]
    with torch.device("meta"):
        model = gpt_model.GPT(gcfg)
    ckpt_lib.assign(model, tree, dev)
    params = optim.FlatParams(model)

    train_ds, eval_ds = datasets(cfg)
    train_loader = BatchLoader(train_ds, cfg.batch_size, num_workers=cfg.num_loader_workers)
    eval_loader = BatchLoader(eval_ds, cfg.eval_batch_size, shuffle=False,
                              num_workers=cfg.num_loader_workers)
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
                             max_grad_norm=cfg.max_grad_norm, params=params).init(params.flat)
    if restored is not None:
        if restored["names"] != params.names:
            raise ValueError("checkpoint parameter layout differs from the model's")
        tx.load_state_dict(restored["opt_state"])
        logger.print(f"resumed from step {step0}")
    state = gpt_stage.GPTTrainState(model, params, tx, int(step0 or 0))

    train_step, eval_step = gpt_stage.make_train_step(
        text_ce_weight=ma.gpt_loss_text_ce_weight,
        mel_ce_weight=ma.gpt_loss_mel_ce_weight,
        fix_condition_embeddings=ma.gpt_fix_condition_embeddings,
        compute_dtype=torch.bfloat16 if bf16 else None, attn_impl=attn_impl,
        # per-module gradient norms ride the wandb gate, like the reference's
        # wandb.watch(model) (gpt_trainer.py:48)
        grad_norms=cfg.use_wandb)
    try:
        return loop.fit(state, lambda s, b: train_step(s, b, frozen), train_loader,
                        epochs=cfg.epochs, logger=logger,
                        eval_step=lambda s, b: eval_step(s, b, frozen),
                        eval_loader=eval_loader, ckpt=ckpt, save_step=cfg.save_step,
                        print_step=cfg.print_step, to_device=lambda b: to_device(b, dev),
                        start_step=state.step, max_steps=max_steps,
                        max_eval_batches=max_eval_batches)
    finally:
        logger.close()
