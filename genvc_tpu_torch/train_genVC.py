"""Train the GenVC GPT decoder, stage 3, with the PyTorch / CUDA port
(the repo's ``train_genVC.py``; the reference recipe's hyperparameters).

Usage:
    python -m genvc_tpu_torch.train_genVC [--bf16] [--remat 1|dots] \
        [--content_bf16] [--device cuda] [--train_metafile ...] [--max_steps N]
    python -m genvc_tpu_torch.train_genVC --smoke --device cpu   # 2 steps on
                                                                 # synthetic data
    torchrun --nproc_per_node N -m genvc_tpu_torch.train_genVC [--n_model M]

Under ``torchrun`` each rank trains on ``cuda:<LOCAL_RANK>`` (NCCL with a
card per rank, gloo when ranks share one): data-parallel over N / M groups,
the GPT sharded Megatron-style over each group of M ranks (``--n_model``).
``--n_model`` > 1 in a world it does not divide (one process included)
exits with code 2. The other training stages have their own CLIs:
``train_audio_dvae`` and ``train_content_dvae`` (stages 1-2) and
``train_vocoder`` (stage 4).
"""

from __future__ import annotations

import argparse
import os
import sys


def recipe_config(train_metafile, test_metafile, mel_norm_file,
                  acoustic_dvae_checkpoint, content_dvae_checkpoint,
                  contentvec_model_path, gpt_checkpoint=None,
                  output_path="exp/genVC_contentVec_LibriTTS", batch_size=24,
                  epochs=100, lr=1e-4, use_wandb=False, num_workers=24):
    """The reference recipe's stage-3 configuration (GPT 30 layers x 1024, 4
    heads; acoustic dVAE 80 ch / 1024 tokens and content dVAE 256 ch / 256
    tokens, codebook 512, hidden 512; AdamW lr 1e-4, betas (0.9, 0.96),
    weight decay 1e-6 on weights, clip 1.0, MultiStepLR [10, 25, 35, 50] x
    0.5; texts of 15-100 content tokens)."""
    from genvc_tpu_torch.config import AudioConfig, GenVCConfig, GPTModelArgs, VAEConfig

    acoustic_vae = VAEConfig(
        audio=AudioConfig(dvae_sample_rate=24000),
        mel_norm_file=mel_norm_file, num_channels=80, num_tokens=1024,
        codebook_dim=512, hidden_dim=512, num_resnet_blocks=3, kernel_size=3,
        num_layers=2)
    content_vae = VAEConfig(
        audio=AudioConfig(dvae_sample_rate=16000),
        mel_norm_file=mel_norm_file, num_channels=256, num_tokens=256,
        codebook_dim=512, hidden_dim=512, num_resnet_blocks=3, kernel_size=3,
        num_layers=2)
    model_args = GPTModelArgs(
        mel_norm_file=mel_norm_file, gpt_num_audio_tokens=1026,
        gpt_start_audio_token=1024, gpt_stop_audio_token=1025,
        gpt_start_text_token=256, gpt_stop_text_token=257,
        gpt_number_text_tokens=258, gpt_fix_condition_embeddings=True,
        gpt_use_masking_gt_prompt_approach=True, min_text_length=15,
        max_text_length=100, gpt_n_heads=4, gpt_layers=30,
        gpt_checkpoint=gpt_checkpoint)
    return GenVCConfig(
        contentvec_model_path=contentvec_model_path,
        acoustic_dvae_checkpoint=acoustic_dvae_checkpoint,
        content_dvae_checkpoint=content_dvae_checkpoint,
        model_args=model_args, audio=AudioConfig(),
        content_dvae_config=content_vae, acoustic_dvae_config=acoustic_vae,
        batch_size=batch_size, eval_batch_size=batch_size,
        num_loader_workers=num_workers, epochs=epochs,
        print_step=50, save_step=5000, save_n_checkpoints=2,
        optimizer="AdamW", output_path=output_path,
        optimizer_wd_only_on_weights=True, lr=lr,
        optimizer_params={"betas": [0.9, 0.96], "eps": 1e-8, "weight_decay": 1e-6},
        lr_scheduler="MultiStepLR",
        lr_scheduler_params={"milestones": [10, 25, 35, 50], "gamma": 0.5},
        weight_decay=1e-6, warmup_steps=4000, max_grad_norm=1.0,
        train_metafile=train_metafile, test_metafile=test_metafile,
        use_wandb=use_wandb, wandb_project="genVC", wandb_run_name="libritts")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train_metafile", default="metafiles/libritts/train.txt")
    ap.add_argument("--test_metafile", default="metafiles/libritts/test.txt")
    ap.add_argument("--mel_norm_file", default="pre_trained/mel_stats.npy")
    ap.add_argument("--acoustic_dvae_checkpoint", default="pre_trained/acoustic_dvae.pth")
    ap.add_argument("--content_dvae_checkpoint", default="pre_trained/content_dvae.pth")
    ap.add_argument("--contentvec_model_path", default="pre_trained/contentVec.pt")
    ap.add_argument("--gpt_checkpoint", default=None)
    ap.add_argument("--output_path", default="exp/genVC_contentVec_LibriTTS")
    ap.add_argument("--batch_size", type=int, default=24)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--use_wandb", action="store_true")
    ap.add_argument("--num_workers", type=int, default=24)
    ap.add_argument("--n_model", type=int, default=1,
                    help="tensor-parallel size: ranks per model group (under torchrun)")
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--max_eval_batches", type=int, default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="2-step end-to-end smoke on synthetic data")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute on the trainable GPT "
                         "(f32 master params; frozen tokenizers stay f32)")
    ap.add_argument("--remat", default="0", choices=["0", "1", "dots"],
                    help="activation checkpointing of the GPT's blocks: 1 = whole "
                         "blocks, dots = keep the weight products")
    ap.add_argument("--content_bf16", action="store_true",
                    help="bf16 frozen ContentVec (its features go to the content "
                         "dVAE in f32; the acoustic labels stay f32)")
    ap.add_argument("--device", default=None,
                    help="default cuda:<LOCAL_RANK> (cuda:0 in one process)")
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", 1))
    if args.n_model < 1 or world % args.n_model:
        print(f"--n_model {args.n_model} needs a world of a multiple of {args.n_model} "
              f"ranks, this one has {world}: launch with torchrun --nproc_per_node N "
              f"-m genvc_tpu_torch.train_genVC --n_model {args.n_model}", file=sys.stderr)
        return 2

    from genvc_tpu_torch.parallel import mesh as mesh_lib
    from genvc_tpu_torch.train.runner import run_gpt_training

    device = mesh_lib.launch(args.device)

    cfg = recipe_config(
        train_metafile=args.train_metafile, test_metafile=args.test_metafile,
        mel_norm_file=args.mel_norm_file,
        acoustic_dvae_checkpoint=args.acoustic_dvae_checkpoint,
        content_dvae_checkpoint=args.content_dvae_checkpoint,
        contentvec_model_path=args.contentvec_model_path,
        gpt_checkpoint=args.gpt_checkpoint, output_path=args.output_path,
        batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
        use_wandb=args.use_wandb, num_workers=args.num_workers)
    max_steps, max_eval_batches = args.max_steps, args.max_eval_batches
    if args.smoke:
        from genvc_tpu_torch.testing_synthetic import smoke_overrides

        cfg.output_path = "exp/smoke_gpt_torch"
        smoke_overrides(cfg, "exp/smoke_assets_torch")
        max_steps, max_eval_batches = 2, 1
    try:
        state = run_gpt_training(cfg, max_steps=max_steps, max_eval_batches=max_eval_batches,
                                 bf16=args.bf16,
                                 remat={"0": False, "1": True, "dots": "dots"}[args.remat],
                                 content_bf16=args.content_bf16, n_model=args.n_model,
                                 device=device)
    finally:
        mesh_lib.shutdown()
    print(f"trained to step {state.step}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
