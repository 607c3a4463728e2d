"""Train the HiFi-GAN vocoder, stage 4, with the PyTorch / CUDA port (the
repo's ``train_vocoder.py``; the reference recipe's hyperparameters: the
frozen GPT, fixed 8-token segments = 0.64 s, batch 64, lr 2e-4, betas
(0.8, 0.99), ExponentialLR 0.98 per epoch, all four discriminator families).

Usage:
    python -m genvc_tpu_torch.train_vocoder [--bf16_discs] [--device cuda] \
        [--gpt_checkpoint ...] [--max_steps N]
    python -m genvc_tpu_torch.train_vocoder --smoke --device cpu   # 2 steps on
                                                                   # synthetic data
"""

from __future__ import annotations

import argparse
import sys


def recipe_config(train_metafile, test_metafile, mel_norm_file, acoustic_dvae_checkpoint,
                  content_dvae_checkpoint, contentvec_model_path, gpt_checkpoint,
                  hifigan_checkpoint=None, output_path="exp/HiFiGAN_LibriTTS",
                  batch_size=64, epochs=50, lr=2e-4, use_wandb=False, num_workers=24):
    """The reference recipe's stage-4 configuration: GPT 30 layers x 1024, 4
    heads, frozen; the stage-3 tokenizers; texts of exactly 8 content tokens;
    the full-width ``VocoderConfig()``; AdamW lr 2e-4, betas (0.8, 0.99),
    torch's default weight decay 0.01, ExponentialLR 0.98."""
    from genvc_tpu_torch.config import (AudioConfig, GenVCConfig, GPTModelArgs, VAEConfig,
                                        VocoderConfig)

    acoustic_vae = VAEConfig(
        audio=AudioConfig(dvae_sample_rate=24000), mel_norm_file=mel_norm_file,
        num_channels=80, num_tokens=1024, codebook_dim=512, hidden_dim=512,
        num_resnet_blocks=3, kernel_size=3, num_layers=2)
    content_vae = VAEConfig(
        audio=AudioConfig(dvae_sample_rate=16000), mel_norm_file=mel_norm_file,
        num_channels=256, num_tokens=256, codebook_dim=512, hidden_dim=512,
        num_resnet_blocks=3, kernel_size=3, num_layers=2)
    model_args = GPTModelArgs(
        mel_norm_file=mel_norm_file, gpt_num_audio_tokens=1026,
        gpt_start_audio_token=1024, gpt_stop_audio_token=1025,
        gpt_start_text_token=256, gpt_stop_text_token=257,
        gpt_number_text_tokens=258, gpt_fix_condition_embeddings=True,
        gpt_use_masking_gt_prompt_approach=True,
        min_text_length=8, max_text_length=8,  # fixed 0.64 s segments
        gpt_n_heads=4, gpt_layers=30, gpt_checkpoint=gpt_checkpoint,
        hifigan_checkpoint=hifigan_checkpoint)
    return GenVCConfig(
        contentvec_model_path=contentvec_model_path,
        acoustic_dvae_checkpoint=acoustic_dvae_checkpoint,
        content_dvae_checkpoint=content_dvae_checkpoint,
        model_args=model_args, audio=AudioConfig(),
        content_dvae_config=content_vae, acoustic_dvae_config=acoustic_vae,
        vocoder_config=VocoderConfig(),
        batch_size=batch_size, eval_batch_size=batch_size,
        num_loader_workers=num_workers, epochs=epochs,
        print_step=50, save_step=5000, save_n_checkpoints=2,
        optimizer="AdamW", output_path=output_path,
        optimizer_wd_only_on_weights=True, lr=lr,
        optimizer_params={"betas": [0.8, 0.99], "eps": 1e-8, "weight_decay": 1e-6},
        lr_decay=0.98, weight_decay=1e-6, warmup_steps=1000, max_grad_norm=1.0,
        train_metafile=train_metafile, test_metafile=test_metafile,
        use_wandb=use_wandb, wandb_project="hifi-gan", wandb_run_name="libritts")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train_metafile", default="metafiles/libritts/train.txt")
    ap.add_argument("--test_metafile", default="metafiles/libritts/test.txt")
    ap.add_argument("--mel_norm_file", default="pre_trained/mel_stats.npy")
    ap.add_argument("--acoustic_dvae_checkpoint", default="pre_trained/acoustic_dvae.pth")
    ap.add_argument("--content_dvae_checkpoint", default="pre_trained/content_dvae.pth")
    ap.add_argument("--contentvec_model_path", default="pre_trained/contentVec.pt")
    ap.add_argument("--gpt_checkpoint", default="pre_trained/gpt.pth")
    ap.add_argument("--hifigan_checkpoint", default=None)
    ap.add_argument("--output_path", default="exp/HiFiGAN_LibriTTS")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--use_wandb", action="store_true")
    ap.add_argument("--num_workers", type=int, default=24)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--max_eval_batches", type=int, default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="2-step end-to-end smoke on synthetic data")
    ap.add_argument("--bf16_discs", action="store_true",
                    help="run the discriminator conv stacks in bfloat16 (the "
                         "spectral front ends and all losses stay f32)")
    ap.add_argument("--device", default=None,
                    help="default cuda:<LOCAL_RANK> (cuda:0 in one process)")
    args = ap.parse_args(argv)

    from genvc_tpu_torch.parallel import mesh as mesh_lib
    from genvc_tpu_torch.train.runner import run_vocoder_training

    device = mesh_lib.launch(args.device)

    cfg = recipe_config(
        args.train_metafile, args.test_metafile, args.mel_norm_file,
        args.acoustic_dvae_checkpoint, args.content_dvae_checkpoint,
        args.contentvec_model_path, args.gpt_checkpoint, args.hifigan_checkpoint,
        output_path=args.output_path, batch_size=args.batch_size, epochs=args.epochs,
        lr=args.lr, use_wandb=args.use_wandb, num_workers=args.num_workers)
    max_steps, max_eval_batches = args.max_steps, args.max_eval_batches
    if args.smoke:
        from genvc_tpu_torch.testing_synthetic import smoke_overrides

        cfg.output_path = "exp/smoke_vocoder_torch"
        smoke_overrides(cfg, "exp/smoke_assets_voc_torch", need_gpt_ckpt=True)
        max_steps, max_eval_batches = 2, 1
    try:
        state = run_vocoder_training(cfg, max_steps=max_steps, max_eval_batches=max_eval_batches,
                                     bf16_discs=args.bf16_discs, device=device)
    finally:
        mesh_lib.shutdown()
    print(f"trained to step {state.step}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
