"""Train the content (ContentVec-feature) discrete VAE, stage 2, with the
PyTorch / CUDA port (the repo's ``train_content_dvae.py``; the reference
recipe: batch 64 of 6 s crops at 16 kHz through the frozen ContentVec, 256
channels, 256 tokens, codebook 512, hidden 512, Adam lr 1e-4, clip 0.5).

Usage:
    python -m genvc_tpu_torch.train_content_dvae [--device cuda] [--max_steps N]
    python -m genvc_tpu_torch.train_content_dvae --smoke --device cpu   # 2 steps on
                                                                        # synthetic data
"""

from __future__ import annotations

import argparse
import sys


def recipe_config(train_metafile, test_metafile, contentvec_model_path,
                  output_path="exp/content_dvae", batch_size=64, epochs=200, lr=1e-4,
                  use_wandb=False, num_workers=16):
    from genvc_tpu_torch.config import AudioConfig, VAEConfig

    return VAEConfig(
        audio=AudioConfig(dvae_sample_rate=16000, sample_rate=16000),
        feat_type="ContentVec", contentvec_model_path=contentvec_model_path,
        warmup_steps=1000, batch_size=batch_size, eval_batch_size=16, lr=lr,
        num_loader_workers=num_workers, max_wav_len=16000 * 6,
        train_metafile=train_metafile, test_metafile=test_metafile, epochs=epochs,
        grad_clip_norm=0.5, output_path=output_path, use_wandb=use_wandb,
        wandb_project="content_dvae", wandb_run_name="libritts", save_n_checkpoints=2,
        save_step=2000, num_channels=256, num_tokens=256, codebook_dim=512,
        hidden_dim=512, num_resnet_blocks=3, kernel_size=3, num_layers=2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train_metafile", default="metafiles/libritts/train.txt")
    ap.add_argument("--test_metafile", default="metafiles/libritts/test.txt")
    ap.add_argument("--contentvec_model_path", default="pre_trained/contentVec.pt")
    ap.add_argument("--output_path", default="exp/content_dvae")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--use_wandb", action="store_true")
    ap.add_argument("--num_workers", type=int, default=16)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--max_eval_batches", type=int, default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="2-step end-to-end smoke on synthetic data")
    ap.add_argument("--device", default=None,
                    help="default cuda:<LOCAL_RANK> (cuda:0 in one process)")
    args = ap.parse_args(argv)

    from genvc_tpu_torch.parallel import mesh as mesh_lib
    from genvc_tpu_torch.train.runner import run_vae_training

    device = mesh_lib.launch(args.device)

    cfg = recipe_config(args.train_metafile, args.test_metafile, args.contentvec_model_path,
                        output_path=args.output_path, batch_size=args.batch_size,
                        epochs=args.epochs, lr=args.lr, use_wandb=args.use_wandb,
                        num_workers=args.num_workers)
    max_steps, max_eval_batches = args.max_steps, args.max_eval_batches
    if args.smoke:
        from genvc_tpu_torch.testing_synthetic import smoke_vae_overrides

        cfg.output_path = "exp/smoke_content_dvae_torch"
        smoke_vae_overrides(cfg, "exp/smoke_assets_cdvae_torch")
        max_steps, max_eval_batches = 2, 1
    try:
        state = run_vae_training(cfg, max_steps=max_steps, max_eval_batches=max_eval_batches,
                                 device=device)
    finally:
        mesh_lib.shutdown()
    print(f"trained to step {state.step}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
