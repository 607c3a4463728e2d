"""GAN criteria and the mel reconstruction loss of the vocoder stage
(``genvc_tpu/train/losses.py``; reference layers/hifigan_loss.py). The
discriminator stacks may run in bf16; every loss accumulates in f32."""

from __future__ import annotations

from genvc_tpu_torch.config import VocoderConfig
from genvc_tpu_torch.dsp import mel as mel_mod


def feature_loss(fmap_r, fmap_g):
    """L1 feature matching x 2 (hifigan_loss.py:78-90)."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + (rl.float() - gl.float()).abs().mean()
    return loss * 2.0


def discriminator_loss(real_logits, fake_logits):
    """LSGAN discriminator loss (hifigan_loss.py:92-108)."""
    loss = 0.0
    for dr, dg in zip(real_logits, fake_logits):
        loss = loss + (1.0 - dr.float()).square().mean() + dg.float().square().mean()
    return loss


def generator_adv_loss(fake_logits):
    """LSGAN generator loss (hifigan_loss.py:110-123)."""
    loss = 0.0
    for dg in fake_logits:
        loss = loss + (1.0 - dg.float()).square().mean()
    return loss


def mel_loss(y_gt, y_pred, cfg: VocoderConfig):
    """L1 x 45 on librosa-mel STFT features, center=False
    (hifigan_loss.py:125-141 with extract_mel_features :16-75)."""
    spec = mel_mod.MelSpec(sample_rate=cfg.sample_rate, n_fft=cfg.fft_size,
                           win_length=cfg.win_length, hop_length=cfg.hop_length,
                           n_mels=cfg.num_mels, fmin=cfg.mel_fmin, fmax=cfg.mel_fmax,
                           scale="slaney")
    gt = mel_mod.mel_vocoder_loss(y_gt, spec)
    pred = mel_mod.mel_vocoder_loss(y_pred, spec)
    return (gt - pred).abs().mean() * 45.0
