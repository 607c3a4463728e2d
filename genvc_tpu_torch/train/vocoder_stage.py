"""Vocoder (HiFi-GAN) GAN training stage (``genvc_tpu/train/vocoder_stage.py``).

Mirrors the reference HiFiGANTrainer (trainers/hifigan_trainer.py): the frozen
GPT gives per-code latents without gradients (``format_batch_on_device``
:268-344, with the ``wav_lengths += stride // 2`` fudge :318 and the wav
trimmed or padded to ``code_len x 1024`` :332-334); then two optimizers step
in turn. The discriminators step first, on a detached prediction; the
generator then steps with feature matching + LSGAN + mel x 45 against the
*updated* discriminators (:194-262).

The JAX package's fused ``make_train_step`` and its ``make_split_steps``
compute the same step (the split is an XLA compile-size workaround); this is
the step's math, in eager PyTorch. Both networks' parameters are views of one
flat f32 vector each (``train.optim.FlatParams``), so AdamW decays every
parameter, those of a family left out by ``families`` too, as optax does
with their zero gradients. The spectral-norm buffers are not parameters:
the forwards of both phases advance them and no optimizer touches them
(``merge_sn_buffers`` in the JAX package).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import functional_call

from genvc_tpu_torch import checkpoint as ckpt_lib, tracing
from genvc_tpu_torch.config import VocoderConfig
from genvc_tpu_torch.models import gpt as gpt_model, hifigan
from genvc_tpu_torch.ops.conv import linear_interp_x4, reset_convs
from genvc_tpu_torch.parallel import collectives
from genvc_tpu_torch.train import losses
from genvc_tpu_torch.train.gpt_stage import FrozenModules, prepare_features
from genvc_tpu_torch.train.optim import AdamW, FlatParams



@dataclasses.dataclass
class VocoderTrainState:
    """The generator (weight-norm form) and the discriminators, each with its
    flat parameter vector and optimizer, and the count of steps taken."""

    generator: hifigan.Generator
    discriminators: hifigan.Discriminators
    gen_params: FlatParams
    disc_params: FlatParams
    gen_opt: AdamW
    disc_opt: AdamW
    step: int = 0

    def state_dict(self) -> dict:
        return {"step": self.step,
                "gen_params": ckpt_lib.export_tree(self.generator),
                "disc_params": ckpt_lib.export_tree(self.discriminators),
                "gen_opt": self.gen_opt.state_dict(), "disc_opt": self.disc_opt.state_dict(),
                "gen_names": self.gen_params.names, "disc_names": self.disc_params.names}


def init_discriminators(gen: torch.Generator, cfg: VocoderConfig):
    """The four discriminator families on ``gen``'s device, drawn from it."""
    with torch.device(gen.device):
        return reset_convs(hifigan.Discriminators(cfg), gen)


@torch.no_grad()
def prepare_vocoder_batch(frozen: FrozenModules, gpt: gpt_model.GPT, batch: dict):
    """``format_batch_on_device`` of the vocoder stage: the frozen GPT's
    latents (B, audio_code_len, D) in f32 and the wav (B, 1, audio_code_len
    x code_stride_len)."""
    cfg = gpt.cfg
    feats = prepare_features(frozen, batch)
    wav_lengths = feats["wav_lengths"] + cfg.code_stride_len // 2  # :318
    cond_mels = feats["cond_mels"]
    fl = feats["cond_lens"] // cfg.perceiver_cond_length_compression
    frame_valid = torch.arange(cond_mels.shape[-1], device=cond_mels.device)[None, :] < fl[:, None]
    cond_latents = gpt_model.get_style_emb(gpt, cond_mels.to(gpt.compute_dtype), frame_valid)
    latents = gpt_model.forward_latent(gpt, feats["text_inputs"], feats["text_lengths"],
                                       feats["audio_codes"], wav_lengths, cond_latents)
    audio_code_len = feats["audio_codes"].shape[1] - 4  # the width before the pad of 4
    wav_expected = audio_code_len * cfg.code_stride_len
    wav = batch["wav"][:, 0, :]
    if wav.shape[-1] < wav_expected:
        wav = torch.nn.functional.pad(wav, (0, wav_expected - wav.shape[-1]))
    return latents[:, :audio_code_len].float(), wav[:, None, :wav_expected]


def make_train_step(voc_cfg: VocoderConfig, scale_factor: int = 4, disc_dtype=None,
                    families=None, data_group=None):
    """Returns (train_step, eval_step), each taking (state, batch, frozen,
    gpt). ``train_step`` updates ``state`` in place and returns it with the
    metrics ``loss_disc``, ``loss_gen`` and ``mel_loss`` (0-dim tensors on the
    device). ``disc_dtype`` (bf16) runs the discriminator conv stacks in that
    dtype; ``families`` restricts the discriminator set (default: all four,
    the reference recipe). Profiler spans: ``genvc.vocoder_batch``,
    ``genvc.disc_step``, ``genvc.gen_step``.

    ``data_group``: data parallelism, each rank with its rows of the batch.
    Both optimizers' flat gradients and the metrics are averaged over the
    group (the losses are means over equal shares of rows). The
    spectral-norm buffers need no collective: the power iteration reads
    only the weights, which stay equal on every rank."""

    families = hifigan.ALL_FAMILIES if families is None else tuple(families)
    if not families or not set(families) <= set(hifigan.ALL_FAMILIES):
        raise ValueError(f"families must name some of {hifigan.ALL_FAMILIES}: {families}")

    def render(generator, latents, tensors=None):
        x = linear_interp_x4(latents.transpose(1, 2), scale_factor)
        if tensors is None:
            return generator(x)
        return functional_call(generator, tensors, (x,))

    def disc_loss(outs):
        return sum(losses.discriminator_loss(lr, lg) for lr, lg, _, _ in outs.values())

    def train_step(state: VocoderTrainState, batch: dict, frozen: FrozenModules,
                   gpt: gpt_model.GPT):
        with tracing.span("genvc.vocoder_batch"):
            latents, wav_gt = prepare_vocoder_batch(frozen, gpt, batch)
        discs = state.discriminators
        with tracing.span("genvc.disc_step"):
            # 1) the discriminators, on a detached prediction
            with torch.no_grad():
                y_hat = render(state.generator, latents)
            outs = functional_call(discs, state.disc_params.tensors(), (wav_gt, y_hat),
                                   dict(compute_dtype=disc_dtype, sn_update=True,
                                        families=families))
            d_loss = disc_loss(outs)
            _step(state.disc_params, state.disc_opt, d_loss, data_group)
        with tracing.span("genvc.gen_step"):
            # 2) the generator, against the updated discriminators (their
            # parameters are detached views: the gradient reaches y_hat only)
            y_hat = render(state.generator, latents, state.gen_params.tensors())
            outs = discs(wav_gt, y_hat, disc_dtype, True, families)
            g_loss = sum(losses.feature_loss(fr, fg) + losses.generator_adv_loss(lg)
                         for _, lg, fr, fg in outs.values())
            ml = losses.mel_loss(wav_gt[:, 0, :], y_hat[:, 0, :], voc_cfg)
            g_loss = g_loss + ml
            _step(state.gen_params, state.gen_opt, g_loss, data_group)
        state.step += 1
        return state, collectives.all_reduce_values(
            {"loss_disc": d_loss.detach(), "loss_gen": g_loss.detach(),
             "mel_loss": ml.detach()}, data_group, "mean")

    @torch.no_grad()
    def eval_step(state: VocoderTrainState, batch: dict, frozen: FrozenModules,
                  gpt: gpt_model.GPT):
        latents, wav_gt = prepare_vocoder_batch(frozen, gpt, batch)
        y_hat = render(state.generator, latents)
        # eval forwards keep the stored power-iteration buffers (torch eval)
        outs = state.discriminators(wav_gt, y_hat, disc_dtype, False, families)
        return collectives.all_reduce_values(
            {"loss_disc": disc_loss(outs),
             "mel_loss": losses.mel_loss(wav_gt[:, 0, :], y_hat[:, 0, :], voc_cfg)},
            data_group, "mean")

    return train_step, eval_step


def _step(params: FlatParams, opt: AdamW, loss, data_group=None):
    flat = params.flat
    flat.grad = None
    loss.backward()
    grad = flat.grad
    flat.grad = None
    collectives.all_reduce(grad, data_group, "mean")
    opt.step(flat, grad)
