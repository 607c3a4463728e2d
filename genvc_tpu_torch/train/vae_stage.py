"""dVAE training stage, audio and content tokenizers
(``genvc_tpu/train/vae_stage.py``).

Mirrors the reference VAE_Trainer (trainers/VAE_trainer.py): features are the
mel (audio dVAE) or ContentVec features (content dVAE), chosen by
``feat_type`` (:46-53), their length trimmed to a multiple of 4 (:91-94);
the loss is reconstruction + commitment; gradients are clipped at 0.5 and
Adam steps (:98-116, :244-247). The codebook takes the EMA value of the
step's forward after the update, never a gradient step.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import functional_call

from genvc_tpu_torch import checkpoint as ckpt_lib
from genvc_tpu_torch.config import VAEConfig
from genvc_tpu_torch.dsp import mel as mel_mod
from genvc_tpu_torch.models import dvae
from genvc_tpu_torch.parallel import collectives
from genvc_tpu_torch.train.optim import AdamW, FlatParams


@dataclasses.dataclass
class VAETrainState:
    """The trainable dVAE (its parameters views of ``params.flat``, its
    codebook in buffers), the optimizer and the count of steps taken."""

    model: dvae.DVAE
    params: FlatParams
    opt: AdamW
    step: int = 0

    def state_dict(self) -> dict:
        return {"step": self.step, "params": ckpt_lib.export_tree(self.model),
                "opt_state": self.opt.state_dict(), "names": self.params.names}


def _trim4(m):
    return m[:, :, : m.shape[-1] - m.shape[-1] % 4]


def make_feature_fn(config: VAEConfig):
    """Returns feat_fn(feat_params, wav (B, 1, T)) -> (B, C, T') features:
    ``feat_params`` is the mel norms (Mel type) or the frozen ContentVec
    module."""
    if config.feat_type == "Mel-spectrogram":
        spec = mel_mod.MelSpec(
            sample_rate=config.audio.sample_rate, n_fft=1024, win_length=1024,
            hop_length=256, n_mels=80, fmin=0, fmax=8000.0, scale="htk")

        def feat_fn(feat_params, wav):
            return _trim4(mel_mod.mel_torchaudio(wav[:, 0, :], spec, feat_params))

    elif config.feat_type == "ContentVec":
        def feat_fn(feat_params, wav):
            return _trim4(feat_params(wav[:, 0, :]).transpose(1, 2))

    elif config.feat_type == "W2V2_BERT":
        # mHuBERT-style conv-extractor-only features (reference
        # MultiLingualContentExtractor, content_processor.py:36-52)
        def feat_fn(feat_params, wav):
            return _trim4(feat_params.feature_extractor_forward(wav[:, 0, :]).transpose(1, 2))

    else:
        raise ValueError(f"unknown feat_type {config.feat_type}")
    return feat_fn


def make_train_step(feat_fn, data_group=None):
    """Returns (train_step, eval_step), each taking (state, batch,
    feat_params). ``train_step`` updates ``state`` in place and returns it
    with the step's metrics (0-dim tensors on the device).

    ``data_group``: data parallelism, each rank with its rows of the batch.
    The codebook statistics are all-reduced in the forward (``dvae``), the
    flat gradient and the metrics are averaged over the group (one
    all-reduce each): the losses are means over equal shares of rows."""


    def train_step(state: VAETrainState, batch: dict, feat_params=None):
        with torch.no_grad():
            feat = feat_fn(feat_params, batch["wav"])
        recon, commit, _, new_cb, _ = functional_call(
            state.model, state.params.tensors(), (feat,), {"data_group": data_group})
        loss = recon + commit
        flat = state.params.flat
        flat.grad = None
        loss.backward()
        grad = flat.grad
        flat.grad = None
        collectives.all_reduce(grad, data_group, "mean")
        state.opt.step(flat, grad)
        for k, v in new_cb.items():
            setattr(state.model.codebook, k, v)
        state.step += 1
        return state, collectives.all_reduce_values(
            {"loss": loss.detach(), "recon_loss": recon.detach(),
             "commitment_loss": commit.detach()}, data_group, "mean")

    @torch.no_grad()
    def eval_step(state: VAETrainState, batch: dict, feat_params=None):
        recon, commit, _, _, _ = state.model.forward_train(feat_fn(feat_params, batch["wav"]))
        return collectives.all_reduce_values(
            {"loss": recon + commit, "recon_loss": recon, "commitment_loss": commit},
            data_group, "mean")

    return train_step, eval_step


def make_optimizer(config: VAEConfig, params: FlatParams) -> AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip_norm), adam(lr, betas))``:
    no weight decay, eps 1e-8."""
    return AdamW(config.lr, tuple(config.opt_betas), 1e-8, 0.0,
                 config.grad_clip_norm).init(params.flat)
