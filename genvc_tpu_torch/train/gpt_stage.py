"""GPT training stage: feature extraction by the frozen tokenizers, then the
teacher-forced step (``genvc_tpu/train/gpt_stage.py``).

The frozen ContentVec and the acoustic / content dVAEs tokenize the raw
waveform batch on the device without gradients (reference
``format_batch_on_device``, gpt_trainer.py:198-254), in full f32: one
rounding can flip a VQ code, and the codes are the training targets. The
trainable GPT then computes the weighted dual cross-entropy (text 0.01, mel
1.0) and AdamW with weight decay only on weights and clipping at 1.0 updates
it (``train.optim``).

Mixed precision as the JAX package does it: ``compute_dtype=torch.bfloat16``
runs the model on a bf16 cast of EVERY parameter of the f32 master vector
(embeddings, LayerNorms and the Perceiver too) and on bf16 ``cond_mels``;
the losses upcast the logits to f32. Gradients come back to the f32 masters
through the cast. ``torch.autocast`` is not used: its op lists keep some ops
in f32 by rules of its own.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import functional_call
from torch.profiler import record_function

from genvc_tpu_torch import checkpoint as ckpt_lib
from genvc_tpu_torch.config import GenVCConfig
from genvc_tpu_torch.dsp import mel as mel_mod
from genvc_tpu_torch.dsp.resample import resample
from genvc_tpu_torch.models import contentvec, dvae, gpt as gpt_model
from genvc_tpu_torch.train.optim import AdamW, FlatParams, global_norm


@dataclasses.dataclass
class FrozenModules:
    """The frozen feature extractors, on one device."""

    contentvec: contentvec.ContentVec
    acoustic_dvae: dvae.DVAE
    content_dvae: dvae.DVAE
    mel_norms: torch.Tensor
    style_spec: mel_mod.MelSpec
    dvae_spec: mel_mod.MelSpec
    sample_rate: int = 24000
    content_sample_rate: int = 16000
    text_frame_rate: float = 0.02
    dvae_sample_rate: int = 24000


def _dvae(tree, cfg, device):
    with torch.device("meta"):
        m = dvae.DVAE(ckpt_lib.dvae_config(cfg))
    ckpt_lib.assign(m, {"encoder": tree["encoder"],
                        "codebook": {"embed": tree["codebook"]["embed"]}}, device)
    return m.eval()


def make_frozen(cfg: GenVCConfig, tree: dict, mel_norms, device) -> FrozenModules:
    """``tree``: ``contentvec``, ``acoustic_dvae`` and ``content_dvae``
    parameter trees (the JAX package's layout)."""
    with torch.device("meta"):
        cv = contentvec.ContentVec(n_layers=ckpt_lib._n_layers(tree["contentvec"]))
    ckpt_lib.assign(cv, tree["contentvec"], device)
    return FrozenModules(
        contentvec=cv.eval(),
        acoustic_dvae=_dvae(tree["acoustic_dvae"], cfg.acoustic_dvae_config, device),
        content_dvae=_dvae(tree["content_dvae"], cfg.content_dvae_config, device),
        mel_norms=torch.as_tensor(mel_norms, dtype=torch.float32, device=device),
        style_spec=mel_mod.MelSpec(sample_rate=cfg.audio.sample_rate, n_fft=2048,
                                   win_length=1024, hop_length=256, n_mels=80,
                                   fmin=0, fmax=8000.0, scale="htk"),
        dvae_spec=mel_mod.MelSpec(sample_rate=cfg.audio.dvae_sample_rate, n_fft=1024,
                                  win_length=1024, hop_length=256, n_mels=80,
                                  fmin=0, fmax=8000.0, scale="htk"),
        sample_rate=cfg.audio.sample_rate,
        content_sample_rate=cfg.audio.content_sample_rate,
        text_frame_rate=cfg.text_frame_rate,
        dvae_sample_rate=cfg.audio.dvae_sample_rate)


@torch.no_grad()
def prepare_features(frozen: FrozenModules, batch: dict) -> dict:
    """``format_batch_on_device``: batch wav (B, 1, T) at 24 kHz,
    wav_lengths (B,), conditioning (B, 1, 1, Tc), cond_lens (B,),
    text_lengths (B,) -> cond_mels, audio_codes, text_inputs and the
    lengths."""
    wav = batch["wav"][:, 0, :]
    cond = batch["conditioning"][:, 0, 0, :]
    cond_mels = mel_mod.mel_torchaudio(cond, frozen.style_spec, frozen.mel_norms)
    if frozen.dvae_sample_rate != frozen.sample_rate:
        # the reference's kaiser filter (gpt_trainer.py:213-222)
        dvae_wav = resample(wav, frozen.sample_rate, frozen.dvae_sample_rate,
                            lowpass_filter_width=64, rolloff=0.9475937167399596,
                            beta=14.769656459379492, window="kaiser")
    else:
        dvae_wav = wav
    dvae_mel = mel_mod.mel_torchaudio(dvae_wav, frozen.dvae_spec, frozen.mel_norms)
    audio_codes = frozen.acoustic_dvae.get_codebook_indices(dvae_mel)

    content_wav = resample(wav, frozen.sample_rate, frozen.content_sample_rate)
    pad = int(frozen.text_frame_rate * frozen.content_sample_rate)
    feats = frozen.contentvec(torch.nn.functional.pad(content_wav, (0, pad)))
    text_codes = frozen.content_dvae.get_codebook_indices(feats.transpose(1, 2))
    # audio codes widened to cover code_lengths = ceil(wav / stride) + 3 (the
    # pad value 0 is replaced by stop tokens in the formatting)
    return {
        "cond_mels": cond_mels,
        "cond_lens": batch["cond_lens"],
        "audio_codes": torch.nn.functional.pad(audio_codes, (0, 4)),
        "text_inputs": text_codes,
        "text_lengths": batch["text_lengths"].long(),
        "wav_lengths": batch["wav_lengths"].long(),
    }


@dataclasses.dataclass
class GPTTrainState:
    """The trainable GPT (its parameters views of ``params.flat``), the
    optimizer and the count of steps taken."""

    model: gpt_model.GPT
    params: FlatParams
    opt: AdamW
    step: int = 0

    def state_dict(self) -> dict:
        return {"step": self.step, "params": ckpt_lib.export_tree(self.model),
                "opt_state": self.opt.state_dict(), "names": self.params.names}


def loss_fn(model, tensors, feats, text_ce_weight, mel_ce_weight,
            fix_condition_embeddings=True, attn_impl="flash"):
    """The weighted loss and the metrics, with ``tensors`` (name -> parameter)
    substituted into ``model``."""
    loss_text, loss_mel, top10, _ = functional_call(
        model, tensors,
        (feats["text_inputs"], feats["text_lengths"], feats["audio_codes"],
         feats["wav_lengths"]),
        dict(cond_mels=feats["cond_mels"], cond_lens=feats["cond_lens"],
             fix_condition_embeddings=fix_condition_embeddings, attn_impl=attn_impl))
    loss = text_ce_weight * loss_text + mel_ce_weight * loss_mel
    return loss, {"loss": loss, "loss_text_ce": loss_text, "loss_mel_ce": loss_mel,
                  "top10acc": top10}


def make_train_step(text_ce_weight: float = 0.01, mel_ce_weight: float = 1.0,
                    fix_condition_embeddings: bool = True, compute_dtype=None,
                    remat=False, attn_impl: str = "flash", grad_norms: bool = False,
                    content_dtype=None):
    """Returns (train_step, eval_step), each taking (state, batch, frozen).
    ``train_step`` updates ``state`` in place and returns it with the step's
    metrics (0-dim tensors on the device, nothing read to the host).

    ``attn_impl``: "flash" (the attention kernels: forward K4, backward K5
    and K6) or "xla" (dense-bias attention differentiated by autograd). The
    JAX package's step defaults to "xla" for a measurement on its TPU; the
    port's to the kernels. ``grad_norms`` adds per-module gradient L2 norms
    (``grad_norm/<module>``, ``grad_norm/total``). The step's phases are
    profiler spans: ``genvc.features``, ``genvc.forward``, ``genvc.backward``,
    ``genvc.optimizer``."""
    if remat:
        raise NotImplementedError("remat is not ported yet (ROADMAP A12)")
    if content_dtype is not None:
        raise NotImplementedError("a reduced-precision ContentVec (content_dtype) "
                                  "is not ported yet (ROADMAP A12)")

    def _loss(state, feats):
        tensors = state.params.tensors(compute_dtype)
        if compute_dtype is not None:
            feats = dict(feats, cond_mels=feats["cond_mels"].to(compute_dtype))
        return loss_fn(state.model, tensors, feats, text_ce_weight, mel_ce_weight,
                       fix_condition_embeddings, attn_impl)

    def train_step(state: GPTTrainState, batch: dict, frozen: FrozenModules):
        with record_function("genvc.features"):
            feats = prepare_features(frozen, batch)
        with record_function("genvc.forward"):
            loss, metrics = _loss(state, feats)
        flat = state.params.flat
        flat.grad = None
        with record_function("genvc.backward"):
            loss.backward()
        grad = flat.grad
        flat.grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
        if grad_norms:
            sq = {}
            for name, g in state.params.views(grad).items():
                mod = name.split(".")[0]
                sq[mod] = sq.get(mod, 0.0) + g.square().sum()
            for mod, v in sq.items():
                metrics[f"grad_norm/{mod}"] = v.sqrt()
            metrics["grad_norm/total"] = global_norm(grad)
        with record_function("genvc.optimizer"):
            state.opt.step(flat, grad)
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def eval_step(state: GPTTrainState, batch: dict, frozen: FrozenModules):
        _, metrics = _loss(state, prepare_features(frozen, batch))
        return metrics

    return train_step, eval_step
