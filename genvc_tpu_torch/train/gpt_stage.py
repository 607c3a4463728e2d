"""GPT training stage: feature extraction by the frozen tokenizers, then the
teacher-forced step (``genvc_tpu/train/gpt_stage.py``).

The frozen ContentVec and the acoustic / content dVAEs tokenize the raw
waveform batch on the device without gradients (reference
``format_batch_on_device``, gpt_trainer.py:198-254), in full f32 by default:
one rounding can flip a VQ code, and the codes are the training targets
(``content_dtype`` opts the ContentVec into bf16). The
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

from genvc_tpu_torch import checkpoint as ckpt_lib, tracing
from genvc_tpu_torch.config import GenVCConfig
from genvc_tpu_torch.dsp import mel as mel_mod
from genvc_tpu_torch.dsp.resample import resample
from genvc_tpu_torch.models import contentvec, dvae, gpt as gpt_model
from genvc_tpu_torch.parallel import collectives
from genvc_tpu_torch.parallel import mesh as mesh_lib
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
    """A frozen dVAE; it keeps the tree's decoder where the tree has one (the
    acoustic dVAE decodes the listening samples' codes)."""
    keep = {"encoder": tree["encoder"], "codebook": {"embed": tree["codebook"]["embed"]}}
    if "decoder" in tree:
        keep["decoder"] = tree["decoder"]
    with torch.device("meta"):
        m = dvae.DVAE(ckpt_lib.dvae_config(cfg), decoder="decoder" in keep)
    ckpt_lib.assign(m, keep, device)
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
def prepare_features(frozen: FrozenModules, batch: dict, content_dtype=None) -> dict:
    """``format_batch_on_device``: batch wav (B, 1, T) at 24 kHz,
    wav_lengths (B,), conditioning (B, 1, 1, Tc), cond_lens (B,),
    text_lengths (B,) -> cond_mels, audio_codes, text_inputs and the
    lengths.

    ``content_dtype=torch.bfloat16`` runs the whole ContentVec in bf16 (an
    opt-in speed knob); its features are upcast to f32 before the content
    dVAE, whose VQ argmin runs in f32. The acoustic path, whose codes are the
    training labels, stays f32."""
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
    feats = frozen.contentvec(torch.nn.functional.pad(content_wav, (0, pad)),
                              compute_dtype=content_dtype)
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
    optimizer and the count of steps taken; ``mesh`` when the step runs on a
    ``(data, model)`` mesh."""

    model: gpt_model.GPT
    params: FlatParams
    opt: AdamW
    step: int = 0
    mesh: mesh_lib.Mesh | None = None

    def state_dict(self) -> dict:
        """The whole model's state in the single-card layout: under tensor
        parallelism the flat parameters and moments are gathered over the
        model group (every rank must call it), so a checkpoint resumes at
        any ``n_model``."""
        model, opt = self.model, self.opt.state_dict()
        if self.mesh is not None and self.mesh.n_model > 1:
            model = whole_gpt(model.cfg, self.params,
                              self.params.gather(self.params.flat, self.mesh))
            opt = dict(opt, mu=self.params.gather(opt["mu"], self.mesh),
                       nu=self.params.gather(opt["nu"], self.mesh))
        return {"step": self.step, "params": ckpt_lib.export_tree(model), "opt_state": opt,
                "names": self.params.names}


def whole_gpt(cfg, params: FlatParams, full, device="cpu") -> gpt_model.GPT:
    """The single-card GPT of ``cfg`` whose parameters are the whole
    model's flat vector ``full`` (``params.gather`` of a tensor-parallel
    GPT), on ``device``."""
    with torch.device("meta"):
        model = gpt_model.GPT(cfg)
    for name, t in params.whole_views(full).items():
        mod_name, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(mod_name), leaf,
                torch.nn.Parameter(t.to(device), requires_grad=False))
    return model


def loss_fn(model, tensors, feats, text_ce_weight, mel_ce_weight,
            fix_condition_embeddings=True, attn_impl="flash", remat=False, mesh=None):
    """The weighted loss and the metrics, with ``tensors`` (name -> parameter)
    substituted into ``model``. On a ``mesh`` they are this rank's shares
    of the global batch's (``gpt.forward_train``'s ``data_group``)."""
    groups = {} if mesh is None else dict(model_group=mesh.model_group,
                                          data_group=mesh.data_group)
    loss_text, loss_mel, top10, _ = functional_call(
        model, tensors,
        (feats["text_inputs"], feats["text_lengths"], feats["audio_codes"],
         feats["wav_lengths"]),
        dict(cond_mels=feats["cond_mels"], cond_lens=feats["cond_lens"],
             fix_condition_embeddings=fix_condition_embeddings, attn_impl=attn_impl,
             remat=remat, **groups))
    loss = text_ce_weight * loss_text + mel_ce_weight * loss_mel
    return loss, {"loss": loss, "loss_text_ce": loss_text, "loss_mel_ce": loss_mel,
                  "top10acc": top10}


def make_train_step(text_ce_weight: float = 0.01, mel_ce_weight: float = 1.0,
                    fix_condition_embeddings: bool = True, compute_dtype=None,
                    remat=False, attn_impl: str = "flash", grad_norms: bool = False,
                    content_dtype=None, mesh: mesh_lib.Mesh | None = None):
    """Returns (train_step, eval_step), each taking (state, batch, frozen).
    ``train_step`` updates ``state`` in place and returns it with the step's
    metrics (0-dim tensors on the device, nothing read to the host).

    ``attn_impl``: "flash" (the attention kernels: forward K4, backward K5
    and K6) or "xla" (dense-bias attention differentiated by autograd). The
    JAX package's step defaults to "xla" for a measurement on its TPU; the
    port's to the kernels. ``remat`` (True or "dots") checkpoints the GPT's
    blocks (``gpt.core_forward``): the same loss and gradients, less
    activation memory, the attention forward run again in the backward.
    ``content_dtype`` as :func:`prepare_features`. ``grad_norms`` adds
    per-module gradient L2 norms (``grad_norm/<module>``,
    ``grad_norm/total``). The step's phases are profiler spans:
    ``genvc.features``, ``genvc.forward``, ``genvc.backward``,
    ``genvc.optimizer`` (``tracing`` spans, with the step's count as their
    request id).

    ``mesh``: each rank's batch is its rows of the global batch (the same
    rows on every rank of a model group) and its GPT the rank's shards. The
    losses are the global batch's (the shares of ``loss_fn`` summed), the
    flat gradient is summed over the data group in one all-reduce (span
    ``genvc.grad_all_reduce``), the metrics likewise in one, and the clip and
    the gradient norms count the whole model (the optimizer's ``norm``)."""
    data_group = None if mesh is None else mesh.data_group
    model_group = None if mesh is None else mesh.model_group

    def _loss(state, feats):
        tensors = state.params.tensors(compute_dtype)
        if compute_dtype is not None:
            feats = dict(feats, cond_mels=feats["cond_mels"].to(compute_dtype))
        return loss_fn(state.model, tensors, feats, text_ce_weight, mel_ce_weight,
                       fix_condition_embeddings, attn_impl, remat, mesh)


    def train_step(state: GPTTrainState, batch: dict, frozen: FrozenModules):
        step = state.step
        with tracing.span("genvc.features", step):
            feats = prepare_features(frozen, batch, content_dtype)
        with tracing.span("genvc.forward", step):
            loss, metrics = _loss(state, feats)
        flat = state.params.flat
        flat.grad = None
        with tracing.span("genvc.backward", step):
            loss.backward()
        grad = flat.grad
        flat.grad = None
        if data_group is not None:
            with tracing.span("genvc.grad_all_reduce", step):
                collectives.all_reduce(grad, data_group)
        metrics = collectives.all_reduce_values({k: v.detach() for k, v in metrics.items()},
                                                data_group)
        if grad_norms:
            metrics.update(_grad_norms(state.params, grad, model_group))
        with tracing.span("genvc.optimizer", step):
            state.opt.step(flat, grad)
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def eval_step(state: GPTTrainState, batch: dict, frozen: FrozenModules):
        _, metrics = _loss(state, prepare_features(frozen, batch, content_dtype))
        return collectives.all_reduce_values(metrics, data_group)

    return train_step, eval_step


def _grad_norms(params: FlatParams, grad, model_group=None) -> dict:
    """Per-module gradient L2 norms (``grad_norm/<module>``) and the total,
    of the whole model: a sharded segment's squares summed over the model
    group (one all-reduce for all modules), a replicated one's counted
    once."""
    sq_sh, sq_rep = {}, {}
    for (name, g), sh in zip(params.views(grad).items(), params.sharded):
        mod = name.split(".")[0]
        acc = sq_sh if sh else sq_rep
        acc[mod] = acc.get(mod, 0.0) + g.square().sum()
        sq_rep.setdefault(mod, 0.0)
    if sq_sh:
        mods = list(sq_sh)
        summed = collectives.all_reduce(torch.stack([sq_sh[m] for m in mods]), model_group)
        for m, v in zip(mods, summed):
            sq_rep[m] = sq_rep[m] + v
    out = {f"grad_norm/{mod}": v.sqrt() for mod, v in sq_rep.items()}
    out["grad_norm/total"] = global_norm(grad, params, model_group)
    return out
