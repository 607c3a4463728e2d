"""GPT-2 decoder backbone for content tokens -> audio codes
(``genvc_tpu/models/gpt.py``): inference (prefix, latent pass) and the
teacher-forced training forward with its losses.

Pre-LN GPT-2 blocks (gelu_new MLP), learned per-modality positional tables,
text/mel embeddings and heads, a shared ``final_norm`` and the Perceiver
speaker conditioner. Parameters keep the JAX tree's names; the layer stack is
an ``nn.ModuleList`` (the JAX tree's stacked leading axis is split at load).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from genvc_tpu_torch.models import perceiver
from genvc_tpu_torch.ops import flash_attention as fa
from genvc_tpu_torch.ops import nn as tnn


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    layers: int = 30
    model_dim: int = 1024
    heads: int = 4
    max_text_tokens: int = 402
    max_mel_tokens: int = 605
    number_text_tokens: int = 258
    num_audio_tokens: int = 1026
    start_text_token: int = 256
    stop_text_token: int = 257
    start_audio_token: int = 1024
    stop_audio_token: int = 1025
    code_stride_len: int = 1024
    max_prompt_tokens: int = 70
    perceiver_cond_length_compression: int = 256
    label_smoothing: float = 0.0

    @property
    def max_gen_mel_tokens(self) -> int:
        return self.max_mel_tokens - 1 - 2

    @property
    def mel_positions(self) -> int:
        return self.max_mel_tokens + 2 + 1

    @property
    def text_positions(self) -> int:
        return self.max_text_tokens + 2

    @property
    def n_cond_latents(self) -> int:
        return perceiver.N_LATENTS


class _Attn(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.c_attn = tnn.Linear(d, 3 * d)
        self.c_proj = tnn.Linear(d, d)


class _MLP(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.c_fc = tnn.Linear(d, 4 * d)
        self.c_proj = tnn.Linear(4 * d, d)


class Block(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.ln_1 = tnn.LayerNorm(d)
        self.attn = _Attn(d)
        self.ln_2 = tnn.LayerNorm(d)
        self.mlp = _MLP(d)

    def mlp_forward(self, h):
        x = self.ln_2(h)
        return h + self.mlp.c_proj(tnn.gelu_new(self.mlp.c_fc(x)))


class Core(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.blocks = nn.ModuleList(Block(cfg.model_dim) for _ in range(cfg.layers))
        self.ln_f = tnn.LayerNorm(cfg.model_dim)


def _table(n, d):
    return nn.Parameter(torch.empty(n, d), requires_grad=False)


class GPT(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        d = cfg.model_dim
        self.cfg = cfg
        self.text_embedding = _table(cfg.number_text_tokens, d)
        self.mel_embedding = _table(cfg.num_audio_tokens, d)
        self.text_pos = _table(cfg.text_positions, d)
        self.mel_pos = _table(cfg.mel_positions, d)
        self.core = Core(cfg)
        self.final_norm = tnn.LayerNorm(d)
        self.text_head = tnn.Linear(d, cfg.number_text_tokens)
        self.mel_head = tnn.Linear(d, cfg.num_audio_tokens)
        self.perceiver = perceiver.Perceiver(dim=d)

    @property
    def compute_dtype(self):
        return self.mel_embedding.dtype

    def forward(self, *args, **kwargs):
        """The training forward, :func:`forward_train`."""
        return forward_train(self, *args, **kwargs)


def get_style_emb(model: GPT, cond_mels, frame_valid=None):
    """(B, 80, T) conditioning mel -> (B, 32, D) speaker latents."""
    return model.perceiver(cond_mels.transpose(1, 2), frame_valid=frame_valid)


def build_prefix_emb(model: GPT, cond_latents, text_tokens, text_length):
    """Inference prefix [cond(32) | start_text + text + stop_text] at static
    text width. text_tokens (B, Wt) zero-padded, text_length (B,). Returns
    (prefix_emb (B, 32+Wt+2, D), prefix_valid (B, 32+Wt+2) bool); columns past
    each row's stop token are masked invalid."""
    cfg = model.cfg
    b, wt = text_tokens.shape
    dev = text_tokens.device
    pos = torch.arange(wt, device=dev)[None, :]
    toks = torch.where(pos < text_length[:, None], text_tokens,
                       torch.full_like(text_tokens, cfg.stop_text_token))
    inp = torch.cat([torch.full((b, 1), cfg.start_text_token, dtype=toks.dtype, device=dev),
                     toks,
                     torch.full((b, 1), cfg.stop_text_token, dtype=toks.dtype, device=dev)],
                    dim=1)
    emb = model.text_embedding[inp] + model.text_pos[None, : wt + 2]
    prefix = torch.cat([cond_latents.to(emb.dtype), emb], dim=1)
    col = torch.arange(wt + 2, device=dev)[None, :]
    text_valid = col <= (text_length[:, None] + 1)
    valid = torch.cat([torch.ones(b, cond_latents.shape[1], dtype=torch.bool,
                                  device=dev), text_valid], dim=1)
    return prefix, valid


def core_forward(core: Core, h, cfg: GPTConfig, key_valid=None, attn_impl="flash"):
    """Full-sequence causal forward (``gpt.core_forward``). h: (B, T, D);
    key_valid: (B, T) bool. ``attn_impl="flash"`` (default) sends every
    block's attention through ``ops.flash_attention`` (the kernels on the
    card, their plain versions on the CPU; differentiable), as the JAX package
    routes it on its accelerator; ``"xla"`` is the JAX package's dense-bias
    path (causal + key-padding bias, ``ops.nn.attention``) differentiated by
    autograd."""
    b, t, _ = h.shape
    kv = key_valid if key_valid is not None else torch.ones(
        b, t, dtype=torch.bool, device=h.device)
    if attn_impl == "flash":
        def attend(q, k, v):
            return fa.flash_attention(q, k, v, kv)
    elif attn_impl == "xla":
        bias = tnn.causal_bias(t, h.device) + tnn.key_padding_bias(kv)

        def attend(q, k, v):
            return tnn.attention(q, k, v, bias=bias)
    else:
        raise ValueError(f"attn_impl {attn_impl!r}: 'flash' or 'xla'")
    for block in core.blocks:
        x = block.ln_1(h)
        q, k, v = (tnn.split_heads(a, cfg.heads)
                   for a in block.attn.c_attn(x).chunk(3, dim=-1))
        a = tnn.merge_heads(attend(q, k, v))
        h = block.mlp_forward(h + block.attn.c_proj(a))
    return core.ln_f(h)


def _format_io(tokens, lengths, start_token: int, stop_token: int):
    """The reference's set_*_padding + set_inputs_and_targets: positions >=
    length become ``stop_token``; inputs [start | tokens | stop], targets
    [tokens | stop | stop]. tokens (B, W) -> (inputs, targets), each
    (B, W + 2)."""
    b, w = tokens.shape
    dev = tokens.device
    pos = torch.arange(w, device=dev)[None, :]
    toks = torch.where(pos < lengths[:, None], tokens,
                       torch.full_like(tokens, stop_token))
    start = torch.full((b, 1), start_token, dtype=toks.dtype, device=dev)
    stop = torch.full((b, 1), stop_token, dtype=toks.dtype, device=dev)
    return torch.cat([start, toks, stop], dim=1), torch.cat([toks, stop, stop], dim=1)


def forward_latent(model: GPT, text_inputs, text_lengths, audio_codes,
                   wav_lengths, cond_latents):
    """Teacher-forced latents (``gpt.forward_train(..., return_latent=True,
    train=False)``): text_inputs (B, Wt) and audio_codes (B, Wm) zero-padded,
    text_lengths (B,), wav_lengths (B,) in samples, cond_latents (B, 32, D).
    Returns (B, Wm + 2 - 5, D) in the GPT's dtype: ``final_norm`` of the
    audio positions, with the reference's trailing trim of 5."""
    cfg = model.cfg
    b, wt = text_inputs.shape
    wm = audio_codes.shape[1]
    dev = text_inputs.device
    code_lengths = torch.ceil(wav_lengths / cfg.code_stride_len).long() + 3
    text_inp, _ = _format_io(text_inputs, text_lengths, cfg.start_text_token,
                             cfg.stop_text_token)
    mel_inp, _ = _format_io(audio_codes, code_lengths - 3, cfg.start_audio_token,
                            cfg.stop_audio_token)
    text_emb = model.text_embedding[text_inp] + model.text_pos[None, : wt + 2]
    mel_emb = model.mel_embedding[mel_inp] + model.mel_pos[None, : wm + 2]
    n_cond = cond_latents.shape[1]
    emb = torch.cat([cond_latents.to(text_emb.dtype), text_emb, mel_emb], dim=1)
    # the reference's tensors are exactly as wide as the batch needs; under
    # the static widths only columns it would not have are masked
    tpos = torch.arange(wt + 2, device=dev)[None, :]
    mpos = torch.arange(wm + 2, device=dev)[None, :]
    key_valid = torch.cat([torch.ones(b, n_cond, dtype=torch.bool, device=dev),
                           tpos <= text_lengths[:, None] + 1,
                           mpos <= code_lengths[:, None] + 1], dim=1)
    h = core_forward(model.core, emb.to(model.compute_dtype), cfg, key_valid)
    enc = model.final_norm(h[:, n_cond:])
    return enc[:, -(wm + 2):][:, :-5]


def forward_train(model: GPT, text_inputs, text_lengths, audio_codes, wav_lengths,
                  cond_mels=None, cond_lens=None, cond_latents=None,
                  fix_condition_embeddings=False, attn_impl="flash"):
    """Teacher-forced training forward and losses (``gpt.forward_train``, its
    loss branch): text_inputs (B, Wt) content codes and audio_codes (B, Wm)
    zero-padded, text_lengths (B,), wav_lengths (B,) in samples; cond_mels
    (B, 80, Tc) with cond_lens (B,) in samples, or cond_latents (B, 32, D).
    ``fix_condition_embeddings`` cuts the Perceiver off the gradient (its
    parameters get zero gradients). Returns (loss_text, loss_mel, top10
    accuracy, mel_logits)."""
    cfg = model.cfg
    b, wt = text_inputs.shape
    wm = audio_codes.shape[1]
    dev = text_inputs.device
    code_lengths = torch.ceil(wav_lengths / cfg.code_stride_len).long() + 3
    text_inp, text_tar = _format_io(text_inputs, text_lengths, cfg.start_text_token,
                                    cfg.stop_text_token)
    mel_inp, mel_tar = _format_io(audio_codes, code_lengths - 3, cfg.start_audio_token,
                                  cfg.stop_audio_token)
    text_emb = model.text_embedding[text_inp] + model.text_pos[None, : wt + 2]
    mel_emb = model.mel_embedding[mel_inp] + model.mel_pos[None, : wm + 2]
    if cond_latents is None:
        frame_valid = None
        if cond_lens is not None:
            fl = cond_lens // cfg.perceiver_cond_length_compression
            frame_valid = (torch.arange(cond_mels.shape[-1], device=dev)[None, :]
                           < fl[:, None])
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not fix_condition_embeddings):
            cond_latents = get_style_emb(model, cond_mels, frame_valid)
    n_cond = cond_latents.shape[1]
    emb = torch.cat([cond_latents.to(text_emb.dtype), text_emb, mel_emb], dim=1)
    # attn_mask_text[l+1:] = 0, attn_mask_mel[l+1:] = 0 (reference gpt.py:470-474)
    tpos = torch.arange(wt + 2, device=dev)[None, :]
    mpos = torch.arange(wm + 2, device=dev)[None, :]
    text_keep = tpos <= text_lengths[:, None]
    mel_keep = mpos <= code_lengths[:, None]
    key_valid = torch.cat([torch.ones(b, n_cond, dtype=torch.bool, device=dev),
                           text_keep, mel_keep], dim=1)
    h = core_forward(model.core, emb, cfg, key_valid, attn_impl)
    enc = model.final_norm(h[:, n_cond:])
    text_logits = model.text_head(enc[:, : wt + 2])
    mel_logits = model.mel_head(enc[:, -(wm + 2):])
    loss_text = _masked_ce(text_logits, text_tar, text_keep, cfg.label_smoothing)
    loss_mel = _masked_ce(mel_logits, mel_tar, mel_keep, cfg.label_smoothing)
    top10 = _topk_accuracy(mel_logits, mel_tar, mel_keep, k=10)
    return loss_text, loss_mel, top10, mel_logits


def _masked_ce(logits, targets, keep, label_smoothing=0.0):
    """Mean cross-entropy over kept targets, in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt_logp = torch.gather(logp, -1, targets[..., None])[..., 0]
    if label_smoothing > 0.0:
        nll = -(1.0 - label_smoothing) * tgt_logp - label_smoothing * logp.mean(dim=-1)
    else:
        nll = -tgt_logp
    keep = keep.float()
    return (nll * keep).sum() / keep.sum().clamp_min(1.0)


def _topk_accuracy(logits, targets, keep, k=10):
    """Micro top-k accuracy over kept targets: the target's rank counts the
    logits strictly above it, so ties are hits (``gpt._topk_accuracy``)."""
    tgt_logit = torch.gather(logits, -1, targets[..., None])
    rank = (logits > tgt_logit).sum(dim=-1)
    keep = keep.float()
    return ((rank < k).float() * keep).sum() / keep.sum().clamp_min(1.0)


def init_tree(gen, cfg: GPTConfig):
    """Seeded random parameters with the JAX package's init stds
    (``gpt.init_params``): 0.02 for embeddings and c_attn/c_fc, 0.02/sqrt(2L)
    for the residual projections, so bf16 activations stay in range."""
    d = cfg.model_dim
    proj_std = 0.02 / math.sqrt(2 * cfg.layers)
    blocks = [{
        "ln_1": tnn.init_layer_norm(gen, d),
        "attn": {"c_attn": tnn.init_linear(gen, d, 3 * d, std=0.02),
                 "c_proj": tnn.init_linear(gen, d, d, std=proj_std)},
        "ln_2": tnn.init_layer_norm(gen, d),
        "mlp": {"c_fc": tnn.init_linear(gen, d, 4 * d, std=0.02),
                "c_proj": tnn.init_linear(gen, 4 * d, d, std=proj_std)},
    } for _ in range(cfg.layers)]
    return {
        "text_embedding": tnn.init_embedding(gen, cfg.number_text_tokens, d),
        "mel_embedding": tnn.init_embedding(gen, cfg.num_audio_tokens, d),
        "text_pos": tnn.init_embedding(gen, cfg.text_positions, d),
        "mel_pos": tnn.init_embedding(gen, cfg.mel_positions, d),
        "core": {"blocks": blocks, "ln_f": tnn.init_layer_norm(gen, d)},
        "final_norm": tnn.init_layer_norm(gen, d),
        "text_head": tnn.init_linear(gen, d, cfg.number_text_tokens),
        "mel_head": tnn.init_linear(gen, d, cfg.num_audio_tokens),
        "perceiver": perceiver.init_tree(gen, dim=d),
    }
