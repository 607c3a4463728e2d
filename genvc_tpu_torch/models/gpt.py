"""GPT-2 decoder backbone for content tokens -> audio codes
(``genvc_tpu/models/gpt.py``): inference (prefix, latent pass) and the
teacher-forced training forward with its losses.

Pre-LN GPT-2 blocks (gelu_new MLP), learned per-modality positional tables,
text/mel embeddings and heads, a shared ``final_norm`` and the Perceiver
speaker conditioner. Parameters keep the JAX tree's names; the layer stack is
an ``nn.ModuleList`` (the JAX tree's stacked leading axis is split at load).

With ``GPTConfig.mla_moe`` set the blocks are DeepSeek-V3's instead
(``models/mla_moe.py``: latent attention, a mixture of experts, RMSNorm, and
an RMSNorm ``ln_f``); everything around them is GenVC's. That backbone has
no tensor parallelism and no training forward (both raise).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from genvc_tpu_torch.models import mla_moe, perceiver
from genvc_tpu_torch.ops import flash_attention as fa
from genvc_tpu_torch.ops import nn as tnn
from genvc_tpu_torch.parallel import collectives
from genvc_tpu_torch.parallel import mesh as mesh_lib


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
    mla_moe: mla_moe.MLAMoEConfig | None = None  # the DeepSeek-V3 backbone, else GPT-2

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
    def __init__(self, d, n_model=1):
        super().__init__()
        self.c_attn = tnn.Linear(d, 3 * d // n_model)
        self.c_proj = tnn.Linear(d // n_model, d)


class _MLP(nn.Module):
    def __init__(self, d, n_model=1):
        super().__init__()
        self.c_fc = tnn.Linear(d, 4 * d // n_model)
        self.c_proj = tnn.Linear(4 * d // n_model, d)


def _row_parallel(lin: tnn.Linear, x, group):
    """A row-parallel product: the partial products summed over ``group``,
    then the (replicated) bias added once."""
    y = collectives.reduce_from_model(x @ lin.w.to(x.dtype), group)
    return y + lin.b.to(x.dtype)


class Block(nn.Module):
    """A pre-LN block. With ``n_model > 1`` it holds one rank's Megatron
    shards: ``c_attn`` (D, 3D/n) with its heads' columns of q, k and v,
    ``c_fc`` (D, 4D/n) column-parallel, each ``c_proj`` (D/n or 4D/n, D)
    row-parallel with the whole bias (``parallel.mesh.shard_tree``)."""

    def __init__(self, d, n_model=1):
        super().__init__()
        self.ln_1 = tnn.LayerNorm(d)
        self.attn = _Attn(d, n_model)
        self.ln_2 = tnn.LayerNorm(d)
        self.mlp = _MLP(d, n_model)

    def forward(self, h, attend, heads: int, group=None):
        """The block over a whole sequence; ``attend(q, k, v)`` attends the
        (B, heads, T, hd) heads. ``group``: the model group of a sharded
        block (``heads`` is then the rank's local heads)."""
        x = self.ln_1(h)
        if group is None:
            q, k, v = (tnn.split_heads(a, heads) for a in self.attn.c_attn(x).chunk(3, dim=-1))
            return self.mlp_forward(h + self.attn.c_proj(tnn.merge_heads(attend(q, k, v))))
        x = collectives.copy_to_model(x, group)
        q, k, v = (tnn.split_heads(a, heads) for a in self.attn.c_attn(x).chunk(3, dim=-1))
        h = h + _row_parallel(self.attn.c_proj, tnn.merge_heads(attend(q, k, v)), group)
        return self.mlp_forward(h, group)

    def mlp_forward(self, h, group=None):
        x = self.ln_2(h)
        if group is None:
            return h + self.mlp.c_proj(tnn.gelu_new(self.mlp.c_fc(x)))
        x = collectives.copy_to_model(x, group)
        return h + _row_parallel(self.mlp.c_proj, tnn.gelu_new(self.mlp.c_fc(x)), group)


class Core(nn.Module):
    def __init__(self, cfg: GPTConfig, n_model: int = 1):
        super().__init__()
        if cfg.mla_moe is not None:
            m = cfg.mla_moe
            self.blocks = nn.ModuleList(mla_moe.MLAMoEBlock(cfg.model_dim, cfg.heads, m, i)
                                        for i in range(cfg.layers))
            self.ln_f = tnn.RMSNorm(cfg.model_dim, m.rms_norm_eps)
            return
        self.blocks = nn.ModuleList(Block(cfg.model_dim, n_model) for _ in range(cfg.layers))
        self.ln_f = tnn.LayerNorm(cfg.model_dim)


def _table(n, d):
    return nn.Parameter(torch.empty(n, d), requires_grad=False)


class GPT(nn.Module):
    """``n_model > 1``: the blocks hold one rank's tensor-parallel shards
    (:class:`Block`); everything else is whole on every rank."""

    def __init__(self, cfg: GPTConfig, n_model: int = 1):
        super().__init__()
        d = cfg.model_dim
        if cfg.mla_moe is not None and n_model > 1:
            raise mla_moe.unsupported("tensor parallelism")
        if cfg.heads % n_model:
            raise ValueError(f"{cfg.heads} heads do not divide over n_model={n_model}")
        self.cfg = cfg
        self.n_model = n_model
        self.text_embedding = _table(cfg.number_text_tokens, d)
        self.mel_embedding = _table(cfg.num_audio_tokens, d)
        self.text_pos = _table(cfg.text_positions, d)
        self.mel_pos = _table(cfg.mel_positions, d)
        self.core = Core(cfg, n_model)
        self.final_norm = tnn.LayerNorm(d)
        self.text_head = tnn.Linear(d, cfg.number_text_tokens)
        self.mel_head = tnn.Linear(d, cfg.num_audio_tokens)
        self.perceiver = perceiver.Perceiver(dim=d)

    def param_splits(self) -> dict:
        """Name -> ``(dim, qkv)`` of each parameter this rank holds a shard
        of (``parallel.mesh.split_dim`` / ``is_qkv``); empty on one card."""
        if self.n_model == 1:
            return {}
        return {name: (d, mesh_lib.is_qkv(name)) for name, p in self.named_parameters()
                if (d := mesh_lib.split_dim(name, p.dim())) is not None}

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


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: save the
    outputs of products without batch dimensions (a block's four weight
    products, ``aten.mm`` under ``x @ w``), recompute the rest. The attention
    kernels are ctypes calls inside an autograd Function, outside the
    dispatcher: they run again in the recompute."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_block(block: Block, h, attend, heads: int, remat, group=None):
    """``block(h)`` under activation checkpointing. The block's parameters
    are inputs of the checkpointed function: under ``functional_call`` the
    module holds the substituted tensors only while the forward runs, and the
    recompute comes later, in the backward."""
    items = list(block.named_parameters())  # the substituted tensors, if any
    names = [n for n, _ in items]

    def run(h, *tensors):
        return functional_call(block, dict(zip(names, tensors)), (h, attend, heads, group))

    context = (functools.partial(create_selective_checkpoint_contexts, _dots_policy)
               if remat == "dots" else noop_context_fn)
    return checkpoint(run, h, *(t for _, t in items), use_reentrant=False,
                      context_fn=context)


def core_forward(core: Core, h, cfg: GPTConfig, key_valid=None, attn_impl="flash",
                 remat=False, model_group=None):
    """Full-sequence causal forward (``gpt.core_forward``). h: (B, T, D);
    key_valid: (B, T) bool. ``attn_impl="flash"`` (default) sends every
    block's attention through ``ops.flash_attention`` (the kernels on the
    card, their plain versions on the CPU; differentiable), as the JAX package
    routes it on its accelerator; ``"xla"`` is the JAX package's dense-bias
    path (causal + key-padding bias, ``ops.nn.attention``) differentiated by
    autograd.

    ``remat=True`` checkpoints each block: the backward recomputes its
    activations, the attention forward (K4) included. ``remat="dots"`` saves
    the block's weight products and recomputes the rest (``_dots_policy``).
    Either gives the same loss and gradients as ``remat=False``.

    ``model_group``: the tensor-parallel group of a core built with
    ``n_model`` > 1; each block attends its ``heads / n_model`` local heads
    and sums its row-parallel products over the group. Without it the code
    is the single-card one."""
    if remat not in (False, True, "dots"):
        raise ValueError(f"remat {remat!r}: False, True or 'dots'")
    b, t, _ = h.shape
    kv = key_valid if key_valid is not None else torch.ones(
        b, t, dtype=torch.bool, device=h.device)
    if cfg.mla_moe is not None:  # inference only (forward_train raises)
        if remat or model_group is not None:
            raise mla_moe.unsupported("remat and tensor parallelism")
        return mla_moe.core_forward(core, h, kv)
    if attn_impl == "flash":
        def attend(q, k, v):
            return fa.flash_attention(q, k, v, kv)
    elif attn_impl == "xla":
        bias = tnn.causal_bias(t, h.device) + tnn.key_padding_bias(kv)

        def attend(q, k, v):
            return tnn.attention(q, k, v, bias=bias)
    else:
        raise ValueError(f"attn_impl {attn_impl!r}: 'flash' or 'xla'")
    heads = cfg.heads
    if model_group is not None:
        heads //= torch.distributed.get_world_size(model_group)
    for block in core.blocks:
        if remat:
            h = _remat_block(block, h, attend, heads, remat, model_group)
        elif model_group is None:
            h = block(h, attend, heads)
        else:
            h = block(h, attend, heads, model_group)
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
                  fix_condition_embeddings=False, attn_impl="flash", remat=False,
                  model_group=None, data_group=None):
    """Teacher-forced training forward and losses (``gpt.forward_train``, its
    loss branch): text_inputs (B, Wt) content codes and audio_codes (B, Wm)
    zero-padded, text_lengths (B,), wav_lengths (B,) in samples; cond_mels
    (B, 80, Tc) with cond_lens (B,) in samples, or cond_latents (B, 32, D).
    ``fix_condition_embeddings`` cuts the Perceiver off the gradient (its
    parameters get zero gradients); ``remat`` and ``model_group`` as
    :func:`core_forward`. Returns (loss_text, loss_mel, top10 accuracy,
    mel_logits).

    ``data_group``: this rank holds some rows of a global batch. Each loss
    and the accuracy is then this rank's share of the global batch's mean,
    sum(nll * keep) over its rows / sum(keep) over the global batch (the
    denominators all-reduced here); the shares sum over the group to the
    global means (JAX's ``_masked_ce`` over the sharded batch)."""
    cfg = model.cfg
    if cfg.mla_moe is not None:
        raise mla_moe.unsupported("training")
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
    h = core_forward(model.core, emb, cfg, key_valid, attn_impl, remat, model_group)
    enc = model.final_norm(h[:, n_cond:])
    text_logits = model.text_head(enc[:, : wt + 2])
    mel_logits = model.mel_head(enc[:, -(wm + 2):])
    den_text = den_mel = None
    if data_group is not None:
        dens = torch.stack([text_keep.float().sum(), mel_keep.float().sum()])
        den_text, den_mel = collectives.all_reduce(dens, data_group)
    loss_text = _masked_ce(text_logits, text_tar, text_keep, cfg.label_smoothing, den_text)
    loss_mel = _masked_ce(mel_logits, mel_tar, mel_keep, cfg.label_smoothing, den_mel)
    top10 = _topk_accuracy(mel_logits, mel_tar, mel_keep, k=10, den=den_mel)
    return loss_text, loss_mel, top10, mel_logits


def _masked_ce(logits, targets, keep, label_smoothing=0.0, den=None):
    """Mean cross-entropy over kept targets, in f32; ``den`` (the global
    batch's kept count) replaces this batch's own."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt_logp = torch.gather(logp, -1, targets[..., None])[..., 0]
    if label_smoothing > 0.0:
        nll = -(1.0 - label_smoothing) * tgt_logp - label_smoothing * logp.mean(dim=-1)
    else:
        nll = -tgt_logp
    keep = keep.float()
    return (nll * keep).sum() / (keep.sum() if den is None else den).clamp_min(1.0)


def _topk_accuracy(logits, targets, keep, k=10, den=None):
    """Micro top-k accuracy over kept targets: the target's rank counts the
    logits strictly above it, so ties are hits (``gpt._topk_accuracy``)."""
    tgt_logit = torch.gather(logits, -1, targets[..., None])
    rank = (logits > tgt_logit).sum(dim=-1)
    keep = keep.float()
    return ((rank < k).float() * keep).sum() / (keep.sum() if den is None
                                                else den).clamp_min(1.0)


def init_tree(gen, cfg: GPTConfig):
    """Seeded random parameters with the JAX package's init stds
    (``gpt.init_params``): 0.02 for embeddings and c_attn/c_fc, 0.02/sqrt(2L)
    for the residual projections, so bf16 activations stay in range."""
    d = cfg.model_dim
    proj_std = 0.02 / math.sqrt(2 * cfg.layers)
    if cfg.mla_moe is not None:
        blocks = [mla_moe.init_block(gen, d, cfg.heads, cfg.mla_moe, i)
                  for i in range(cfg.layers)]
        ln_f = {"scale": torch.ones(d, device=gen.device)}
    else:
        blocks = [{
            "ln_1": tnn.init_layer_norm(gen, d),
            "attn": {"c_attn": tnn.init_linear(gen, d, 3 * d, std=0.02),
                     "c_proj": tnn.init_linear(gen, d, d, std=proj_std)},
            "ln_2": tnn.init_layer_norm(gen, d),
            "mlp": {"c_fc": tnn.init_linear(gen, d, 4 * d, std=0.02),
                    "c_proj": tnn.init_linear(gen, 4 * d, d, std=proj_std)},
        } for _ in range(cfg.layers)]
        ln_f = tnn.init_layer_norm(gen, d)
    return {
        "text_embedding": tnn.init_embedding(gen, cfg.number_text_tokens, d),
        "mel_embedding": tnn.init_embedding(gen, cfg.num_audio_tokens, d),
        "text_pos": tnn.init_embedding(gen, cfg.text_positions, d),
        "mel_pos": tnn.init_embedding(gen, cfg.mel_positions, d),
        "core": {"blocks": blocks, "ln_f": ln_f},
        "final_norm": tnn.init_layer_norm(gen, d),
        "text_head": tnn.init_linear(gen, d, cfg.number_text_tokens),
        "mel_head": tnn.init_linear(gen, d, cfg.num_audio_tokens),
        "perceiver": perceiver.init_tree(gen, dim=d),
    }
