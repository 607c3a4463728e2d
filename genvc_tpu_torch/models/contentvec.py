"""ContentVec / HuBERT-base content feature extractor
(``genvc_tpu/models/contentvec.py``).

16 kHz waveform -> 50 Hz, 256-d content features: a 7-layer bias-free conv
extractor (GroupNorm per channel after layer 0, GELU), LayerNorm, projection to
768, a grouped positional conv (k=128, groups=16, SamePad), 12 post-LN
transformer layers (12 heads, FFN 3072, exact GELU) and ``final_proj`` 768 ->
256. A sample equal to 0.0 is padding; a frame is padding iff all its samples
are. With ``sample_valid`` the true lengths thread through the stride chain so
a statically padded row matches an exact-length run.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from genvc_tpu_torch.ops import nn as tnn
from genvc_tpu_torch.ops.conv import Conv1d

CONV_LAYERS = [(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2
EMBED_DIM = 768
N_HEADS = 12
FINAL_DIM = 256


def frame_count(n_samples: int) -> int:
    t = n_samples
    for _, k, s in CONV_LAYERS:
        t = (t - k) // s + 1
    return t


def _time_mask(t, valid, device, dtype=torch.float32):
    """(B,) valid lengths -> (B, 1, t) mask of ``dtype``."""
    return (torch.arange(t, device=device)[None, None, :]
            < valid[:, None, None]).to(dtype)


def _group_norm_per_channel(x, scale, bias, valid=None, eps=1e-5):
    """GroupNorm(C, C): normalize each channel over time; ``valid`` restricts
    the statistics to the true length."""
    if valid is None:
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
    else:
        m = _time_mask(x.shape[-1], valid, x.device, x.dtype)
        cnt = m.sum(dim=-1, keepdim=True).clamp_min(1.0)
        mean = (x * m).sum(dim=-1, keepdim=True) / cnt
        var = ((x - mean).square() * m).sum(dim=-1, keepdim=True) / cnt
    xn = (x - mean) * torch.rsqrt(var + eps)
    return xn * scale[None, :, None] + bias[None, :, None]


class _FeatLayer(nn.Module):
    def __init__(self, c_in, c_out, k, norm: bool):
        super().__init__()
        self.conv = Conv1d(c_in, c_out, k, bias=False)
        self.norm = tnn.LayerNorm(c_out) if norm else None


class _Attn(nn.Module):
    def __init__(self):
        super().__init__()
        for name in ("q", "k", "v", "out"):
            setattr(self, name, tnn.Linear(EMBED_DIM, EMBED_DIM))

    def forward(self, x, bias):
        qh = tnn.split_heads(self.q(x), N_HEADS)
        kh = tnn.split_heads(self.k(x), N_HEADS)
        vh = tnn.split_heads(self.v(x), N_HEADS)
        return self.out(tnn.merge_heads(tnn.attention(qh, kh, vh, bias=bias)))


class _EncoderLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.attn = _Attn()
        self.attn_ln = tnn.LayerNorm(EMBED_DIM)
        self.fc1 = tnn.Linear(EMBED_DIM, 3072)
        self.fc2 = tnn.Linear(3072, EMBED_DIM)
        self.final_ln = tnn.LayerNorm(EMBED_DIM)

    def forward(self, x, bias):
        # post-LN ordering (fairseq layer_norm_first=False)
        x = self.attn_ln(x + self.attn(x, bias))
        x = x + self.fc2(tnn.gelu_exact(self.fc1(x)))
        return self.final_ln(x)


class ContentVec(nn.Module):
    def __init__(self, n_layers: int = 12):
        super().__init__()
        layers, c_in = [], 1
        for i, (c, k, _) in enumerate(CONV_LAYERS):
            layers.append(_FeatLayer(c_in, c, k, norm=i == 0))
            c_in = c
        self.feature_extractor = nn.ModuleList(layers)
        self.post_extract_proj = tnn.Linear(512, EMBED_DIM)
        self.pos_conv = Conv1d(EMBED_DIM, EMBED_DIM, 128, groups=16)
        self.pre_ln = tnn.LayerNorm(512)
        self.encoder_ln = tnn.LayerNorm(EMBED_DIM)
        self.layers = nn.ModuleList(_EncoderLayer() for _ in range(n_layers))
        self.final_proj = tnn.Linear(EMBED_DIM, FINAL_DIM)

    def feature_extractor_forward(self, wav, sample_valid=None):
        """(B, T) -> (B, T', 512) conv features in the parameters' dtype;
        features beyond the threaded valid length are zeroed after each
        layer."""
        x = wav[:, None, :].to(self.post_extract_proj.w.dtype)
        valid = sample_valid
        for layer, (_, k, s) in zip(self.feature_extractor, CONV_LAYERS):
            x = layer.conv(x, stride=s)
            if valid is not None:
                valid = ((valid - k) // s + 1).clamp_min(0)
            if layer.norm is not None:
                x = _group_norm_per_channel(x, layer.norm.scale, layer.norm.bias, valid)
            x = tnn.gelu_exact(x)
            if valid is not None:
                x = x * _time_mask(x.shape[-1], valid, x.device, x.dtype)
        return x.transpose(1, 2)

    def forward(self, wav, sample_valid=None, compute_dtype=None):
        """(B, T) @16 kHz -> (B, T', 256) f32 content features
        (``extract_content_features``), computed in the parameters' dtype.

        ``compute_dtype=torch.bfloat16`` runs the whole extractor on a bf16
        cast of every parameter (LayerNorms too, whose statistics stay f32),
        as the JAX package casts its tree; the output is upcast to f32."""
        if compute_dtype is not None and compute_dtype != self.final_proj.w.dtype:
            casts = {n: p.to(compute_dtype) for n, p in self.named_parameters()}
            return functional_call(self, casts, (wav, sample_valid))
        feats = self.feature_extractor_forward(wav, sample_valid)
        b, t_frames, _ = feats.shape
        samples_per_frame = wav.shape[-1] // t_frames
        trimmed = wav[:, : t_frames * samples_per_frame].reshape(b, t_frames, -1)
        frame_pad = (trimmed == 0.0).all(dim=-1)
        if sample_valid is not None:
            valid = sample_valid
            for _, k, s in CONV_LAYERS:
                valid = ((valid - k) // s + 1).clamp_min(0)
            frame_idx = torch.arange(t_frames, device=wav.device)[None, :]
            frame_pad = frame_pad | (frame_idx >= valid[:, None])
        frame_valid = ~frame_pad

        x = self.post_extract_proj(self.pre_ln(feats))
        x = x * frame_valid[..., None]
        xc = self.pos_conv(x.transpose(1, 2), padding=64)[..., :-1]  # SamePad
        x = self.encoder_ln(x + tnn.gelu_exact(xc.transpose(1, 2)))
        bias = tnn.key_padding_bias(frame_valid)
        for layer in self.layers:
            x = layer(x, bias)
        return self.final_proj(x).float()


def init_tree(gen, n_layers: int = 12):
    """Seeded random parameter tree with the JAX package's init
    (``contentvec.init_params``)."""
    dev = gen.device
    fe, c_in = [], 1
    for i, (c, k, _) in enumerate(CONV_LAYERS):
        layer = {"conv": {"w": torch.randn(c, c_in, k, generator=gen, device=dev) * 0.05}}
        if i == 0:
            layer["norm"] = {"scale": torch.ones(c, device=dev),
                             "bias": torch.zeros(c, device=dev)}
        fe.append(layer)
        c_in = c

    def lin(i, o):
        return tnn.init_linear(gen, i, o)

    layers = [{
        "attn": {"q": lin(EMBED_DIM, EMBED_DIM), "k": lin(EMBED_DIM, EMBED_DIM),
                 "v": lin(EMBED_DIM, EMBED_DIM), "out": lin(EMBED_DIM, EMBED_DIM)},
        "attn_ln": tnn.init_layer_norm(gen, EMBED_DIM),
        "fc1": lin(EMBED_DIM, 3072),
        "fc2": lin(3072, EMBED_DIM),
        "final_ln": tnn.init_layer_norm(gen, EMBED_DIM),
    } for _ in range(n_layers)]
    return {
        "feature_extractor": fe,
        "post_extract_proj": lin(512, EMBED_DIM),
        "pos_conv": {"w": torch.randn(EMBED_DIM, EMBED_DIM // 16, 128,
                                      generator=gen, device=dev) * 0.01,
                     "b": torch.zeros(EMBED_DIM, device=dev)},
        "pre_ln": tnn.init_layer_norm(gen, 512),
        "encoder_ln": tnn.init_layer_norm(gen, EMBED_DIM),
        "layers": layers,
        "final_proj": lin(EMBED_DIM, FINAL_DIM),
    }
