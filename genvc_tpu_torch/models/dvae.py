"""Discrete VAE tokenizer (``genvc_tpu/models/dvae.py``).

encoder  [conv(k3, s2, p1) + relu] x num_layers -> ResBlock x n -> conv(k1)
decoder  conv(k1) -> ResBlock x n -> [nearest x2 + conv(k3, p1) + relu] x
         num_layers -> conv(k1)
VQ       nearest codebook entry (reference distance + first-max tie-break);
         in training an EMA codebook (decay .99, eps 1e-5), straight-through
         estimator, commitment MSE.

The codebook (``embed`` (D, N); with ``trainable=True`` also the EMA
statistics ``cluster_size`` and ``embed_avg``) is held in buffers: it gets no
gradient and no optimizer update, only the EMA value that
:meth:`DVAE.forward_train` returns. A frozen tokenizer (``trainable=False``)
has no decoder.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

import torch.nn.functional as F

from genvc_tpu_torch.ops.conv import Conv1d, init_conv1d, nearest_upsample1d
from genvc_tpu_torch.parallel import collectives


@dataclasses.dataclass(frozen=True)
class DVAEConfig:
    channels: int = 80
    num_tokens: int = 1024
    codebook_dim: int = 512
    hidden_dim: int = 512
    num_resnet_blocks: int = 3
    kernel_size: int = 3
    num_layers: int = 2
    decay: float = 0.99
    eps: float = 1e-5


class _ResBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = Conv1d(c, c, 3)
        self.conv2 = Conv1d(c, c, 3)
        self.conv3 = Conv1d(c, c, 1)

    def forward(self, x):
        y = torch.relu(self.conv1(x, padding=1))
        y = torch.relu(self.conv2(y, padding=1))
        return self.conv3(y) + x


class _Encoder(nn.Module):
    def __init__(self, cfg: DVAEConfig):
        super().__init__()
        chans = [cfg.channels] + [cfg.hidden_dim * 2 ** i for i in range(cfg.num_layers)]
        self.convs = nn.ModuleList(Conv1d(chans[i], chans[i + 1], cfg.kernel_size)
                                   for i in range(cfg.num_layers))
        self.resblocks = nn.ModuleList(_ResBlock(chans[-1])
                                       for _ in range(cfg.num_resnet_blocks))
        self.out = Conv1d(chans[-1], cfg.codebook_dim, 1)


class _Decoder(nn.Module):
    def __init__(self, cfg: DVAEConfig):
        super().__init__()
        enc = [cfg.hidden_dim * 2 ** i for i in range(cfg.num_layers)]
        chans = [enc[-1]] + enc[::-1]  # e.g. [1024, 1024, 512]
        self.inp = Conv1d(cfg.codebook_dim, enc[-1], 1)
        self.resblocks = nn.ModuleList(_ResBlock(enc[-1])
                                       for _ in range(cfg.num_resnet_blocks))
        self.ups = nn.ModuleList(Conv1d(chans[i], chans[i + 1], cfg.kernel_size)
                                 for i in range(cfg.num_layers))
        self.out = Conv1d(enc[0], cfg.channels, 1)


class _Codebook(nn.Module):
    def __init__(self, cfg: DVAEConfig, ema: bool):
        super().__init__()
        self.register_buffer("embed", torch.empty(cfg.codebook_dim, cfg.num_tokens))
        if ema:
            self.register_buffer("cluster_size", torch.empty(cfg.num_tokens))
            self.register_buffer("embed_avg", torch.empty(cfg.codebook_dim, cfg.num_tokens))


def _mask_t(x, valid_len):
    if valid_len is None:
        return x
    t = x.shape[-1]
    return x * (torch.arange(t, device=x.device)[None, None, :]
                < valid_len[:, None, None])


class DVAE(nn.Module):
    """Parameters as the JAX tree: ``encoder`` and ``codebook.embed`` (D, N);
    with ``trainable`` also ``decoder`` and the codebook's EMA statistics;
    with ``decoder`` a frozen dVAE that also decodes (the GPT stage's
    listening samples)."""

    def __init__(self, cfg: DVAEConfig, trainable: bool = False, decoder: bool = False):
        super().__init__()
        self.cfg = cfg
        self.encoder = _Encoder(cfg)
        if trainable or decoder:
            self.decoder = _Decoder(cfg)
        self.codebook = _Codebook(cfg, ema=trainable)

    def encode(self, x, valid_len=None):
        """(B, C, T) -> (B, D, T/4) pre-quantization values; ``valid_len`` (B,)
        masks padding so valid positions equal an exact-length run."""
        pad = (self.cfg.kernel_size - 1) // 2
        for conv in self.encoder.convs:
            x = _mask_t(x, valid_len)
            x = torch.relu(conv(x, stride=2, padding=pad))
            if valid_len is not None:
                valid_len = (valid_len - 1) // 2 + 1
        for rb in self.encoder.resblocks:
            x = rb(_mask_t(x, valid_len))
        return self.encoder.out(_mask_t(x, valid_len))

    def nearest_codes(self, z):
        """z: (B, T, D) -> (B, T) nearest-codebook indices (first max wins)."""
        embed = self.codebook.embed.float()
        zf = z.float()
        dist = (zf.square().sum(dim=-1, keepdim=True)
                - 2.0 * torch.einsum("btd,dn->btn", zf, embed)
                + embed.square().sum(dim=0)[None, None, :])
        return torch.argmax(-dist, dim=-1)

    def get_codebook_indices(self, x, valid_len=None):
        """Features (B, C, T) -> codes (B, T/4)."""
        return self.nearest_codes(self.encode(x, valid_len).transpose(1, 2))

    def decoder_forward(self, x):
        """(B, D, T) -> (B, C, T * 2 ** num_layers)."""
        pad = (self.cfg.kernel_size - 1) // 2
        dec = self.decoder
        x = dec.inp(x)
        for rb in dec.resblocks:
            x = rb(x)
        for up in dec.ups:
            x = torch.relu(up(nearest_upsample1d(x, 2), padding=pad))
        return dec.out(x)

    def decode(self, codes):
        """codes (B, T) -> (B, C, 4T) reconstruction (reference dvae.py:333-352)."""
        return self.decoder_forward(self.codebook.embed.T[codes].transpose(1, 2))

    def forward(self, x, data_group=None):
        """The training forward, :meth:`forward_train`."""
        return self.forward_train(x, data_group)

    def forward_train(self, x, data_group=None):
        """Training forward (reference dvae.py:363-381 in train mode): (B, C,
        T) features -> (recon_loss, commitment_loss, recon, new_codebook,
        codes). ``new_codebook`` is the EMA update of the three codebook
        buffers, returned and not applied (the train step applies it after
        the optimizer's update; an eval forward drops it). The EMA sums run as
        f32 matmuls (TF32 off on the card), as the JAX package's HIGHEST.

        ``data_group``: ``x`` is this rank's rows of a global batch; the
        code counts and the code-wise sums of ``z`` are all-reduced over the
        group before the EMA (JAX's ``psum`` over ``axis_name``), so every
        rank computes the global batch's codebook."""
        cfg = self.cfg
        cb = self.codebook
        z_btd = self.encode(x).transpose(1, 2)  # (B, T/4, D)
        codes = self.nearest_codes(z_btd)
        quant = cb.embed.T[codes]
        with torch.no_grad():
            n_embed = cb.embed.shape[1]
            flat = z_btd.reshape(-1, z_btd.shape[-1]).float()
            onehot = F.one_hot(codes.reshape(-1), n_embed).float()
            onehot_sum, embed_sum = onehot.sum(0), flat.T @ onehot
            if data_group is not None:
                both = collectives.all_reduce(
                    torch.cat([onehot_sum[None], embed_sum]), data_group)
                onehot_sum, embed_sum = both[0], both[1:]
            cluster_size = cb.cluster_size * cfg.decay + onehot_sum * (1 - cfg.decay)
            embed_avg = cb.embed_avg * cfg.decay + embed_sum * (1 - cfg.decay)
            n = cluster_size.sum()
            cluster = (cluster_size + cfg.eps) / (n + n_embed * cfg.eps) * n
            new_codebook = {"embed": embed_avg / cluster[None, :],
                            "cluster_size": cluster_size, "embed_avg": embed_avg}
        commitment = (quant.detach() - z_btd).square().mean()
        quant_st = z_btd + (quant - z_btd).detach()  # straight-through
        recon = self.decoder_forward(quant_st.transpose(1, 2))
        recon_loss = (x - recon).square().mean()
        return recon_loss, commitment, recon, new_codebook, codes


def init_tree(gen, cfg: DVAEConfig, trainable: bool = False):
    """Seeded random encoder + codebook with the JAX package's init; with
    ``trainable`` the decoder and the EMA statistics too (``init_params``:
    cluster_size zero, embed_avg = embed)."""
    h = cfg.hidden_dim
    chans = [cfg.channels] + [h * 2 ** i for i in range(cfg.num_layers)]
    inner = chans[-1]

    def resblock():
        return {"conv1": init_conv1d(gen, inner, inner, 3),
                "conv2": init_conv1d(gen, inner, inner, 3),
                "conv3": init_conv1d(gen, inner, inner, 1)}

    tree = {"encoder": {
        "convs": [init_conv1d(gen, chans[i + 1], chans[i], cfg.kernel_size)
                  for i in range(cfg.num_layers)],
        "resblocks": [resblock() for _ in range(cfg.num_resnet_blocks)],
        "out": init_conv1d(gen, cfg.codebook_dim, inner, 1)}}
    if trainable:
        dec = [inner] + chans[:0:-1]  # e.g. [1024, 1024, 512]
        tree["decoder"] = {
            "inp": init_conv1d(gen, inner, cfg.codebook_dim, 1),
            "resblocks": [resblock() for _ in range(cfg.num_resnet_blocks)],
            "ups": [init_conv1d(gen, dec[i + 1], dec[i], cfg.kernel_size)
                    for i in range(cfg.num_layers)],
            "out": init_conv1d(gen, cfg.channels, dec[-1], 1)}
    embed = torch.randn(cfg.codebook_dim, cfg.num_tokens, generator=gen,
                        device=gen.device)
    tree["codebook"] = {"embed": embed}
    if trainable:
        tree["codebook"].update(cluster_size=torch.zeros(cfg.num_tokens, device=gen.device),
                                embed_avg=embed.clone())
    return tree
