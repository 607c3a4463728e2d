"""HiFi-GAN vocoder generator and the four discriminator families
(``genvc_tpu/models/hifigan.py``).

Generator: conv_pre(k7) -> per upsample stage [leaky(0.1) -> ConvTranspose1d
-> mean of the stage's resblocks] -> leaky(0.01) -> conv_post(k7) -> tanh.
For inference weight norm is folded at load; ``Generator(cfg,
weight_norm=True)`` keeps torch's (g, v) so the training gradients are the
reference's reparametrized ones. ``valid_len`` (input frames) re-zeroes
activations beyond the scaled valid length after every conv so the valid
samples of a zero-padded input match an exact-length run.

Discriminators (training only; each family's ``forward(y, y_hat)`` returns
(logits_r, logits_g, fmap_r, fmap_g)): MSD (3 scales, avg-pool 4/2 between;
the first scale's convs spectral-normed, the others weight-normed), MPD
(periods 2, 3, 5, 7, 11; reflect pad to a multiple of the period), MS-STFT
(normalized complex STFT at 1024 / 2048 / 512) and MS-SB-CQT (octave-banked
CQT, per-octave pre-convs). ``sn_update=True`` (training forwards) advances
the spectral-norm power iteration once per sub-forward, over y and then
y_hat, as torch's train-mode forwards do; the buffers are not parameters,
so no optimizer touches them. ``compute_dtype`` (bf16) runs the conv stacks
in that dtype; the STFT / CQT front ends stay f32 and the losses upcast.
"""

from __future__ import annotations

import torch
from torch import nn

import torch.nn.functional as F

from genvc_tpu_torch.config import VocoderConfig
from genvc_tpu_torch.dsp import cqt as cqt_mod, mel as mel_mod
from genvc_tpu_torch.dsp.resample import resample
from genvc_tpu_torch.ops.conv import Conv1d, Conv2d, init_conv1d, leaky_relu, to_weight_norm

LRELU_SLOPE = 0.1


def get_padding(kernel_size, dilation=1):
    return int((kernel_size * dilation - dilation) / 2)


def _mask_t(x, valid_len):
    if valid_len is None:
        return x
    return x * (torch.arange(x.shape[-1], device=x.device)[None, None, :] < valid_len)


class ResBlock2(nn.Module):
    def __init__(self, ch, kernel, dilations, norm=None):
        super().__init__()
        self.kernel, self.dilations = kernel, list(dilations)
        self.convs = nn.ModuleList(Conv1d(ch, ch, kernel, norm=norm) for _ in dilations)

    def forward(self, x, valid_len=None):
        for conv, d in zip(self.convs, self.dilations):
            xt = _mask_t(leaky_relu(x, LRELU_SLOPE), valid_len)
            x = conv(xt, padding=get_padding(self.kernel, d), dilation=d) + x
        return x


class ResBlock1(nn.Module):
    def __init__(self, ch, kernel, dilations, norm=None):
        super().__init__()
        self.kernel, self.dilations = kernel, list(dilations)
        self.convs1 = nn.ModuleList(Conv1d(ch, ch, kernel, norm=norm) for _ in dilations)
        self.convs2 = nn.ModuleList(Conv1d(ch, ch, kernel, norm=norm) for _ in dilations)

    def forward(self, x, valid_len=None):
        for c1, c2, d in zip(self.convs1, self.convs2, self.dilations):
            xt = _mask_t(leaky_relu(x, LRELU_SLOPE), valid_len)
            xt = c1(xt, padding=get_padding(self.kernel, d), dilation=d)
            xt = _mask_t(leaky_relu(xt, LRELU_SLOPE), valid_len)
            x = c2(xt, padding=get_padding(self.kernel, 1)) + x
        return x


class Generator(nn.Module):
    """Folded weights (``w``), or with ``weight_norm`` torch's (g, v) form of
    every conv (``init_generator(weight_normed=True)``)."""

    def __init__(self, cfg: VocoderConfig, weight_norm: bool = False):
        super().__init__()
        self.cfg = cfg
        norm = "weight" if weight_norm else None
        ch0 = cfg.upsample_initial_channel
        block = ResBlock1 if cfg.resblock_type == "1" else ResBlock2
        self.conv_pre = Conv1d(cfg.input_feat_dim, ch0, 7, norm=norm)
        ups, resblocks = [], []
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernal_sizes)):
            out_c = ch0 // (2 ** (i + 1))
            ups.append(Conv1d(ch0 // (2 ** i), out_c, k, transpose=True, norm=norm))
            for kr, dil in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                resblocks.append(block(out_c, kr, dil, norm))
        self.ups = nn.ModuleList(ups)
        self.resblocks = nn.ModuleList(resblocks)
        self.conv_post = Conv1d(ch0 // (2 ** len(cfg.upsample_rates)), 1, 7, norm=norm)

    def forward(self, x, valid_len=None):
        """(B, input_feat_dim, T) -> (B, 1, T*256) waveform in [-1, 1]."""
        cfg = self.cfg
        x = self.conv_pre(_mask_t(x, valid_len), padding=3)
        n_kernels = len(cfg.resblock_kernel_sizes)
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernal_sizes)):
            x = _mask_t(leaky_relu(x, LRELU_SLOPE), valid_len)
            x = self.ups[i](x, stride=u, padding=(k - u) // 2)
            if valid_len is not None:
                valid_len = valid_len * u
                x = _mask_t(x, valid_len)
            xs = None
            for j in range(n_kernels):
                y = self.resblocks[i * n_kernels + j](x, valid_len)
                xs = y if xs is None else xs + y
            x = xs / n_kernels
        x = _mask_t(leaky_relu(x, 0.01), valid_len)
        return torch.tanh(self.conv_post(x, padding=3))


def init_tree(gen, cfg: VocoderConfig):
    """Seeded random (folded) generator parameters with the JAX package's
    init (``hifigan.init_generator``)."""
    ch0 = cfg.upsample_initial_channel
    tree = {"conv_pre": init_conv1d(gen, ch0, cfg.input_feat_dim, 7, std=0.01)}
    ups, resblocks = [], []
    for i, k in enumerate(cfg.upsample_kernal_sizes):
        in_c, out_c = ch0 // (2 ** i), ch0 // (2 ** (i + 1))
        ups.append({"w": torch.randn(in_c, out_c, k, generator=gen, device=gen.device) * 0.01,
                    "b": torch.zeros(out_c, device=gen.device)})
        for kr, dil in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            convs = [init_conv1d(gen, out_c, out_c, kr, std=0.01) for _ in dil]
            if cfg.resblock_type == "1":
                resblocks.append({"convs1": convs, "convs2": [
                    init_conv1d(gen, out_c, out_c, kr, std=0.01) for _ in dil]})
            else:
                resblocks.append({"convs": convs})
    tree["ups"] = ups
    tree["resblocks"] = resblocks
    tree["conv_post"] = init_conv1d(gen, 1, ch0 // (2 ** len(cfg.upsample_rates)), 7,
                                    std=0.01)
    return tree


def generator_to_weight_norm(tree):
    """A folded generator tree -> torch weight_norm's (g, v) form of every conv."""
    def rec(node):
        if isinstance(node, dict):
            return to_weight_norm(node) if "w" in node else {k: rec(v) for k, v in node.items()}
        return [rec(v) for v in node]
    return rec(tree)


# ---------------------------------------------------------------------------
# Discriminators


class DiscriminatorS(nn.Module):
    # (out, in, kernel, stride, groups, padding)
    SPECS = [(128, 1, 15, 1, 1, 7), (128, 128, 41, 2, 4, 20), (256, 128, 41, 2, 16, 20),
             (512, 256, 41, 4, 16, 20), (1024, 512, 41, 4, 16, 20),
             (1024, 1024, 41, 1, 16, 20), (1024, 1024, 5, 1, 1, 2)]

    def __init__(self, use_spectral_norm=False):
        super().__init__()
        norm = "spectral" if use_spectral_norm else "weight"
        self.convs = nn.ModuleList(Conv1d(i, o, k, groups=g, norm=norm)
                                   for o, i, k, _, g, _ in self.SPECS)
        self.conv_post = Conv1d(1024, 1, 3, norm=norm)

    def forward(self, x, sn_update=False):
        fmap = []
        for conv, (*_, s, g, pad) in zip(self.convs, self.SPECS):
            x = leaky_relu(conv(x, stride=s, padding=pad, sn_update=sn_update), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x, padding=1, sn_update=sn_update)
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


def _pair_forward(discs, args, y, y_hat, **kw):
    """Each discriminator on y, then on y_hat: (logits_r, logits_g, fmap_r,
    fmap_g)."""
    out = ([], [], [], [])
    for d, a in zip(discs, args):
        lr, fr = d(y, *a, **kw)
        lg, fg = d(y_hat, *a, **kw)
        for acc, v in zip(out, (lr, lg, fr, fg)):
            acc.append(v)
    return out


class MultiScaleDiscriminator(nn.Module):
    def __init__(self):
        super().__init__()
        # the first scale spectral-normed, like the reference (hifigan.py:286-288)
        self.discs = nn.ModuleList([DiscriminatorS(True), DiscriminatorS(), DiscriminatorS()])

    def forward(self, y, y_hat, compute_dtype=None, sn_update=False):
        if compute_dtype is not None:
            y, y_hat = y.to(compute_dtype), y_hat.to(compute_dtype)
        out = ([], [], [], [])
        for i, d in enumerate(self.discs):
            if i:  # torch AvgPool1d(4, 2, padding=2): zero pads count
                y, y_hat = F.avg_pool1d(y, 4, 2, 2), F.avg_pool1d(y_hat, 4, 2, 2)
            for acc, v in zip(out, _pair_forward([d], [()], y, y_hat, sn_update=sn_update)):
                acc.extend(v)
        return out


class DiscriminatorP(nn.Module):
    def __init__(self, period, d_mult=1, use_spectral_norm=False):
        super().__init__()
        self.period = period
        norm = "spectral" if use_spectral_norm else "weight"
        c = [1] + [int(n * d_mult) for n in (32, 128, 512, 1024, 1024)]
        self.convs = nn.ModuleList(Conv2d(c[i], c[i + 1], 5, 1, norm=norm) for i in range(5))
        self.conv_post = Conv2d(c[-1], 1, 3, 1, norm=norm)

    def forward(self, x, sn_update=False):
        b, ch, t = x.shape
        if t % self.period:
            n_pad = self.period - t % self.period
            x = F.pad(x, (0, n_pad), mode="reflect")
            t += n_pad
        x = x.reshape(b, ch, t // self.period, self.period)
        fmap = []
        for i, conv in enumerate(self.convs):
            x = conv(x, stride=(3, 1) if i < 4 else (1, 1), padding=(2, 0),
                     sn_update=sn_update)
            x = leaky_relu(x, LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x, padding=(1, 0), sn_update=sn_update)
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods=(2, 3, 5, 7, 11), d_mult=1, use_spectral_norm=False):
        super().__init__()
        self.discs = nn.ModuleList(DiscriminatorP(p, d_mult, use_spectral_norm)
                                   for p in periods)

    def forward(self, y, y_hat, compute_dtype=None, sn_update=False):
        if compute_dtype is not None:
            y, y_hat = y.to(compute_dtype), y_hat.to(compute_dtype)
        return _pair_forward(self.discs, [()] * len(self.discs), y, y_hat,
                             sn_update=sn_update)


def get_2d_padding(kernel_size, dilation=(1, 1)):
    return (((kernel_size[0] - 1) * dilation[0]) // 2,
            ((kernel_size[1] - 1) * dilation[1]) // 2)


class _SpectralConvStack(nn.Module):
    """The conv stack shared by the STFT and CQT discriminators (the
    reference's ``NormConv2d`` stack): an unnormed first conv, one
    weight-normed conv per dilation (stride 2 over frequency), a square
    weight-normed conv, then ``conv_post``."""

    def __init__(self, in_chs, filters, max_filters, filters_scale, dilations, kernel,
                 out_channels, slope):
        super().__init__()
        self.dilations, self.kernel, self.slope = tuple(dilations), tuple(kernel), slope
        convs = [Conv2d(in_chs, filters, *kernel)]
        c = min(filters_scale * filters, max_filters)
        for i in range(len(dilations)):
            out_c = min(filters_scale ** (i + 1) * filters, max_filters)
            convs.append(Conv2d(c, out_c, *kernel, norm="weight"))
            c = out_c
        out_c = min(filters_scale ** (len(dilations) + 1) * filters, max_filters)
        convs.append(Conv2d(c, out_c, kernel[0], kernel[0], norm="weight"))
        self.convs = nn.ModuleList(convs)
        self.conv_post = Conv2d(out_c, out_channels, kernel[0], kernel[0], norm="weight")

    def stack(self, z):
        k = self.kernel
        square = (k[0], k[0])
        geometry = ([(get_2d_padding(k), (1, 1), (1, 1))]
                    + [(get_2d_padding(k, (d, 1)), (1, 2), (d, 1)) for d in self.dilations]
                    + [(get_2d_padding(square), (1, 1), (1, 1))])
        fmap = []
        for conv, (pad, st, dl) in zip(self.convs, geometry):
            z = leaky_relu(conv(z, stride=st, padding=pad, dilation=dl), self.slope)
            fmap.append(z)
        z = self.conv_post(z, padding=get_2d_padding(square))
        return z.reshape(z.shape[0], -1), fmap


class DiscriminatorSTFT(_SpectralConvStack):
    def __init__(self, filters, n_fft, hop, win, dilations=(1, 2, 4), kernel=(3, 9),
                 max_filters=1024, filters_scale=1):
        super().__init__(2, filters, max_filters, filters_scale, dilations, kernel, 1,
                         slope=0.2)  # LeakyReLU(0.2) (hifigan.py:464)
        self.n_fft, self.hop, self.win = n_fft, hop, win

    def forward(self, x, compute_dtype=None):
        """x: (B, 1, T) -> normalized complex STFT as a (B, 2, frames, freqs)
        image -> the conv stack."""
        re, im = mel_mod.stft_complex(x[:, 0, :], self.n_fft, self.hop, self.win)
        z = torch.stack([re, im], dim=1).transpose(2, 3)
        if compute_dtype is not None:
            z = z.to(compute_dtype)
        return self.stack(z)


MSSTFTD_SPECS = tuple(
    {"n_fft": n, "hop": h, "win": w, "dilations": (1, 2, 4), "kernel": (3, 9)}
    for n, h, w in zip((1024, 2048, 512), (256, 512, 256), (1024, 2048, 512)))


class MultiScaleSTFTDiscriminator(nn.Module):
    """One STFT discriminator per resolution of ``MSSTFTD_SPECS``."""

    def __init__(self, filters=32):
        super().__init__()
        self.discs = nn.ModuleList(
            DiscriminatorSTFT(filters, s["n_fft"], s["hop"], s["win"], s["dilations"],
                              s["kernel"]) for s in MSSTFTD_SPECS)

    def forward(self, y, y_hat, compute_dtype=None, sn_update=False):
        return _pair_forward(self.discs, [(compute_dtype,)] * len(self.discs), y, y_hat)


class DiscriminatorCQT(_SpectralConvStack):
    def __init__(self, cfg: VocoderConfig, hop, n_octaves, bins_per_octave):
        kernel = (3, 9)
        c2 = cfg.mssbcqtd_in_channels * 2
        super().__init__(c2, cfg.mssbcqtd_filters, cfg.mssbcqtd_max_filters,
                         cfg.mssbcqtd_filters_scale, cfg.mssbcqtd_dilations, kernel,
                         cfg.mssbcqtd_out_channels, slope=LRELU_SLOPE)
        self.conv_pres = nn.ModuleList(Conv2d(c2, c2, *kernel) for _ in range(n_octaves))
        self.sample_rate, self.hop = cfg.sample_rate, hop
        self.n_octaves, self.bins = n_octaves, bins_per_octave

    def conv_pres_forward(self, z):
        """The per-octave pre-convs (reference hifigan.py:738-748), each on its
        own band of ``bins`` with zero padding at the band's edges, as one
        grouped conv: (B, 2, T, n_oct * bins) -> same shape."""
        b, c, t, _ = z.shape
        o, bins = self.n_octaves, self.bins
        zb = z.reshape(b, c, t, o, bins).permute(0, 3, 1, 2, 4).reshape(b, o * c, t, bins)
        w = torch.cat([p.w for p in self.conv_pres]).to(z.dtype)
        bias = torch.cat([p.b for p in self.conv_pres]).to(z.dtype)
        out = F.conv2d(zb, w, bias, padding=get_2d_padding(self.kernel), groups=o)
        return out.reshape(b, o, c, t, bins).permute(0, 2, 3, 1, 4).reshape(b, c, t, o * bins)

    def forward(self, x, compute_dtype=None):
        sr = self.sample_rate
        xs = resample(x[:, 0, :], sr, sr * 2)  # the reference resamples x2 first
        z = cqt_mod.cqt2010(xs, sr * 2, self.hop, self.n_octaves, self.bins)
        z = z.permute(0, 3, 2, 1)  # (B, n_bins, T, 2) -> (B, 2, T, n_bins)
        if compute_dtype is not None:  # the CQT front end stays f32
            z = z.to(compute_dtype)
        return self.stack(self.conv_pres_forward(z))


class MultiScaleSubbandCQTDiscriminator(nn.Module):
    def __init__(self, cfg: VocoderConfig):
        super().__init__()
        self.discs = nn.ModuleList(
            DiscriminatorCQT(cfg, hop, n_oct, bins) for hop, n_oct, bins in zip(
                cfg.mssbcqtd_hop_lengths, cfg.mssbcqtd_n_octavess,
                cfg.mssbcqtd_bins_per_octave))

    def forward(self, y, y_hat, compute_dtype=None, sn_update=False):
        return _pair_forward(self.discs, [(compute_dtype,)] * len(self.discs), y, y_hat)


FAMILIES = {"MSD_Discriminator": "msd", "MPD_Discriminator": "mpd",
            "MSTFT_Discriminator": "msstftd", "MSCQT_Discriminator": "mssbcqtd"}
ALL_FAMILIES = tuple(FAMILIES)


class Discriminators(nn.Module):
    """The four families under the JAX tree's keys ``msd``, ``mpd``,
    ``msstftd`` and ``mssbcqtd``; its forward is the JAX package's
    ``vocoder_stage.run_discriminators``."""

    def __init__(self, cfg: VocoderConfig):
        super().__init__()
        self.msd = MultiScaleDiscriminator()
        self.mpd = MultiPeriodDiscriminator(
            tuple(cfg.mpd_reshapes), cfg.mpd_discriminator_channel_mult_factor,
            cfg.mpd_use_spectral_norm)
        self.msstftd = MultiScaleSTFTDiscriminator(cfg.msstftd_filters)
        self.mssbcqtd = MultiScaleSubbandCQTDiscriminator(cfg)

    def forward(self, y, y_hat, compute_dtype=None, sn_update=False, families=ALL_FAMILIES):
        """name -> (logits_r, logits_g, fmap_r, fmap_g) for each family named
        in ``families`` (keys of :data:`FAMILIES`); ``sn_update`` advances the
        spectral-norm buffers of MSD (and MPD when spectral) once per
        sub-forward."""
        return {name: getattr(self, FAMILIES[name])(y, y_hat, compute_dtype=compute_dtype,
                                                    sn_update=sn_update)
                for name in families}
