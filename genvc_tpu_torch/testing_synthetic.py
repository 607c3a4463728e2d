"""Synthetic assets for a one-command smoke of the GPT training stage
(``genvc_tpu/testing_synthetic.py``, the GPT-stage part): a sine-plus-noise
dataset, frozen stage checkpoints in the reference torch formats at small
dims, and the config overrides of ``--smoke``.

Key names follow the reference trainers' state dicts, so the port's loaders
and converters are exercised end to end; with the same seed the files equal
the JAX package's.
"""

import os

import numpy as np
import torch

from genvc_tpu_torch.dsp.audio_io import write_wav

GPT_LAYERS = 2
GPT_DIM = 64
GPT_HEADS = 4
DVAE_HIDDEN = 16


def _r(*shape, std=0.05):
    return torch.randn(*shape) * std


def gpt_sd(prefix="gpt."):
    d = GPT_DIM
    sd = {}
    for i in range(GPT_LAYERS):
        p = f"{prefix}gpt.h.{i}."
        sd[p + "ln_1.weight"] = torch.ones(d)
        sd[p + "ln_1.bias"] = torch.zeros(d)
        sd[p + "attn.c_attn.weight"] = _r(d, 3 * d)
        sd[p + "attn.c_attn.bias"] = torch.zeros(3 * d)
        sd[p + "attn.c_proj.weight"] = _r(d, d)
        sd[p + "attn.c_proj.bias"] = torch.zeros(d)
        sd[p + "ln_2.weight"] = torch.ones(d)
        sd[p + "ln_2.bias"] = torch.zeros(d)
        sd[p + "mlp.c_fc.weight"] = _r(d, 4 * d)
        sd[p + "mlp.c_fc.bias"] = torch.zeros(4 * d)
        sd[p + "mlp.c_proj.weight"] = _r(4 * d, d)
        sd[p + "mlp.c_proj.bias"] = torch.zeros(d)
    sd[prefix + "gpt.ln_f.weight"] = torch.ones(d)
    sd[prefix + "gpt.ln_f.bias"] = torch.zeros(d)
    sd[prefix + "text_embedding.weight"] = _r(258, d)
    sd[prefix + "mel_embedding.weight"] = _r(1026, d)
    sd[prefix + "text_pos_embedding.emb.weight"] = _r(404, d, std=0.02)
    sd[prefix + "mel_pos_embedding.emb.weight"] = _r(608, d, std=0.02)
    sd[prefix + "final_norm.weight"] = torch.ones(d)
    sd[prefix + "final_norm.bias"] = torch.zeros(d)
    sd[prefix + "text_head.weight"] = _r(258, d)
    sd[prefix + "text_head.bias"] = torch.zeros(258)
    sd[prefix + "mel_head.weight"] = _r(1026, d)
    sd[prefix + "mel_head.bias"] = torch.zeros(1026)
    # perceiver
    pp = prefix + "conditioning_perceiver."
    dim_inner = 64 * 8
    ff_inner = int(d * 4 * 2 / 3)
    sd[pp + "proj_context.weight"] = _r(d, 80)
    sd[pp + "proj_context.bias"] = torch.zeros(d)
    sd[pp + "latents"] = _r(32, d, std=0.02)
    for i in range(4):
        sd[pp + f"layers.{i}.0.to_q.weight"] = _r(dim_inner, d)
        sd[pp + f"layers.{i}.0.to_kv.weight"] = _r(dim_inner * 2, d)
        sd[pp + f"layers.{i}.0.to_out.weight"] = _r(d, dim_inner)
        sd[pp + f"layers.{i}.1.0.weight"] = _r(ff_inner * 2, d)
        sd[pp + f"layers.{i}.1.0.bias"] = torch.zeros(ff_inner * 2)
        sd[pp + f"layers.{i}.1.2.weight"] = _r(d, ff_inner)
        sd[pp + f"layers.{i}.1.2.bias"] = torch.zeros(d)
    sd[pp + "norm.gamma"] = torch.ones(d)
    return sd


def dvae_sd(prefix, channels, num_tokens, codebook_dim=24, hidden=DVAE_HIDDEN):
    sd = {}
    enc_chans = [hidden, hidden * 2]

    def conv(name, o, i, k):
        sd[prefix + name + ".weight"] = _r(o, i, k)
        sd[prefix + name + ".bias"] = torch.zeros(o)

    def resblock(name, c):
        conv(name + ".net.0", c, c, 3)
        conv(name + ".net.2", c, c, 3)
        conv(name + ".net.4", c, c, 1)

    conv("encoder.0.0", enc_chans[0], channels, 3)
    conv("encoder.1.0", enc_chans[1], enc_chans[0], 3)
    for j in range(3):
        resblock(f"encoder.{2 + j}", enc_chans[1])
    conv("encoder.5", codebook_dim, enc_chans[1], 1)

    conv("decoder.0", enc_chans[1], codebook_dim, 1)
    for j in range(3):
        resblock(f"decoder.{1 + j}", enc_chans[1])
    conv("decoder.4.0.conv", enc_chans[1], enc_chans[1], 3)
    conv("decoder.5.0.conv", enc_chans[0], enc_chans[1], 3)
    conv("decoder.6", channels, enc_chans[0], 1)

    embed = torch.randn(codebook_dim, num_tokens)
    sd[prefix + "codebook.embed"] = embed
    sd[prefix + "codebook.cluster_size"] = torch.zeros(num_tokens)
    sd[prefix + "codebook.embed_avg"] = embed.clone()
    return sd


def contentvec_sd(prefix="content_extractor.model.", n_layers=2):
    sd = {}
    conv_specs = [(512, 1, 10)] + [(512, 512, 3)] * 4 + [(512, 512, 2)] * 2
    for i, (o, ic, k) in enumerate(conv_specs):
        sd[prefix + f"feature_extractor.conv_layers.{i}.0.weight"] = _r(o, ic, k, std=0.02)
    sd[prefix + "feature_extractor.conv_layers.0.2.weight"] = torch.ones(512)
    sd[prefix + "feature_extractor.conv_layers.0.2.bias"] = torch.zeros(512)
    sd[prefix + "layer_norm.weight"] = torch.ones(512)
    sd[prefix + "layer_norm.bias"] = torch.zeros(512)
    sd[prefix + "post_extract_proj.weight"] = _r(768, 512, std=0.02)
    sd[prefix + "post_extract_proj.bias"] = torch.zeros(768)
    # pos conv weight-normed on dim=2 (fairseq)
    v = _r(768, 48, 128, std=0.02)
    g = torch.ones(1, 1, 128)
    sd[prefix + "encoder.pos_conv.0.weight_g"] = g
    sd[prefix + "encoder.pos_conv.0.weight_v"] = v
    sd[prefix + "encoder.pos_conv.0.bias"] = torch.zeros(768)
    sd[prefix + "encoder.layer_norm.weight"] = torch.ones(768)
    sd[prefix + "encoder.layer_norm.bias"] = torch.zeros(768)
    for i in range(n_layers):
        p = prefix + f"encoder.layers.{i}."
        for name, (o, ic) in (("self_attn.q_proj", (768, 768)),
                              ("self_attn.k_proj", (768, 768)),
                              ("self_attn.v_proj", (768, 768)),
                              ("self_attn.out_proj", (768, 768)),
                              ("fc1", (3072, 768)), ("fc2", (768, 3072))):
            sd[p + name + ".weight"] = _r(o, ic, std=0.02)
            sd[p + name + ".bias"] = torch.zeros(o)
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            sd[p + name + ".weight"] = torch.ones(768)
            sd[p + name + ".bias"] = torch.zeros(768)
    sd[prefix + "final_proj.weight"] = _r(256, 768, std=0.02)
    sd[prefix + "final_proj.bias"] = torch.zeros(256)
    return sd


def make_sine_dataset(out_dir, n=8, sr=24000, dur=1.6):
    """Write n sine-plus-noise wavs and a `path|spk` metafile; returns the
    metafile path."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    meta = os.path.join(out_dir, "meta.txt")
    with open(meta, "w") as f:
        for i in range(n):
            t = np.arange(int(sr * dur)) / sr
            wav = (0.3 * np.sin(2 * np.pi * (200 + 40 * i) * t)
                   + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
            p = os.path.join(out_dir, f"w{i}.wav")
            write_wav(p, wav, sr)
            f.write(f"{p}|spk{i % 2}\n")
    return meta


def write_stage_ckpts(out_dir):
    """Write synthetic frozen-stage checkpoints (contentvec / both dVAEs /
    GPT) in the reference torch formats; returns their paths as a dict."""
    os.makedirs(out_dir, exist_ok=True)
    torch.manual_seed(0)
    paths = {
        "contentvec": os.path.join(out_dir, "contentvec.pt"),
        "acoustic_dvae": os.path.join(out_dir, "acoustic_dvae.pth"),
        "content_dvae": os.path.join(out_dir, "content_dvae.pth"),
        "gpt": os.path.join(out_dir, "gpt.pth"),
    }
    torch.save({"model": contentvec_sd(prefix="", n_layers=1)},
               paths["contentvec"])
    torch.save(dvae_sd("", 80, 64), paths["acoustic_dvae"])
    torch.save(dvae_sd("", 256, 36), paths["content_dvae"])
    torch.save({"model": gpt_sd(prefix="gpt."), "config": {}}, paths["gpt"])
    return paths


def smoke_overrides(cfg, assets_dir):
    """Shrink a GPT-stage config in place for a 2-step smoke run: tiny model
    dims matching the synthetic checkpoints, synthetic data, batch 2."""
    meta = make_sine_dataset(assets_dir)
    paths = write_stage_ckpts(assets_dir)
    cfg.train_metafile = meta
    cfg.test_metafile = meta
    cfg.batch_size = 2
    cfg.eval_batch_size = 2
    cfg.num_loader_workers = 2
    cfg.epochs = 1
    cfg.print_step = 1
    cfg.save_step = 100
    cfg.contentvec_model_path = paths["contentvec"]
    cfg.acoustic_dvae_checkpoint = paths["acoustic_dvae"]
    cfg.content_dvae_checkpoint = paths["content_dvae"]
    ma = cfg.model_args
    ma.gpt_layers, ma.gpt_n_model_channels, ma.gpt_n_heads = (
        GPT_LAYERS, GPT_DIM, GPT_HEADS)
    ma.min_text_length, ma.max_text_length = 2, 4
    ma.min_conditioning_length, ma.max_conditioning_length = 24000, 36000
    ma.mel_norm_file = None
    vae_kw = dict(codebook_dim=24, hidden_dim=DVAE_HIDDEN,
                  num_resnet_blocks=3, kernel_size=3, num_layers=2)
    for k, v in dict(num_channels=80, num_tokens=64, **vae_kw).items():
        setattr(cfg.acoustic_dvae_config, k, v)
    for k, v in dict(num_channels=256, num_tokens=36, **vae_kw).items():
        setattr(cfg.content_dvae_config, k, v)
    return cfg
