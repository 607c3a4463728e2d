"""Per-family activation diff of a GenVC ``.pth`` bundle: the port's modules
against torch replicas of the reference's architecture
(``tools/verify_bundle.py``, with the port in place of the JAX package).

Usage:
    python -m genvc_tpu_torch.tools.verify_bundle path/to/GenVC_small.pth \
        [--families gpt,...] [--device cuda]

For each model family in the bundle (the GPT core, the Perceiver, the
acoustic and content dVAEs, the HiFi-GAN generator, ContentVec) the tool

1. converts the family's weights with :mod:`genvc_tpu_torch.checkpoint` (the
   path inference takes) and loads them into the port's module on
   ``--device``,
2. loads the SAME weights into a torch replica of the reference architecture
   on the CPU (HF ``GPT2Model`` / ``HubertModel`` where the reference itself
   wraps them, layers/gpt.py:42-84 and content_processor.py:7-34; small
   inline replicas of the reference's dVAE, HiFi-GAN and Perceiver
   otherwise),
3. runs both on seeded random probe inputs and prints the largest absolute
   difference of their outputs.

The GPT and ContentVec oracles need ``transformers``, imported when those
families are checked. Exit status is non-zero if any family exceeds its
tolerance.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from genvc_tpu_torch import checkpoint, resolve_device
from genvc_tpu_torch.config import GenVCConfig
from genvc_tpu_torch.models import contentvec, dvae, gpt as gpt_model, hifigan, perceiver

# thresholds: f32 activation diffs through each family's depth; contentvec is
# looser (HF vs fairseq-style math differs in gelu/softmax kernels)
TOLERANCES = {
    "gpt": 5e-4,
    "perceiver": 5e-4,
    "acoustic_dvae": 2e-4,
    "content_dvae": 2e-4,
    "hifigan": 2e-4,
    "contentvec": 2e-3,
}


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _module(cls_call, tree, device):
    """A port module built on the meta device, then given ``tree``."""
    with torch.device("meta"):
        m = cls_call()
    checkpoint.assign(m, tree, device)
    return m.eval()


def _np(x):
    return x.detach().float().cpu().numpy()


# --------------------------------------------------------------------- gpt


def verify_gpt(sd, tree, cfg, device):
    """GPT-2 core: HF GPT2Model (the reference backbone, gpt.py:42-84) with
    the bundle's transformer weights vs the port's ``core_forward``."""
    from transformers import GPT2Config, GPT2Model

    ma = cfg.model_args
    core_sd = _strip(sd, "gpt.gpt.")
    n_layers = max(int(k.split(".")[1]) for k in core_sd if k.startswith("h.")) + 1
    d = core_sd["ln_f.weight"].shape[0]
    hf = GPT2Model(GPT2Config(
        vocab_size=8, n_positions=2048, n_embd=d, n_layer=n_layers,
        n_head=ma.gpt_n_heads, use_cache=False, attn_implementation="eager")).eval()
    _, unexpected = hf.load_state_dict(dict(core_sd), strict=False)
    unexpected = [k for k in unexpected if not k.endswith(("attn.bias", "attn.masked_bias"))]
    assert not unexpected, f"unmapped torch keys: {unexpected[:5]}"
    with torch.no_grad():
        hf.wpe.weight.zero_()  # reference nulls the global wpe (gpt.py:67-69)
        hf.wte.weight.zero_()

    gcfg = gpt_model.GPTConfig(layers=n_layers, model_dim=d, heads=ma.gpt_n_heads)
    core = _module(lambda: gpt_model.Core(gcfg), tree["gpt"]["core"], device)
    rng = np.random.default_rng(0)
    emb = (rng.standard_normal((2, 21, d)) * 0.3).astype(np.float32)
    with torch.no_grad():
        ref = hf(inputs_embeds=torch.from_numpy(emb)).last_hidden_state.numpy()
        got = _np(gpt_model.core_forward(core, torch.from_numpy(emb).to(device), gcfg))
    return float(np.abs(got - ref).max())


def verify_perceiver(sd, tree, cfg, device):
    """Perceiver resampler math replica in torch (reference
    layers/perceiver_encoder.py:225-319) vs the port's ``Perceiver``."""
    import torch.nn.functional as F

    p = _strip(sd, "gpt.conditioning_perceiver.")
    p = {k: torch.as_tensor(np.asarray(v)) for k, v in p.items()}
    d = p["latents"].shape[1]
    depth = max(int(k.split(".")[1]) for k in p if k.startswith("layers.")) + 1
    heads = 8

    rng = np.random.default_rng(2)
    x_np = (rng.standard_normal((2, 23, p["proj_context.weight"].shape[1]))).astype(np.float32)
    with torch.no_grad():
        x = torch.from_numpy(x_np)
        px = x @ p["proj_context.weight"].T + p["proj_context.bias"]
        lat = p["latents"][None].expand(x.shape[0], -1, -1).clone()
        for i in range(depth):
            ctx = torch.cat([lat, px], dim=1)
            q = lat @ p[f"layers.{i}.0.to_q.weight"].T
            kv = ctx @ p[f"layers.{i}.0.to_kv.weight"].T
            k, v = kv.chunk(2, dim=-1)

            def sh(t):
                b, n, dd = t.shape
                return t.view(b, n, heads, dd // heads).transpose(1, 2)

            qh, kh, vh = sh(q), sh(k), sh(v)
            sim = qh @ kh.transpose(-1, -2) * (qh.shape[-1] ** -0.5)
            out = (sim.softmax(dim=-1) @ vh).transpose(1, 2).reshape(
                lat.shape[0], lat.shape[1], -1)
            lat = out @ p[f"layers.{i}.0.to_out.weight"].T + lat
            h = lat @ p[f"layers.{i}.1.0.weight"].T + p[f"layers.{i}.1.0.bias"]
            val, gate = h.chunk(2, dim=-1)
            h = F.gelu(gate) * val
            lat = h @ p[f"layers.{i}.1.2.weight"].T + p[f"layers.{i}.1.2.bias"] + lat
        ref = (F.normalize(lat, dim=-1) * (d ** 0.5) * p["norm.gamma"]).numpy()
        model = _module(lambda: perceiver.Perceiver(dim=d, depth=depth, heads=heads),
                        tree["gpt"]["perceiver"], device)
        got = _np(model(torch.from_numpy(x_np).to(device)))
    return float(np.abs(got - ref).max())


# -------------------------------------------------------------------- dvae


def _build_torch_dvae(dcfg):
    """Reference DiscreteVAE encoder/decoder modules (layers/dvae.py:236-292,
    use_transposed_convs=False) with state-dict-compatible key names."""
    import torch.nn as tnn
    import torch.nn.functional as F

    class ResBlock(tnn.Module):
        def __init__(self, c, k):
            super().__init__()
            pad = k // 2
            self.net = tnn.Sequential(
                tnn.Conv1d(c, c, k, padding=pad), tnn.ReLU(),
                tnn.Conv1d(c, c, k, padding=pad), tnn.ReLU(),
                tnn.Conv1d(c, c, 1))

        def forward(self, x):
            return self.net(x) + x

    class UpConv(tnn.Module):
        def __init__(self, i, o, k, pad):
            super().__init__()
            self.conv = tnn.Conv1d(i, o, k, padding=pad)

        def forward(self, x):
            return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))

    k = dcfg.kernel_size
    pad = k // 2
    hid = dcfg.hidden_dim
    chans = [hid * 2 ** i for i in range(dcfg.num_layers)]
    enc = []
    in_c = dcfg.channels
    for c in chans:
        enc.append(tnn.Sequential(tnn.Conv1d(in_c, c, k, stride=2, padding=pad),
                                  tnn.ReLU()))
        in_c = c
    for _ in range(dcfg.num_resnet_blocks):
        enc.append(ResBlock(in_c, k))
    enc.append(tnn.Conv1d(in_c, dcfg.codebook_dim, 1))
    encoder = tnn.Sequential(*enc)

    dec = [tnn.Conv1d(dcfg.codebook_dim, in_c, 1)]
    for _ in range(dcfg.num_resnet_blocks):
        dec.append(ResBlock(in_c, k))
    # reference dec_chans repeat the innermost channel once (dvae.py:
    # dec_chans = [dec_chans[0], *dec_chans]): e.g. [32, 32, 16]
    rev = list(reversed(chans))
    io = [rev[0]] + rev
    for i in range(len(rev)):
        dec.append(tnn.Sequential(UpConv(io[i], io[i + 1], k, pad),
                                  tnn.ReLU()))
    dec.append(tnn.Conv1d(io[-1], dcfg.channels, 1))
    decoder = tnn.Sequential(*dec)
    return encoder, decoder


def verify_dvae(sd, tree, cfg, which, device):
    import torch.nn.functional as F

    sub = _strip(sd, which + ".")
    c = cfg.acoustic_dvae_config if which == "acoustic_dvae" else cfg.content_dvae_config
    dcfg = checkpoint.dvae_config(c)
    encoder, decoder = _build_torch_dvae(dcfg)
    encoder.load_state_dict(_strip(sub, "encoder."))
    decoder.load_state_dict(_strip(sub, "decoder."))
    embed = torch.as_tensor(np.asarray(sub["codebook.embed"]))

    t = tree[which]
    model = _module(lambda: dvae.DVAE(dcfg, decoder=True),
                    {"encoder": t["encoder"], "decoder": t["decoder"],
                     "codebook": {"embed": t["codebook"]["embed"]}}, device)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, dcfg.channels, 48)) * 0.5).astype(np.float32)
    with torch.no_grad():
        enc_ref = encoder(torch.from_numpy(x))
        flat = enc_ref.permute(0, 2, 1).reshape(-1, dcfg.codebook_dim)
        dist = flat.pow(2).sum(1, keepdim=True) - 2 * flat @ embed \
            + embed.pow(2).sum(0, keepdim=True)
        codes_ref = (-dist).max(1)[1].view(2, -1)
        emb = F.embedding(codes_ref, embed.T).permute(0, 2, 1)
        dec_ref = decoder(emb).numpy()
        xd = torch.from_numpy(x).to(device)
        enc_got = _np(model.encode(xd))
        codes_got = model.get_codebook_indices(xd).cpu().numpy()
        dec_got = _np(model.decode(codes_ref.to(device)))
    code_mismatch = int((codes_got != codes_ref.numpy()).sum())
    diff = max(float(np.abs(enc_got - enc_ref.numpy()).max()),
               float(np.abs(dec_got - dec_ref).max()))
    if code_mismatch:
        print(f"  WARNING {which}: {code_mismatch} VQ indices flipped "
              "(borderline distances or conversion bug)")
        diff = max(diff, 1.0)
    return diff


# ------------------------------------------------------------------ hifigan


def verify_hifigan(sd, tree, cfg, device):
    import torch.nn as tnn
    import torch.nn.functional as F
    from torch.nn.utils import weight_norm

    vc = cfg.vocoder_config
    sub = _strip(sd, "hifigan.")

    class TorchGen(tnn.Module):
        def __init__(self):
            super().__init__()
            ch0 = vc.upsample_initial_channel
            self.conv_pre = weight_norm(tnn.Conv1d(
                vc.input_feat_dim, ch0, 7, 1, padding=3))
            self.ups = tnn.ModuleList()
            self.resblocks = tnn.ModuleList()
            for i, (u, k) in enumerate(zip(vc.upsample_rates,
                                           vc.upsample_kernal_sizes)):
                self.ups.append(weight_norm(tnn.ConvTranspose1d(
                    ch0 // (2 ** i), ch0 // (2 ** (i + 1)), k, u,
                    padding=(k - u) // 2)))
                ch = ch0 // (2 ** (i + 1))
                for kr, dil in zip(vc.resblock_kernel_sizes,
                                   vc.resblock_dilation_sizes):
                    block = tnn.Module()
                    block.convs = tnn.ModuleList(
                        [weight_norm(tnn.Conv1d(
                            ch, ch, kr, 1, dilation=d,
                            padding=hifigan.get_padding(kr, d)))
                         for d in dil])
                    self.resblocks.append(block)
            self.conv_post = weight_norm(tnn.Conv1d(
                ch0 // (2 ** len(vc.upsample_rates)), 1, 7, 1, padding=3))

        def forward(self, x):
            x = self.conv_pre(x)
            nk = len(vc.resblock_kernel_sizes)
            for i, up in enumerate(self.ups):
                x = F.leaky_relu(x, 0.1)
                x = up(x)
                xs = None
                for j in range(nk):
                    y = x
                    for conv in self.resblocks[i * nk + j].convs:
                        yt = F.leaky_relu(y, 0.1)
                        y = conv(yt) + y
                    xs = y if xs is None else xs + y
                x = xs / nk
            x = F.leaky_relu(x)
            return torch.tanh(self.conv_post(x))

    gen = TorchGen().eval()
    gen.load_state_dict(sub)
    model = _module(lambda: hifigan.Generator(vc), tree["hifigan"], device)
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((1, vc.input_feat_dim, 16)) * 0.3).astype(np.float32)
    with torch.no_grad():
        ref = gen(torch.from_numpy(x)).numpy()
        got = _np(model(torch.from_numpy(x).to(device)))
    return float(np.abs(got - ref).max())


# --------------------------------------------------------------- contentvec


def fairseq_to_hf_hubert_sd(sd: dict) -> dict:
    """fairseq HuBERT keys -> transformers HubertModel keys (pos_conv mapped onto the parametrized
    weight-norm storage)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("feature_extractor.conv_layers."):
            i = k.split(".")[2]
            if k.endswith(".0.weight"):
                out[f"feature_extractor.conv_layers.{i}.conv.weight"] = v
            elif k.endswith(".0.bias"):
                out[f"feature_extractor.conv_layers.{i}.conv.bias"] = v
            elif ".2." in k:
                out[f"feature_extractor.conv_layers.{i}.layer_norm."
                    f"{k.split('.')[-1]}"] = v
        elif k.startswith("layer_norm."):
            out["feature_projection.layer_norm." + k.split(".")[-1]] = v
        elif k.startswith("post_extract_proj."):
            out["feature_projection.projection." + k.split(".")[-1]] = v
        elif k == "encoder.pos_conv.0.bias":
            out["encoder.pos_conv_embed.conv.bias"] = v
        elif k == "encoder.pos_conv.0.weight_g":
            out["encoder.pos_conv_embed.conv.parametrizations.weight."
                "original0"] = v
        elif k == "encoder.pos_conv.0.weight_v":
            out["encoder.pos_conv_embed.conv.parametrizations.weight."
                "original1"] = v
        elif k.startswith("encoder.layer_norm."):
            out["encoder.layer_norm." + k.split(".")[-1]] = v
        elif k.startswith("encoder.layers."):
            parts = k.split(".")
            i = parts[2]
            rest = ".".join(parts[3:])
            rest = rest.replace("self_attn_layer_norm.", "layer_norm.") \
                if rest.startswith("self_attn_layer_norm.") else rest
            rest = rest.replace("self_attn.", "attention.") \
                if rest.startswith("self_attn.") else rest
            rest = rest.replace("fc1", "feed_forward.intermediate_dense")
            rest = rest.replace("fc2", "feed_forward.output_dense")
            out[f"encoder.layers.{i}.{rest}"] = v
    return out


def verify_contentvec(sd, tree, cfg, device):
    from transformers import HubertConfig, HubertModel

    sub = _strip(sd, "content_extractor.model.")
    hidden = sub["post_extract_proj.weight"].shape[0]
    inter = sub["encoder.layers.0.fc1.weight"].shape[0]
    n_layers = max(int(k.split(".")[2]) for k in sub if k.startswith("encoder.layers.")) + 1
    conv_dims, conv_kernels = [], []
    i = 0
    while f"feature_extractor.conv_layers.{i}.0.weight" in sub:
        w = sub[f"feature_extractor.conv_layers.{i}.0.weight"]
        conv_dims.append(w.shape[0])
        conv_kernels.append(w.shape[2])
        i += 1
    conv_strides = [s for (_, _, s) in contentvec.CONV_LAYERS]
    pos_v = sub["encoder.pos_conv.0.weight_v"]
    hf_cfg = HubertConfig(
        hidden_size=hidden, num_hidden_layers=n_layers,
        num_attention_heads=hidden // 64, intermediate_size=inter,
        conv_dim=conv_dims, conv_kernel=conv_kernels,
        conv_stride=conv_strides[: len(conv_dims)],
        conv_bias="feature_extractor.conv_layers.0.0.bias" in sub,
        num_conv_pos_embeddings=pos_v.shape[2],
        num_conv_pos_embedding_groups=hidden // pos_v.shape[1],
        feat_extract_norm="group", do_stable_layer_norm=False,
        hidden_act="gelu", hidden_dropout=0.0, attention_dropout=0.0,
        feat_proj_dropout=0.0, layerdrop=0.0, activation_dropout=0.0)
    hf = HubertModel(hf_cfg).eval()
    missing, unexpected = hf.load_state_dict(fairseq_to_hf_hubert_sd(sub), strict=False)
    missing = [k for k in missing if "masked_spec_embed" not in k]
    assert not missing, f"unfilled HF keys: {missing[:5]}"
    assert not unexpected, f"unmapped fairseq keys: {unexpected[:5]}"

    fp_w = torch.as_tensor(np.asarray(sub["final_proj.weight"]))
    fp_b = torch.as_tensor(np.asarray(sub["final_proj.bias"]))
    model = _module(lambda: contentvec.ContentVec(n_layers=n_layers), tree["contentvec"], device)
    rng = np.random.default_rng(5)
    wav = (rng.standard_normal((1, 8000)) * 0.1).astype(np.float32)
    with torch.no_grad():
        ref = hf(torch.from_numpy(wav)).last_hidden_state
        ref = (ref @ fp_w.T + fp_b).numpy()
        got = _np(model(torch.from_numpy(wav).to(device)))
    return float(np.abs(got - ref).max())


# -------------------------------------------------------------------- main


def verify(path: str, families=None, device="cuda") -> dict:
    """{family: (max abs diff, within tolerance)} for the families present
    in the bundle (all, or those named in ``families``)."""
    dev = resolve_device(device)
    sd, cfg_dict = checkpoint.load_torch_bundle(path)
    sd = dict(sd)
    tree = checkpoint.convert_bundle(path)
    cfg = GenVCConfig.from_dict(cfg_dict or {})

    runners = {
        "gpt": lambda: verify_gpt(sd, tree, cfg, dev),
        "perceiver": lambda: verify_perceiver(sd, tree, cfg, dev),
        "acoustic_dvae": lambda: verify_dvae(sd, tree, cfg, "acoustic_dvae", dev),
        "content_dvae": lambda: verify_dvae(sd, tree, cfg, "content_dvae", dev),
        "hifigan": lambda: verify_hifigan(sd, tree, cfg, dev),
        "contentvec": lambda: verify_contentvec(sd, tree, cfg, dev),
    }
    prefixes = {
        "gpt": "gpt.gpt.", "perceiver": "gpt.conditioning_perceiver.",
        "acoustic_dvae": "acoustic_dvae.", "content_dvae": "content_dvae.",
        "hifigan": "hifigan.", "contentvec": "content_extractor.model.",
    }
    results = {}
    for name, run in runners.items():
        if families and name not in families:
            continue
        if not any(k.startswith(prefixes[name]) for k in sd):
            print(f"{name:>14}: (absent from bundle)")
            continue
        try:
            diff = run()
            ok = diff <= TOLERANCES[name]
            results[name] = (diff, ok)
            print(f"{name:>14}: max_abs_diff={diff:.3e}  "
                  f"{'OK' if ok else f'EXCEEDS tol={TOLERANCES[name]:.0e}'}")
        except Exception as e:  # keep going; report at the end
            results[name] = (float("inf"), False)
            print(f"{name:>14}: FAILED ({type(e).__name__}: {e})")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("bundle", help="path to a GenVC .pth bundle")
    ap.add_argument("--families", default=None,
                    help="comma-separated subset (default: all present)")
    ap.add_argument("--device", default="cuda",
                    help="where the port's modules run (the oracles run on the CPU)")
    args = ap.parse_args(argv)
    fams = args.families.split(",") if args.families else None
    results = verify(args.bundle, fams, args.device)
    bad = [n for n, (_, ok) in results.items() if not ok]
    if bad:
        print(f"FAILED families: {', '.join(bad)}")
        return 1
    print("all families within tolerance")
    return 0


if __name__ == "__main__":
    sys.exit(main())
