"""Checkpoint loading: torch ``.pth`` bundles -> parameter trees -> modules.

The first half is the port's own copy of the numpy converters of
``genvc_tpu/checkpoint.py``: the reference ships single-file bundles
``{'model': state_dict, 'config': dict}`` (inference/model_init.py:11-22)
whose state dict covers ``gpt.*``, ``hifigan.*``, ``acoustic_dvae.*``,
``content_dvae.*``, ``content_extractor.model.*``; each family becomes a
nested dict of numpy arrays — the JAX package's parameter tree.

Convention: linear weights transpose to (in, out); conv weights keep torch
(O, I, K) layout; HF GPT-2 ``Conv1D`` weights are already (in, out) and pass
through unchanged. The port's ``Linear`` keeps (in, out) too, so a tree loads
without further transposition.

Trees also travel as ``.npz`` bundles (:func:`save_pytree_npz`,
:func:`load_pytree_npz`: the JAX package's format, a converted bundle beside
its ``<stem>.config.json``) and go back to reference ``.pth`` bundles
(:func:`export_bundle`, the inverse of :func:`convert_bundle`).

The second half, :func:`load_jax_tree`, turns such a tree (numpy arrays or
tensors; layer stacks either stacked on a leading axis or as lists) into the
port's ``nn.Module``s on a device; :func:`export_tree` is its inverse. The
training stage's loaders (:func:`load_mel_norms`, :func:`load_contentvec`,
:func:`load_dvae`, :func:`load_gpt`) read the reference's per-stage files.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch
from torch import nn

from genvc_tpu_torch.config import GenVCConfig
from genvc_tpu_torch.models import contentvec, dvae, gpt as gpt_model, hifigan, mla_moe
from genvc_tpu_torch.ops import quant


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t,
                      dtype=np.float32)


def _ln(sd, prefix):
    return {"scale": _np(sd[prefix + ".weight"]), "bias": _np(sd[prefix + ".bias"])}


def _linear_t(sd, prefix, bias=True):
    p = {"w": _np(sd[prefix + ".weight"]).T}
    if bias and prefix + ".bias" in sd:
        p["b"] = _np(sd[prefix + ".bias"])
    return p


def _linear_asis(sd, prefix, bias=True):
    p = {"w": _np(sd[prefix + ".weight"])}
    if bias and prefix + ".bias" in sd:
        p["b"] = _np(sd[prefix + ".bias"])
    return p


def fold_weight_norm(sd, prefix):
    """weight = g * v / ||v||; the norm axes are inferred from g's shape
    (torch ``weight_norm(dim=d)`` keeps dim d in g — default dim=0 for most
    convs, dim=2 for fairseq's pos_conv)."""
    g = _np(sd[prefix + ".weight_g"])
    v = _np(sd[prefix + ".weight_v"])
    axes = tuple(i for i in range(v.ndim) if g.shape[i] == 1) if g.ndim == v.ndim \
        else tuple(range(1, v.ndim))
    norm = np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def _conv(sd, prefix, weight_normed=False):
    if weight_normed and prefix + ".weight_g" in sd:
        w = fold_weight_norm(sd, prefix)
    else:
        w = _np(sd[prefix + ".weight"])
    p = {"w": w}
    if prefix + ".bias" in sd:
        p["b"] = _np(sd[prefix + ".bias"])
    return p


def strip_prefix(sd: dict, prefix: str) -> dict:
    plen = len(prefix)
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# GPT (layers/gpt.py naming)


def convert_gpt(sd: dict, n_layers: int) -> dict:
    """sd: state dict with keys relative to the ``gpt.`` module
    (gpt.weight names from layers/gpt.py: ``gpt.h.{i}...``, embeddings, heads,
    ``conditioning_perceiver...``)."""

    def block(i):
        p = f"gpt.h.{i}."
        return {
            "ln_1": _ln(sd, p + "ln_1"),
            "attn": {
                "c_attn": _linear_asis(sd, p + "attn.c_attn"),
                "c_proj": _linear_asis(sd, p + "attn.c_proj"),
            },
            "ln_2": _ln(sd, p + "ln_2"),
            "mlp": {
                "c_fc": _linear_asis(sd, p + "mlp.c_fc"),
                "c_proj": _linear_asis(sd, p + "mlp.c_proj"),
            },
        }

    blocks = [block(i) for i in range(n_layers)]
    stacked = {}

    def stack(path, trees):
        out = {}
        for k in trees[0]:
            vals = [t[k] for t in trees]
            if isinstance(vals[0], dict):
                out[k] = stack(path + (k,), vals)
            else:
                out[k] = np.stack(vals)
        return out

    stacked = stack((), blocks)

    params = {
        "text_embedding": _np(sd["text_embedding.weight"]),
        "mel_embedding": _np(sd["mel_embedding.weight"]),
        "text_pos": _np(sd["text_pos_embedding.emb.weight"]),
        "mel_pos": _np(sd["mel_pos_embedding.emb.weight"]),
        "core": {"blocks": stacked, "ln_f": _ln(sd, "gpt.ln_f")},
        "final_norm": _ln(sd, "final_norm"),
        "text_head": _linear_t(sd, "text_head"),
        "mel_head": _linear_t(sd, "mel_head"),
        "perceiver": convert_perceiver(strip_prefix(sd, "conditioning_perceiver.")),
    }
    return params


def convert_perceiver(sd: dict, depth: int = 4) -> dict:
    def layer(i):
        a = f"layers.{i}.0."
        f = f"layers.{i}.1."
        return {
            "to_q": _linear_t(sd, a + "to_q"),
            "to_kv": _linear_t(sd, a + "to_kv"),
            "to_out": _linear_t(sd, a + "to_out"),
            "ff_in": _linear_t(sd, f + "0"),
            "ff_out": _linear_t(sd, f + "2"),
        }

    layers = [layer(i) for i in range(depth)]

    def stack(trees):
        out = {}
        for k in trees[0]:
            vals = [t[k] for t in trees]
            out[k] = stack(vals) if isinstance(vals[0], dict) else np.stack(vals)
        return out

    return {
        "proj_context": _linear_t(sd, "proj_context"),
        "latents": _np(sd["latents"]),
        "layers": stack(layers),
        "norm": {"gamma": _np(sd["norm.gamma"])},
    }


# ---------------------------------------------------------------------------
# Discrete VAE (layers/dvae.py naming, use_transposed_convs=False topology)


def convert_dvae(sd: dict, num_layers: int = 2, num_resnet_blocks: int = 3) -> dict:
    """Encoder: [conv+act]*num_layers, ResBlock*num_resnet_blocks, conv1x1.
    Decoder: conv1x1, ResBlock*n, [UpsampledConv+act]*num_layers, conv1x1.
    torch Sequential indices follow layers/dvae.py:252-292."""

    def resblock(prefix):
        # ResBlock.net: Sequential(conv, act, conv, act, conv)
        return {
            "conv1": _conv(sd, prefix + "net.0"),
            "conv2": _conv(sd, prefix + "net.2"),
            "conv3": _conv(sd, prefix + "net.4"),
        }

    enc = {"convs": [], "resblocks": [], "out": None}
    for i in range(num_layers):
        # nn.Sequential(conv, act) at encoder index i -> keys encoder.{i}.0.*
        enc["convs"].append(_conv(sd, f"encoder.{i}.0"))
    for j in range(num_resnet_blocks):
        enc["resblocks"].append(resblock(f"encoder.{num_layers + j}."))
    enc["out"] = _conv(sd, f"encoder.{num_layers + num_resnet_blocks}")

    dec = {"inp": _conv(sd, "decoder.0"), "resblocks": [], "ups": [], "out": None}
    for j in range(num_resnet_blocks):
        dec["resblocks"].append(resblock(f"decoder.{1 + j}."))
    for i in range(num_layers):
        idx = 1 + num_resnet_blocks + i
        dec["ups"].append(_conv(sd, f"decoder.{idx}.0.conv"))
    dec["out"] = _conv(sd, f"decoder.{1 + num_resnet_blocks + num_layers}")

    return {
        "encoder": enc,
        "decoder": dec,
        "codebook": {
            "embed": _np(sd["codebook.embed"]),            # (dim, n_embed)
            "cluster_size": _np(sd["codebook.cluster_size"]),
            "embed_avg": _np(sd["codebook.embed_avg"]),
        },
    }


# ---------------------------------------------------------------------------
# HiFi-GAN generator (layers/hifigan.py naming); weight norm folded for
# inference, or kept as (g, v) for training.


def convert_hifigan(sd: dict, n_ups: int = 3, n_kernels: int = 3,
                    n_convs_per_block: int = 2, fold: bool = True) -> dict:
    def wn_conv(prefix):
        if fold:
            return {"w": fold_weight_norm(sd, prefix), "b": _np(sd[prefix + ".bias"])}
        return {"g": _np(sd[prefix + ".weight_g"]),
                "v": _np(sd[prefix + ".weight_v"]),
                "b": _np(sd[prefix + ".bias"])}

    resblocks = []
    for i in range(n_ups * n_kernels):
        convs = [wn_conv(f"resblocks.{i}.convs.{j}") for j in range(n_convs_per_block)]
        resblocks.append({"convs": convs})

    return {
        "conv_pre": wn_conv("conv_pre"),
        "ups": [wn_conv(f"ups.{i}") for i in range(n_ups)],
        "resblocks": resblocks,
        "conv_post": wn_conv("conv_post"),
    }


# ---------------------------------------------------------------------------
# ContentVec / HuBERT encoder (fairseq naming)


def convert_contentvec(sd: dict, n_layers: int = 12) -> dict:
    """fairseq HubertModel state dict (keys relative to the model root)."""
    fe = []
    for i in range(7):
        p = f"feature_extractor.conv_layers.{i}."
        layer = {"conv": {"w": _np(sd[p + "0.weight"])}}
        if p + "0.bias" in sd:
            layer["conv"]["b"] = _np(sd[p + "0.bias"])
        if p + "2.weight" in sd:  # group norm on layer 0 (default config)
            layer["norm"] = {"scale": _np(sd[p + "2.weight"]),
                             "bias": _np(sd[p + "2.bias"])}
        fe.append(layer)

    def attn(p):
        return {
            "q": _linear_t(sd, p + "q_proj"),
            "k": _linear_t(sd, p + "k_proj"),
            "v": _linear_t(sd, p + "v_proj"),
            "out": _linear_t(sd, p + "out_proj"),
        }

    layers = []
    for i in range(n_layers):
        p = f"encoder.layers.{i}."
        layers.append({
            "attn": attn(p + "self_attn."),
            "attn_ln": _ln(sd, p + "self_attn_layer_norm"),
            "fc1": _linear_t(sd, p + "fc1"),
            "fc2": _linear_t(sd, p + "fc2"),
            "final_ln": _ln(sd, p + "final_layer_norm"),
        })

    def stack(trees):
        out = {}
        for k in trees[0]:
            vals = [t[k] for t in trees]
            out[k] = stack(vals) if isinstance(vals[0], dict) else np.stack(vals)
        return out

    # pos_conv may be stored weight-normed (weight_g/weight_v) or plain
    if "encoder.pos_conv.0.weight_g" in sd:
        pos_w = fold_weight_norm(sd, "encoder.pos_conv.0")
    else:
        pos_w = _np(sd["encoder.pos_conv.0.weight"])

    params = {
        "feature_extractor": fe,
        "post_extract_proj": _linear_t(sd, "post_extract_proj"),
        "pos_conv": {"w": pos_w, "b": _np(sd["encoder.pos_conv.0.bias"])},
        "pre_ln": _ln(sd, "layer_norm"),
        "encoder_ln": _ln(sd, "encoder.layer_norm"),
        "layers": stack(layers),
        "final_proj": _linear_t(sd, "final_proj"),
    }
    return params


# ---------------------------------------------------------------------------
# Bundle loading


def load_torch_bundle(path: str):
    """Load a reference ``.pth`` bundle; returns (state_dict, config_dict)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt and "config" in ckpt:
        return ckpt["model"], ckpt["config"]
    return ckpt, None


def convert_bundle(path: str):
    """Convert a full GenVC inference bundle into parameter trees.

    Returns dict with keys: gpt, hifigan, acoustic_dvae, content_dvae,
    contentvec (missing families are skipped), plus the config dict.
    """
    sd, cfg_dict = load_torch_bundle(path)
    out = {"config": cfg_dict}
    gpt_sd = strip_prefix(sd, "gpt.")
    if gpt_sd:
        n_layers = max(int(k.split(".")[2]) for k in gpt_sd if k.startswith("gpt.h.")) + 1
        out["gpt"] = convert_gpt(gpt_sd, n_layers)
    hg_sd = strip_prefix(sd, "hifigan.")
    if hg_sd:
        out["hifigan"] = convert_hifigan(hg_sd)
    for name, key in (("acoustic_dvae", "acoustic_dvae."), ("content_dvae", "content_dvae.")):
        d_sd = strip_prefix(sd, key)
        if d_sd:
            out[name] = convert_dvae(d_sd)
    cv_sd = strip_prefix(sd, "content_extractor.model.")
    if cv_sd:
        n_cv = max(int(k.split(".")[2]) for k in cv_sd
                   if k.startswith("encoder.layers.")) + 1
        out["contentvec"] = convert_contentvec(cv_sd, n_layers=n_cv)
    return out


def load_mel_norms(path) -> np.ndarray:
    """Per-bin mel norms from a ``.npy`` or torch file; ones (80,) when the
    path is empty or missing."""
    if path and os.path.exists(str(path)):
        if str(path).endswith(".npy"):
            return np.load(path).astype(np.float32)
        return _np(torch.load(path, map_location="cpu", weights_only=True))
    return np.ones((80,), np.float32)


def load_contentvec(path: str) -> dict:
    """A fairseq ContentVec / HuBERT checkpoint -> parameter tree."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    sd = {k: v for k, v in sd.items() if hasattr(v, "numpy")}
    n = max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.layers.")) + 1
    return convert_contentvec(sd, n_layers=n)


def load_dvae(path: str, name: str = "dvae") -> dict:
    """A dVAE stage checkpoint (a bare state dict, ``{'model': sd}``, or a
    trainer bundle whose keys carry ``name + '.'``) -> parameter tree."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt and "config" in ckpt:
        sd = strip_prefix(ckpt["model"], name + ".")
    else:
        sd = ckpt.get("model", ckpt)
    return convert_dvae(sd)


def load_gpt(path: str, n_layers: int) -> dict:
    """The GPT of a reference ``.pth`` bundle -> parameter tree."""
    sd, _ = load_torch_bundle(path)
    return convert_gpt(strip_prefix(sd, "gpt."), n_layers)


# ---------------------------------------------------------------------------
# .npz bundles: a tree flattened to '/'-joined keys, list entries as "i#"
# (the JAX package's format; either package reads what the other writes)


def save_pytree_npz(path: str, tree: dict) -> None:
    """Flatten a tree of arrays into an ``.npz`` with '/'-joined keys."""
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(prefix + (str(k),), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(prefix + (str(i) + "#",), v)
        else:
            flat["/".join(prefix)] = np.asarray(node)

    rec((), tree)
    np.savez(path, **flat)


def load_pytree_npz(path: str) -> dict:
    """The inverse of :func:`save_pytree_npz`: nested dicts, lists where every
    key of a level is ``"i#"``."""
    tree: dict = {}
    with np.load(path) as data:
        for key, value in data.items():
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value

    def lists(node):
        if isinstance(node, dict):
            if node and all(k.endswith("#") for k in node):
                return [lists(node[f"{i}#"]) for i in range(len(node))]
            return {k: lists(v) for k, v in node.items()}
        return node

    return lists(tree)


def load_npz_bundle(path: str) -> dict:
    """An ``.npz`` bundle and its ``<stem>.config.json`` as one tree, the
    config dict under ``"config"``."""
    tree = load_pytree_npz(path)
    with open(path[:-4] + ".config.json") as f:
        tree["config"] = json.load(f)
    return tree


# ---------------------------------------------------------------------------
# Export: parameter trees -> reference-format ``.pth`` bundles (the inverse of
# convert_bundle), the reference's state-dict names and its weight_norm
# (g, v) pairs, so a model trained with the port loads where the reference's
# model_init loads


def _unfold_weight_norm(w, dim: int = 0):
    """A folded weight as torch ``weight_norm``'s (g, v): v = w and g = ||w||
    over every axis but ``dim``; folding (g, v) gives w back."""
    w = np.asarray(w, np.float32)
    axes = tuple(i for i in range(w.ndim) if i != dim)
    return np.sqrt(np.sum(w * w, axis=axes, keepdims=True)), w


def _put_linear_t(sd, prefix, p):
    sd[prefix + ".weight"] = np.asarray(p["w"], np.float32).T
    if "b" in p:
        sd[prefix + ".bias"] = np.asarray(p["b"], np.float32)


def _put_linear_asis(sd, prefix, p):
    sd[prefix + ".weight"] = np.asarray(p["w"], np.float32)
    if "b" in p:
        sd[prefix + ".bias"] = np.asarray(p["b"], np.float32)


def _put_ln(sd, prefix, p):
    sd[prefix + ".weight"] = np.asarray(p["scale"], np.float32)
    sd[prefix + ".bias"] = np.asarray(p["bias"], np.float32)


_put_conv = _put_linear_asis  # conv weights keep torch's (O, I, K) layout


def _put_wn_conv(sd, prefix, p, dim: int = 0):
    """torch ``weight_norm`` keys from a training-form {g, v} leaf or a folded
    inference-form {w} leaf."""
    if "g" in p:
        g, v = np.asarray(p["g"], np.float32), np.asarray(p["v"], np.float32)
    else:
        g, v = _unfold_weight_norm(p["w"], dim=dim)
    sd[prefix + ".weight_g"] = g
    sd[prefix + ".weight_v"] = v
    if "b" in p:
        sd[prefix + ".bias"] = np.asarray(p["b"], np.float32)


def _unstack(node) -> list:
    """A tree of (L, ...) leaves -> a list of L trees; a list as it is."""
    if isinstance(node, (list, tuple)):
        return list(node)
    first = node
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return [_take(node, i) for i in range(np.shape(first)[0])]


def export_perceiver(params: dict) -> dict:
    sd: dict = {}
    _put_linear_t(sd, "proj_context", params["proj_context"])
    sd["latents"] = np.asarray(params["latents"], np.float32)
    sd["norm.gamma"] = np.asarray(params["norm"]["gamma"], np.float32)
    for i, layer in enumerate(_unstack(params["layers"])):
        a, f = f"layers.{i}.0.", f"layers.{i}.1."
        _put_linear_t(sd, a + "to_q", layer["to_q"])
        _put_linear_t(sd, a + "to_kv", layer["to_kv"])
        _put_linear_t(sd, a + "to_out", layer["to_out"])
        _put_linear_t(sd, f + "0", layer["ff_in"])
        _put_linear_t(sd, f + "2", layer["ff_out"])
    return sd


def export_gpt(params: dict) -> dict:
    """The inverse of :func:`convert_gpt`: keys relative to the bundle's
    ``gpt.`` module."""
    sd: dict = {}
    sd["text_embedding.weight"] = np.asarray(params["text_embedding"], np.float32)
    sd["mel_embedding.weight"] = np.asarray(params["mel_embedding"], np.float32)
    sd["text_pos_embedding.emb.weight"] = np.asarray(params["text_pos"], np.float32)
    sd["mel_pos_embedding.emb.weight"] = np.asarray(params["mel_pos"], np.float32)
    for i, blk in enumerate(_unstack(params["core"]["blocks"])):
        p = f"gpt.h.{i}."
        _put_ln(sd, p + "ln_1", blk["ln_1"])
        _put_linear_asis(sd, p + "attn.c_attn", blk["attn"]["c_attn"])
        _put_linear_asis(sd, p + "attn.c_proj", blk["attn"]["c_proj"])
        _put_ln(sd, p + "ln_2", blk["ln_2"])
        _put_linear_asis(sd, p + "mlp.c_fc", blk["mlp"]["c_fc"])
        _put_linear_asis(sd, p + "mlp.c_proj", blk["mlp"]["c_proj"])
    _put_ln(sd, "gpt.ln_f", params["core"]["ln_f"])
    _put_ln(sd, "final_norm", params["final_norm"])
    _put_linear_t(sd, "text_head", params["text_head"])
    _put_linear_t(sd, "mel_head", params["mel_head"])
    for k, v in export_perceiver(params["perceiver"]).items():
        sd["conditioning_perceiver." + k] = v
    return sd


def export_dvae(params: dict) -> dict:
    sd: dict = {}
    enc, dec = params["encoder"], params["decoder"]
    num_layers = len(enc["convs"])
    num_resnet_blocks = len(enc["resblocks"])

    def put_resblock(prefix, rb):
        _put_conv(sd, prefix + "net.0", rb["conv1"])
        _put_conv(sd, prefix + "net.2", rb["conv2"])
        _put_conv(sd, prefix + "net.4", rb["conv3"])

    for i, c in enumerate(enc["convs"]):
        _put_conv(sd, f"encoder.{i}.0", c)
    for j, rb in enumerate(enc["resblocks"]):
        put_resblock(f"encoder.{num_layers + j}.", rb)
    _put_conv(sd, f"encoder.{num_layers + num_resnet_blocks}", enc["out"])
    _put_conv(sd, "decoder.0", dec["inp"])
    for j, rb in enumerate(dec["resblocks"]):
        put_resblock(f"decoder.{1 + j}.", rb)
    for i, c in enumerate(dec["ups"]):
        _put_conv(sd, f"decoder.{1 + num_resnet_blocks + i}.0.conv", c)
    _put_conv(sd, f"decoder.{1 + num_resnet_blocks + num_layers}", dec["out"])
    for k in ("embed", "cluster_size", "embed_avg"):
        sd["codebook." + k] = np.asarray(params["codebook"][k], np.float32)
    return sd


def export_hifigan(params: dict) -> dict:
    """From the training form ({g, v, b} leaves) or the folded inference form
    ({w, b}); torch weight_norm keys either way."""
    sd: dict = {}
    _put_wn_conv(sd, "conv_pre", params["conv_pre"])
    for i, u in enumerate(params["ups"]):
        _put_wn_conv(sd, f"ups.{i}", u)
    for i, rb in enumerate(params["resblocks"]):
        for j, c in enumerate(rb["convs"]):
            _put_wn_conv(sd, f"resblocks.{i}.convs.{j}", c)
    _put_wn_conv(sd, "conv_post", params["conv_post"])
    return sd


def export_contentvec(params: dict) -> dict:
    sd: dict = {}
    for i, layer in enumerate(params["feature_extractor"]):
        p = f"feature_extractor.conv_layers.{i}."
        _put_conv(sd, p + "0", layer["conv"])
        if "norm" in layer:
            sd[p + "2.weight"] = np.asarray(layer["norm"]["scale"], np.float32)
            sd[p + "2.bias"] = np.asarray(layer["norm"]["bias"], np.float32)
    _put_linear_t(sd, "post_extract_proj", params["post_extract_proj"])
    # fairseq's pos_conv is weight_norm(dim=2)
    g, v = _unfold_weight_norm(params["pos_conv"]["w"], dim=2)
    sd["encoder.pos_conv.0.weight_g"] = g
    sd["encoder.pos_conv.0.weight_v"] = v
    sd["encoder.pos_conv.0.bias"] = np.asarray(params["pos_conv"]["b"], np.float32)
    _put_ln(sd, "layer_norm", params["pre_ln"])
    _put_ln(sd, "encoder.layer_norm", params["encoder_ln"])
    for i, layer in enumerate(_unstack(params["layers"])):
        p = f"encoder.layers.{i}."
        _put_linear_t(sd, p + "self_attn.q_proj", layer["attn"]["q"])
        _put_linear_t(sd, p + "self_attn.k_proj", layer["attn"]["k"])
        _put_linear_t(sd, p + "self_attn.v_proj", layer["attn"]["v"])
        _put_linear_t(sd, p + "self_attn.out_proj", layer["attn"]["out"])
        _put_ln(sd, p + "self_attn_layer_norm", layer["attn_ln"])
        _put_linear_t(sd, p + "fc1", layer["fc1"])
        _put_linear_t(sd, p + "fc2", layer["fc2"])
        _put_ln(sd, p + "final_layer_norm", layer["final_ln"])
    _put_linear_t(sd, "final_proj", params["final_proj"])
    return sd


def export_bundle(tree: dict, path: str) -> None:
    """The inverse of :func:`convert_bundle`: write ``{'model': state_dict,
    'config': dict}`` with each family of ``tree`` (gpt, hifigan,
    acoustic_dvae, content_dvae, contentvec) under the reference's composed
    prefixes and the config dict as it is. A bundle with only some families
    doubles as the reference's stage checkpoints, whose trainers strip the
    family prefix."""
    sd: dict = {}
    families = (("gpt", "gpt.", export_gpt), ("hifigan", "hifigan.", export_hifigan),
                ("acoustic_dvae", "acoustic_dvae.", export_dvae),
                ("content_dvae", "content_dvae.", export_dvae),
                ("contentvec", "content_extractor.model.", export_contentvec))
    for name, prefix, export in families:
        if tree.get(name) is not None:
            sd.update((prefix + k, v) for k, v in export(tree[name]).items())
    model = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    torch.save({"model": model, "config": tree.get("config")}, path)


# ---------------------------------------------------------------------------
# Parameter tree <-> modules


@dataclasses.dataclass
class Modules:
    """The streaming path's models, loaded on one device."""

    gpt: gpt_model.GPT
    hifigan: hifigan.Generator
    content_dvae: dvae.DVAE
    contentvec: contentvec.ContentVec


def gpt_config(cfg: GenVCConfig, backbone=None) -> gpt_model.GPTConfig:
    """The GPT's configuration; ``backbone`` (a ``config.MLAMoEConfig``)
    puts DeepSeek-V3 blocks in place of GPT-2's."""
    ma = cfg.model_args
    return gpt_model.GPTConfig(
        layers=ma.gpt_layers, model_dim=ma.gpt_n_model_channels,
        heads=ma.gpt_n_heads, max_text_tokens=ma.gpt_max_text_tokens,
        max_mel_tokens=ma.gpt_max_audio_tokens,
        number_text_tokens=ma.gpt_number_text_tokens or 258,
        num_audio_tokens=ma.gpt_num_audio_tokens,
        start_text_token=ma.gpt_start_text_token or 256,
        stop_text_token=ma.gpt_stop_text_token or 257,
        start_audio_token=ma.gpt_start_audio_token,
        stop_audio_token=ma.gpt_stop_audio_token,
        code_stride_len=ma.gpt_code_stride_len, mla_moe=backbone)


def dvae_config(vc) -> dvae.DVAEConfig:
    return dvae.DVAEConfig(
        channels=vc.num_channels, num_tokens=vc.num_tokens,
        codebook_dim=vc.codebook_dim, hidden_dim=vc.hidden_dim,
        num_resnet_blocks=vc.num_resnet_blocks, kernel_size=vc.kernel_size,
        num_layers=vc.num_layers)


def _take(node, i):
    """Layer ``i`` of a tree whose leaves are stacked on a leading axis."""
    if isinstance(node, dict):
        return {k: _take(v, i) for k, v in node.items()}
    return node[i]


def assign(module: nn.Module, tree: dict, device, path: str = "",
           dtype=torch.float32) -> None:
    """Load ``tree`` into ``module``'s parameters and buffers (as ``dtype``,
    f32 by default, on ``device``; a leaf already of that type and device is
    taken without a copy). The tree's keys must equal the module's
    parameter, buffer and child names exactly."""
    buffers = {n for n, _ in module.named_buffers(recurse=False)}
    expected = ({n for n, _ in module.named_parameters(recurse=False)} | buffers
                | {n for n, _ in module.named_children()})
    if set(tree) != expected:
        raise KeyError(f"{path or '<root>'}: tree keys {sorted(tree)} != module "
                       f"keys {sorted(expected)}")
    for key, val in tree.items():
        child = getattr(module, key)
        where = f"{path}.{key}" if path else key
        if isinstance(child, nn.ModuleList):
            items = (list(val) if isinstance(val, (list, tuple))
                     else [_take(val, i) for i in range(len(child))])
            if len(items) != len(child):
                raise ValueError(f"{where}: {len(items)} entries for "
                                 f"{len(child)} modules")
            for i, (m, v) in enumerate(zip(child, items)):
                assign(m, v, device, f"{where}.{i}", dtype)
        elif isinstance(child, nn.Module):
            assign(child, val, device, where, dtype)
        else:
            t = torch.as_tensor(np.asarray(val) if not torch.is_tensor(val) else val)
            if tuple(t.shape) != tuple(child.shape):
                raise ValueError(f"{where}: shape {tuple(t.shape)} != "
                                 f"{tuple(child.shape)}")
            t = t.to(device=device, dtype=dtype)
            setattr(module, key, t if key in buffers else nn.Parameter(t, requires_grad=False))


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def export_tree(module: nn.Module) -> dict:
    """The inverse of :func:`assign`: ``module``'s parameters and buffers as a
    tree of f32 numpy arrays in the JAX package's layout. The layer lists the
    JAX tree stacks (the GPT's ``blocks``, the Perceiver's and ContentVec's
    ``layers``) are stacked on a leading axis, other lists stay lists."""
    out = {n: np.array(p.detach().float().cpu().numpy())  # a copy, never a view
           for n, p in [*module.named_parameters(recurse=False),
                        *module.named_buffers(recurse=False)]}
    for name, child in module.named_children():
        if isinstance(child, nn.ModuleList):
            items = [export_tree(m) for m in child]
            out[name] = _stack(items) if name in ("blocks", "layers") else items
        else:
            out[name] = export_tree(child)
    return out


def load_jax_tree(tree: dict, cfg: GenVCConfig, device="cuda",
                  dtype=torch.float32, quantize: str | None = None, backbone=None) -> Modules:
    """Build the port's modules from a parameter tree in the JAX package's
    layout (``genvc_tpu.checkpoint.convert_bundle`` output, this module's own
    :func:`convert_bundle` or :func:`load_pytree_npz`, or the ``init_tree``
    functions).

    ``dtype=torch.bfloat16`` casts the GPT (Perceiver included) to bf16 and
    keeps its ``final_norm`` in f32; HiFi-GAN, ContentVec and the content
    dVAE stay f32 — the JAX ``build_pipeline``'s choice. ``quantize="int8"``
    then swaps int8 linears (``ops.quant``) in for the GPT's block
    projections and heads, quantized from the tree's f32 weights, and keeps
    the core's LayerNorms in f32, as ``build_pipeline`` does.

    The GPT's leaves are loaded in ``dtype`` directly (a bf16 tree on the
    device is taken without a copy: the DeepSeek-V3 backbone, ``backbone``
    a ``config.MLAMoEConfig``, is 30 GB in bf16 and would not fit as f32).
    That backbone keeps its routers in f32 and has no int8 mode."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantize mode {quantize!r}; supported: 'int8'")
    if quantize is not None and backbone is not None:
        raise mla_moe.unsupported("int8 quantization")
    with torch.device("meta"):
        mods = Modules(
            gpt=gpt_model.GPT(gpt_config(cfg, backbone)),
            hifigan=hifigan.Generator(cfg.vocoder_config),
            content_dvae=dvae.DVAE(dvae_config(cfg.content_dvae_config)),
            contentvec=contentvec.ContentVec(n_layers=_n_layers(tree["contentvec"])))
    assign(mods.gpt, tree["gpt"], device, "gpt", dtype)
    assign(mods.hifigan, tree["hifigan"], device, "hifigan")
    cd = tree["content_dvae"]
    assign(mods.content_dvae, {"encoder": cd["encoder"],
                               "codebook": {"embed": cd["codebook"]["embed"]}},
           device, "content_dvae")
    assign(mods.contentvec, tree["contentvec"], device, "contentvec")
    if dtype != torch.float32:
        mods.gpt.to(dtype)
        assign(mods.gpt.final_norm, tree["gpt"]["final_norm"], device,
               "gpt.final_norm")
        for i, block in enumerate(mods.gpt.core.blocks):
            if hasattr(block, "moe"):
                assign(block.moe.router, tree["gpt"]["core"]["blocks"][i]["moe"]["router"],
                       device, f"gpt.core.blocks.{i}.moe.router")
    if quantize is not None:  # from the f32 tree, not the casts
        quant.quantize_gpt(mods.gpt, tree["gpt"])
    for m in (mods.gpt, mods.hifigan, mods.content_dvae, mods.contentvec):
        m.eval()
    return mods


def _n_layers(cv_tree) -> int:
    layers = cv_tree["layers"]
    if isinstance(layers, (list, tuple)):
        return len(layers)
    return int(np.shape(layers["fc1"]["w"])[0])
