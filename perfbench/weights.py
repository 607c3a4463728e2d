"""Seeded random weights of the GenVC model set, drawn in a few large calls.

The tree has the JAX package's layout, which the port's ``build_pipeline``
loads and :mod:`perfbench.reference.model` reads. Every leaf is a view of one
of four buffers: one ``randn`` draw, one ``rand`` draw (both from one
``torch.Generator`` on the device), a buffer of ones and one of zeros. The
distributions are those of the reference's layer initialisers: normal with a
stated std for embeddings, transformer projections and convolutions, uniform
in +-1/sqrt(fan_in) for plain linears and dVAE convolutions. Leaves of the
families served in bf16 are rounded to bf16, so the program's cast is exact
and the reference computes with the values the program serves.
"""

from __future__ import annotations

import math

import torch

# (kind, scale): "n" normal * scale, "u" uniform(-1, 1) * scale, "1" ones, "0" zeros


def _linear(d_in, d_out, std=None, bias=True):
    lim = 1.0 / math.sqrt(d_in)
    if std is None:
        p = {"w": ((d_in, d_out), "u", lim)}
        if bias:
            p["b"] = ((d_out,), "u", lim)
    else:
        p = {"w": ((d_in, d_out), "n", std)}
        if bias:
            p["b"] = ((d_out,), "0", 0.0)
    return p


def _ln(d):
    return {"scale": ((d,), "1", 1.0), "bias": ((d,), "0", 0.0)}


def _conv(c_out, c_in, k, std=None, bias=True):
    """Uniform weights and biases in +-1/sqrt(fan_in); with ``std`` normal
    weights and zero biases."""
    lim = 1.0 / math.sqrt(c_in * k)
    p = {"w": ((c_out, c_in, k), "u", lim) if std is None else ((c_out, c_in, k), "n", std)}
    if bias:
        p["b"] = ((c_out,), "u", lim) if std is None else ((c_out,), "0", 0.0)
    return p


def gpt_spec(g: dict, p: dict) -> dict:
    d, layers = g["model_dim"], g["layers"]
    proj_std = 0.02 / math.sqrt(2 * layers)
    ff_inner = int(d * p["ff_mult"] * 2 / 3)
    inner = p["dim_head"] * p["heads"]
    blocks = [{
        "ln_1": _ln(d),
        "attn": {"c_attn": _linear(d, 3 * d, std=0.02), "c_proj": _linear(d, d, std=proj_std)},
        "ln_2": _ln(d),
        "mlp": {"c_fc": _linear(d, 4 * d, std=0.02), "c_proj": _linear(4 * d, d, std=proj_std)},
    } for _ in range(layers)]
    perceiver = {
        "proj_context": _linear(p["dim_context"], d),
        "latents": ((p["latents"], d), "n", 0.02),
        "layers": [{
            "to_q": _linear(d, inner, bias=False),
            "to_kv": _linear(d, 2 * inner, bias=False),
            "to_out": _linear(inner, d, bias=False),
            "ff_in": _linear(d, 2 * ff_inner),
            "ff_out": _linear(ff_inner, d),
        } for _ in range(p["depth"])],
        "norm": {"gamma": ((d,), "1", 1.0)},
    }
    return {
        "text_embedding": ((g["number_text_tokens"], d), "n", 0.02),
        "mel_embedding": ((g["num_audio_tokens"], d), "n", 0.02),
        "text_pos": ((g["max_text_tokens"] + 2, d), "n", 0.02),
        "mel_pos": ((g["max_mel_tokens"] + 3, d), "n", 0.02),
        "core": {"blocks": blocks, "ln_f": _ln(d)},
        "final_norm": _ln(d),
        "text_head": _linear(d, g["number_text_tokens"]),
        "mel_head": _linear(d, g["num_audio_tokens"]),
        "perceiver": perceiver,
    }


def hifigan_spec(h: dict) -> dict:
    ch0 = h["upsample_initial_channel"]
    ups, resblocks = [], []
    for i, k in enumerate(h["upsample_kernel_sizes"]):
        c_in, c_out = ch0 // 2 ** i, ch0 // 2 ** (i + 1)
        ups.append({"w": ((c_in, c_out, k), "n", 0.01), "b": ((c_out,), "0", 0.0)})
        for kr, dil in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]):
            resblocks.append({"convs": [_conv(c_out, c_out, kr, std=0.01) for _ in dil]})
    n_up = len(h["upsample_rates"])
    return {"conv_pre": _conv(ch0, h["input_feat_dim"], 7, std=0.01), "ups": ups,
            "resblocks": resblocks, "conv_post": _conv(1, ch0 // 2 ** n_up, 7, std=0.01)}


def dvae_spec(c: dict) -> dict:
    chans = [c["channels"]] + [c["hidden_dim"] * 2 ** i for i in range(c["num_layers"])]
    inner = chans[-1]
    return {
        "encoder": {
            "convs": [_conv(chans[i + 1], chans[i], c["kernel_size"]) for i in range(c["num_layers"])],
            "resblocks": [{"conv1": _conv(inner, inner, 3), "conv2": _conv(inner, inner, 3),
                           "conv3": _conv(inner, inner, 1)} for _ in range(c["num_resnet_blocks"])],
            "out": _conv(c["codebook_dim"], inner, 1)},
        "codebook": {"embed": ((c["codebook_dim"], c["num_tokens"]), "n", 1.0)},
    }


CV_CONV = [(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2


def contentvec_spec(cv: dict) -> dict:
    e, f = cv["embed_dim"], cv["ffn_dim"]
    fe, c_in = [], 1
    for i, (c, k, _) in enumerate(CV_CONV):
        layer = {"conv": {"w": ((c, c_in, k), "n", 0.05)}}
        if i == 0:
            layer["norm"] = _ln(c)
        fe.append(layer)
        c_in = c
    return {
        "feature_extractor": fe,
        "post_extract_proj": _linear(512, e),
        "pos_conv": {"w": ((e, e // 16, 128), "n", 0.01), "b": ((e,), "0", 0.0)},
        "pre_ln": _ln(512),
        "encoder_ln": _ln(e),
        "layers": [{
            "attn": {n: _linear(e, e) for n in ("q", "k", "v", "out")},
            "attn_ln": _ln(e), "fc1": _linear(e, f), "fc2": _linear(f, e), "final_ln": _ln(e),
        } for _ in range(cv["layers"])],
        "final_proj": _linear(e, cv["final_dim"]),
    }


def inference_spec(cfg: dict) -> dict:
    """The leaves every inference path loads, by family."""
    return {"gpt": gpt_spec(cfg["gpt"], cfg["perceiver"]),
            "hifigan": hifigan_spec(cfg["hifigan"]),
            "content_dvae": dvae_spec(cfg["content_dvae"]),
            "contentvec": contentvec_spec(cfg["contentvec"])}


def training_spec(cfg: dict) -> dict:
    """The GPT stage's trees: the trainable GPT and the frozen tokenizers."""
    return {"gpt": gpt_spec(cfg["gpt"], cfg["perceiver"]),
            "contentvec": contentvec_spec(cfg["contentvec"]),
            "content_dvae": dvae_spec(cfg["content_dvae"]),
            "acoustic_dvae": dvae_spec(cfg["acoustic_dvae"])}


def _leaves(spec, path=()):
    if isinstance(spec, dict):
        for k, v in spec.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(spec, list):
        for i, v in enumerate(spec):
            yield from _leaves(v, path + (i,))
    else:
        yield path, spec


def count(spec) -> dict:
    """Elements per kind."""
    n = {"n": 0, "u": 0, "1": 0, "0": 0}
    for _, (shape, kind, _) in _leaves(spec):
        n[kind] += math.prod(shape)
    return n


def torch_seed(seed: int) -> int:
    """A seed of any size folded into torch's 64-bit range."""
    return int(seed) % (2 ** 63 - 1)


# The families served in bf16, whose values are drawn bf16-exact.
BF16_FAMILIES = ("gpt",)


def draw(spec, seed: int, device) -> dict:
    """The tree of ``spec`` filled from ``seed`` on ``device`` (f32 leaves).
    The dVAE codebooks are drawn unit normal here; :mod:`perfbench.codebooks`
    places them."""
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed))
    sizes = count(spec)
    bufs = {"n": torch.randn(sizes["n"], generator=gen, device=device),
            "u": torch.rand(sizes["u"], generator=gen, device=device).mul_(2).sub_(1),
            "1": torch.ones(sizes["1"], device=device),
            "0": torch.zeros(sizes["0"], device=device)}
    offsets = dict.fromkeys(bufs, 0)
    tree: dict = {}
    for path, (shape, kind, scale) in _leaves(spec):
        n = math.prod(shape)
        leaf = bufs[kind][offsets[kind]: offsets[kind] + n].view(shape)
        offsets[kind] += n
        if kind in "nu":
            leaf.mul_(scale)
            if path[0] in BF16_FAMILIES:
                leaf.copy_(leaf.to(torch.bfloat16))
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return _lists(tree)


def _lists(node):
    """Dicts keyed 0..n-1 (the layer stacks) back into lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out
