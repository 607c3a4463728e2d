"""``.npz`` bundles, ``export_bundle`` and the checkpoint tools of the port
against the JAX package, on the CPU with the synthetic bundle.

* An ``.npz`` written by either package loads in the other: the same keys,
  lists where lists were, and equal arrays.
* ``model_init`` on the converted ``.npz`` gives the port's ``.pth`` audio
  and the JAX package's ``.npz`` audio within 1e-3 (f32, greedy).
* ``export_bundle`` writes the JAX package's keys with bit-equal tensors on
  the same tree, and what it writes loads in both ``model_init``s.
* ``python -m genvc_tpu_torch.tools.{convert_checkpoint, export_checkpoint,
  make_inference_bundle}`` run, and write what the root ``tools/`` write.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from genvc_tpu import checkpoint as jckpt
from genvc_tpu_torch import checkpoint as tckpt
from genvc_tpu_torch.decode.engine import SamplerConfig as TSampler
from genvc_tpu_torch.inference import pipeline as tpipe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GREEDY = dict(temperature=1.0, top_k=1, top_p=1.0, repetition_penalty=1.0,
              do_sample=False)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    from synthetic_bundle import write_bundle

    path = str(tmp_path_factory.mktemp("bundle") / "tiny_genvc.pth")
    write_bundle(path)
    return path


def _assert_same_tree(a, b, where="tree"):
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)), \
        f"{where}: {type(a)} vs {type(b)}"
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), f"{where}: keys {sorted(a)} vs {sorted(b)}"
        for k in a:
            _assert_same_tree(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{where}/{i}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_torch_npz_loads_in_the_other_package(bundle, tmp_path, writer):
    tree = tckpt.convert_bundle(bundle)
    tree.pop("config")
    path = str(tmp_path / "tree.npz")
    save, load = ((tckpt.save_pytree_npz, jckpt.load_pytree_npz) if writer == "port"
                  else (jckpt.save_pytree_npz, tckpt.load_pytree_npz))
    save(path, tree)
    got = load(path)
    assert isinstance(got["hifigan"]["ups"], list) and isinstance(got["gpt"]["core"]["blocks"], dict)
    _assert_same_tree(got, tree)
    _assert_same_tree(tckpt.load_pytree_npz(path), jckpt.load_pytree_npz(path))


def _convert(bundle, out):
    from genvc_tpu_torch.tools import convert_checkpoint

    assert convert_checkpoint.main([bundle, out]) == 0
    return out


def test_torch_model_init_npz_matches_pth_and_jax(bundle, tmp_path):
    """Streaming audio of the converted bundle, f32 greedy at cap 1.0: the
    port's ``.npz`` pipeline against its ``.pth`` pipeline and the JAX
    package's ``.npz`` pipeline, within 1e-3."""
    from genvc_tpu.decode.engine import SamplerConfig as JSampler
    from genvc_tpu.inference.pipeline import model_init as jax_init

    npz = _convert(bundle, str(tmp_path / "tiny_genvc.npz"))
    rng = np.random.default_rng(19)
    src = (rng.standard_normal((1, 24000)) * 0.1).astype(np.float32)
    ref = (rng.standard_normal((1, 48000)) * 0.1).astype(np.float32)
    jp = jax_init(npz)
    jp.sampler = JSampler(**GREEDY)
    jp._build_jits()
    jp.gen_cap_tokens_per_code = 1.0
    wavs = {"jax_npz": jp.synthesize_streaming(src, ref, verbose=False)[0]}
    for name, path in (("port_npz", npz), ("port_pth", bundle)):
        tp = tpipe.model_init(path, device="cpu")
        tp.sampler = TSampler(**GREEDY)
        tp.gen_cap_tokens_per_code = 1.0
        wavs[name] = tp.synthesize_streaming(src, ref, verbose=False)[0]
    got = wavs["port_npz"]
    assert got.size > 0
    for name in ("port_pth", "jax_npz"):
        assert wavs[name].shape == got.shape
        np.testing.assert_allclose(got, wavs[name], atol=1e-3, err_msg=name)


@pytest.mark.parametrize("hifigan_form", ["folded", "weight_norm"])
def test_torch_export_bundle_matches_jax(bundle, tmp_path, hifigan_form):
    """The same tree through both packages' ``export_bundle``: the same keys
    in the same order and bit-equal tensors, the config as it was; the port's
    file loads in both ``model_init``s, to the weights it came from (within
    1e-6: weight norm unfolds and folds again)."""
    tree = tckpt.convert_bundle(bundle)
    if hifigan_form == "weight_norm":  # the training form: {g, v, b} leaves
        sd, _ = tckpt.load_torch_bundle(bundle)
        tree["hifigan"] = tckpt.convert_hifigan(tckpt.strip_prefix(sd, "hifigan."), fold=False)
    ours, theirs = str(tmp_path / "port.pth"), str(tmp_path / "jax.pth")
    tckpt.export_bundle(tree, ours)
    jckpt.export_bundle(tree, theirs)
    a = torch.load(ours, map_location="cpu", weights_only=False)
    b = torch.load(theirs, map_location="cpu", weights_only=False)
    assert list(a["model"]) == list(b["model"]) and len(a["model"]) > 0
    for k in a["model"]:
        assert a["model"][k].dtype == b["model"][k].dtype == torch.float32
        torch.testing.assert_close(a["model"][k], b["model"][k], rtol=0, atol=0)
    assert a["config"] == b["config"] == tree["config"]
    if hifigan_form == "weight_norm":
        return
    from genvc_tpu.inference.pipeline import model_init as jax_init

    jax_init(ours)
    before = tpipe.model_init(bundle, device="cpu")
    after = tpipe.model_init(ours, device="cpu")
    for name in ("gpt", "hifigan", "content_dvae", "contentvec"):
        sa, sb = getattr(before, name).state_dict(), getattr(after, name).state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            torch.testing.assert_close(sb[k], sa[k], rtol=1e-6, atol=1e-6)


def _root_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"root_tools_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_tools_convert_and_export(bundle, tmp_path, monkeypatch):
    """convert_checkpoint writes the root tool's ``.npz`` and config;
    export_checkpoint writes a ``.pth`` the port's ``model_init`` loads, with
    the config it read."""
    from genvc_tpu_torch.tools import export_checkpoint

    ours = _convert(bundle, str(tmp_path / "ours"))  # no suffix: ".npz" is added
    assert os.path.exists(ours + ".npz") and os.path.exists(ours + ".config.json")
    theirs = str(tmp_path / "theirs.npz")
    monkeypatch.setattr(sys, "argv", ["convert_checkpoint.py", bundle, theirs])
    _root_tool("convert_checkpoint").main()
    _assert_same_tree(tckpt.load_pytree_npz(ours + ".npz"), tckpt.load_pytree_npz(theirs))
    with open(ours + ".config.json") as f, open(theirs[:-4] + ".config.json") as g:
        assert json.load(f) == json.load(g)
    pth = str(tmp_path / "back.pth")
    assert export_checkpoint.main([ours + ".npz", pth]) == 0
    pipe = tpipe.model_init(pth, device="cpu")
    assert pipe.config.to_dict() == tpipe.model_init(bundle, device="cpu").config.to_dict()
    assert export_checkpoint.main([ours + ".npz"]) == 2  # usage


def test_torch_tool_make_inference_bundle_matches_root_tool(bundle, tmp_path, monkeypatch):
    """Stage artifacts (the synthetic stage checkpoints, HiFi-GAN from the
    composed bundle, one family as ``.npz``) into one ``.npz`` and its
    config: equal to the root tool's."""
    from genvc_tpu_torch.testing_synthetic import write_stage_ckpts
    from genvc_tpu_torch.tools import make_inference_bundle

    paths = write_stage_ckpts(str(tmp_path / "stages"))
    content_npz = str(tmp_path / "content_dvae.npz")
    tckpt.save_pytree_npz(content_npz, tckpt.load_dvae(paths["content_dvae"]))
    cfg = str(tmp_path / "config.json")
    with open(cfg, "w") as f:
        json.dump(tckpt.load_torch_bundle(bundle)[1], f)
    args = ["--gpt", paths["gpt"], "--hifigan", bundle,
            "--acoustic_dvae", paths["acoustic_dvae"], "--content_dvae", content_npz,
            "--contentvec", paths["contentvec"], "--config", cfg]
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    assert make_inference_bundle.main(args + ["--out", ours]) == 0
    monkeypatch.setattr(sys, "argv", ["make_inference_bundle.py", *args, "--out", theirs])
    _root_tool("make_inference_bundle").main()
    got = tckpt.load_pytree_npz(ours)
    _assert_same_tree(got, tckpt.load_pytree_npz(theirs))
    assert sorted(got) == ["acoustic_dvae", "content_dvae", "contentvec", "gpt", "hifigan"]
    with open(ours[:-4] + ".config.json") as f:
        assert json.load(f) == tckpt.load_torch_bundle(bundle)[1]
