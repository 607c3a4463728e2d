"""Assemble one ``.npz`` inference bundle from stage training artifacts.

Usage:
    python -m genvc_tpu_torch.tools.make_inference_bundle \
        --gpt exp/genVC/ckpt/... --hifigan exp/HiFiGAN/... \
        --acoustic_dvae pre_trained/acoustic_dvae.pth \
        --content_dvae pre_trained/content_dvae.pth \
        --contentvec pre_trained/contentVec.pt \
        --config config.json --out GenVC_mine.npz

Each artifact is a torch ``.pth`` stage checkpoint (a bare state dict,
``{'model': state_dict}``, or a composed bundle whose keys carry the
family's prefix) or an ``.npz`` tree. Writes ``<out>.npz`` and
``<out>.config.json``, which ``model_init`` loads.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from genvc_tpu_torch import checkpoint as ck

FAMILIES = ("gpt", "hifigan", "acoustic_dvae", "content_dvae", "contentvec")


def _unprefixed(sd: dict, prefix: str) -> dict:
    return ck.strip_prefix(sd, prefix) if any(k.startswith(prefix) for k in sd) else sd


def load_family(path: str, family: str) -> dict:
    """One family's parameter tree from a stage artifact."""
    if path.endswith(".npz"):
        return ck.load_pytree_npz(path)
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("model", obj) if isinstance(obj, dict) else obj
    if family == "gpt":
        sd = _unprefixed(sd, "gpt.")
        n = max(int(k.split(".")[2]) for k in sd if k.startswith("gpt.h.")) + 1
        return ck.convert_gpt(sd, n)
    if family == "hifigan":
        return ck.convert_hifigan(_unprefixed(sd, "hifigan."))
    if family in ("acoustic_dvae", "content_dvae"):
        return ck.convert_dvae(_unprefixed(sd, "dvae."))
    if family == "contentvec":
        sd = {k: v for k, v in sd.items() if hasattr(v, "numpy")}
        n = max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.layers.")) + 1
        return ck.convert_contentvec(sd, n_layers=n)
    raise ValueError(family)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    for name in FAMILIES:
        ap.add_argument(f"--{name}", required=True)
    ap.add_argument("--config", required=True, help="json file with the GenVCConfig dict")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    tree = {fam: load_family(getattr(args, fam), fam) for fam in FAMILIES}
    with open(args.config) as f:
        cfg = json.load(f)
    out = args.out if args.out.endswith(".npz") else args.out + ".npz"
    ck.save_pytree_npz(out, tree)
    with open(out[:-4] + ".config.json", "w") as f:
        json.dump(cfg, f, indent=2)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
