"""Convert a GenVC reference ``.pth`` bundle to an ``.npz`` bundle.

Usage:
    python -m genvc_tpu_torch.tools.convert_checkpoint GenVC_small.pth GenVC_small.npz

Writes ``<out>.npz`` (the flattened parameter trees) and
``<out>.config.json``, which ``model_init`` and ``python -m
genvc_tpu_torch.infer --model_path <out>.npz`` read.
"""

from __future__ import annotations

import json
import sys

from genvc_tpu_torch import checkpoint


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    src, dst = argv
    base = dst[:-4] if dst.endswith(".npz") else dst
    tree = checkpoint.convert_bundle(src)
    cfg = tree.pop("config")
    checkpoint.save_pytree_npz(base + ".npz", tree)
    with open(base + ".config.json", "w") as f:
        json.dump(cfg, f, indent=2)
    print(f"wrote {base}.npz and {base}.config.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
