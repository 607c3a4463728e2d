"""Export an ``.npz`` bundle back to a reference-format ``.pth``.

Usage:
    python -m genvc_tpu_torch.tools.export_checkpoint GenVC_small.npz GenVC_small.pth

The inverse of ``convert_checkpoint``: writes the ``{'model': state_dict,
'config': dict}`` bundle that the reference's ``model_init`` loads, with the
config from ``<src stem>.config.json`` (none, with a warning, if that file
is missing).
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
    tree = checkpoint.load_pytree_npz(src)
    base = src[:-4] if src.endswith(".npz") else src
    try:
        with open(base + ".config.json") as f:
            tree["config"] = json.load(f)
    except FileNotFoundError:
        tree.setdefault("config", None)
        print(f"warning: {base}.config.json not found; exporting without an "
              "embedded config", file=sys.stderr)
    checkpoint.export_bundle(tree, dst)
    print(f"wrote {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
