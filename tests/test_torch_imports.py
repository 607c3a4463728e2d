"""The port stands alone: no file of ``genvc_tpu_torch/`` (nor the card's
smoke script) imports ``jax``, ``optax``, ``orbax`` or anything of the JAX
package ``genvc_tpu``."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "genvc_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "genvc_tpu")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_torch_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_torch_import_check_sees_violations(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\nfrom genvc_tpu.ops import nn\n"
                 "from genvc_tpu_torch import ops\nimport optax\n"
                 "import orbax.checkpoint as ocp\n")
    assert sorted(m for m in _imported_modules(p) if _forbidden(m)) == \
        ["genvc_tpu.ops", "genvc_tpu.ops.nn", "jax.numpy", "optax", "orbax.checkpoint"]
