"""Nothing the benchmark runs imports JAX or the JAX package."""

import os
import re
import subprocess
import sys

from conftest import ROOT
from perfbench import run

PERFBENCH = os.path.join(ROOT, "perfbench")


def test_the_check_compares_whole_top_level_names():
    assert run.forbidden_modules(["genvc_tpu_torch", "genvc_tpu_torch.models.gpt"]) == []
    assert run.forbidden_modules(["jax.numpy", "numpy"]) == ["jax"]
    assert run.forbidden_modules(["genvc_tpu.ops"]) == ["genvc_tpu"]
    assert run.forbidden_modules(["flax.linen", "jaxlib.xla_client"]) == ["flax", "jaxlib"]


def test_the_harness_and_the_program_it_drives_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.run, perfbench.sweep, perfbench.control, perfbench.readers\n"
            "import perfbench.drivers.stream, perfbench.drivers.serve\n"
            "import genvc_tpu_torch.inference.pipeline, genvc_tpu_torch.serving.server\n"
            "print(perfbench.run.forbidden_modules())" % ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_source_under_the_benchmark_names_jax_and_the_reference_none_of_the_program():
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|genvc_tpu)(\s|\.|$)", re.M)
    prog = re.compile(r"^\s*(from|import)\s+genvc_tpu_torch", re.M)
    for base, _, files in os.walk(PERFBENCH):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(base, f)).read()
                assert not pat.search(src), f
                if os.path.basename(base) == "reference":
                    assert not prog.search(src), f


def test_the_run_refuses_without_a_card_and_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                          "genvc-bf16.stream", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
