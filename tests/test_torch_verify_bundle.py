"""The port's tool surface on the CPU: ``genvc_tpu_torch.tools.verify_bundle``
on the synthetic reference-format bundle (every family's output against the
reference-architecture torch replicas within the tool's ``TOLERANCES``, and
each below the JAX package's own tool's measurement on the same bundle by
the margins of ``tests/test_verify_bundle.py``: under 1e-4 but ContentVec),
and the inference CLI's ``--profile DIR``."""

import json

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module")
def bundle_path(tmp_path_factory):
    from synthetic_bundle import write_bundle

    path = str(tmp_path_factory.mktemp("vb") / "tiny_genvc.pth")
    write_bundle(path)
    return path


def test_torch_verify_bundle_all_families(bundle_path, monkeypatch):
    """Skips, inside the test, where ``transformers`` (the GPT and ContentVec
    oracles) is not installed."""
    # transformers' TensorFlow and Flax backends are not needed: skipping
    # them halves the import
    for var in ("USE_TF", "USE_FLAX"):
        monkeypatch.setenv(var, "0")
    pytest.importorskip("transformers")
    from genvc_tpu_torch.tools.verify_bundle import TOLERANCES, main, verify

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        results = verify(bundle_path, device="cpu")
        assert set(results) == set(TOLERANCES), results
        for fam, (diff, ok) in results.items():
            assert ok, f"{fam}: diff {diff} exceeds {TOLERANCES[fam]}"
            assert diff < 1e-4 or fam == "contentvec", (fam, diff)
        assert main([bundle_path, "--families", "perceiver,hifigan", "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(n)


def test_torch_infer_profile_writes_a_trace(bundle_path, tmp_path):
    """``--profile DIR``: the streaming conversion runs and leaves a Chrome
    trace in DIR holding the pipeline's spans, the decode's halves among
    them, and the recorder's counters; a conversion that fails to
    load its audio still writes the trace (every exit path)."""
    from genvc_tpu_torch import infer

    from genvc_tpu_torch.dsp.audio_io import write_wav

    rng = np.random.default_rng(0)
    src, ref = str(tmp_path / "src.wav"), str(tmp_path / "ref.wav")
    write_wav(src, rng.standard_normal(4800) * 0.1, 16000)  # 0.3 s
    write_wav(ref, rng.standard_normal(24000) * 0.1, 24000)
    flags = ["--model_path", bundle_path, "--device", "cpu", "--top_k", "1",
             "--streaming", "--src_wav", src, "--ref_audio", ref]
    prof = tmp_path / "prof"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert infer.main(flags + ["--output_path", str(tmp_path / "o.wav"),
                                   "--profile", str(prof)]) == 0
        trace = json.loads((prof / "trace.json").read_text())
        names = {ev.get("name") for ev in trace["traceEvents"]}
        assert "genvc.vocode" in names and (tmp_path / "o.wav").exists()
        assert {"genvc.decode.enqueue", "genvc.decode.readback"} <= names
        assert json.loads((prof / "counters.json").read_text())["engine.steps"] > 0
        missing = tmp_path / "prof2"
        assert infer.main(flags[:-4] + ["--src_wav", str(tmp_path / "none.wav"),
                                        "--ref_audio", ref, "--profile", str(missing)]) == 1
        assert (missing / "trace.json").exists()
    finally:
        torch.set_num_threads(n)
