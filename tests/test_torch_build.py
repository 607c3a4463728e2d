"""The kernel build's cache key: a library is named by a digest of its
``.cu`` source and of every shared ``csrc/*.cuh`` header, so an edit of a
header rebuilds every kernel that may include it. Runs on a temporary copy of
``csrc``; needs no ``nvcc``."""

import os
import shutil

from genvc_tpu_torch import _build


def test_torch_build_digest_covers_the_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    headers = sorted(p for p in os.listdir(csrc) if p.endswith(".cuh"))
    assert "mma_tiles.cuh" in headers
    names = sorted(p[:-3] for p in os.listdir(csrc) if p.endswith(".cu"))
    before = {n: _build._lib_path(n)[1] for n in names}
    assert before == {n: _build._lib_path(n)[1] for n in names}  # deterministic

    with open(csrc / "mma_tiles.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build._lib_path(n)[1] for n in names}
    assert all(after[n] != before[n] for n in names)

    (csrc / "extra.cuh").write_text("#pragma once\n")  # a new header counts too
    assert all(_build._lib_path(n)[1] != after[n] for n in names)

    src = _build._lib_path("decode_attention")[0]
    with open(src, "a") as f:
        f.write("\n// edited\n")
    again = _build._lib_path("decode_attention")[1]
    assert again != after["decode_attention"]
    assert os.path.basename(again).startswith("libdecode_attention-")
