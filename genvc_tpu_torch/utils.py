"""Host utilities (``genvc_tpu/utils.py``): the reference's feature plot
(utils.py:269-277), used by the dVAE stage's end-of-epoch images, and a
profiler context for the CLI's ``--profile``."""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import torch

from genvc_tpu_torch import tracing


def plot_feat(feat, path: str | None = None):
    """Render a (C, T) feature map; returns the matplotlib figure, saved to
    ``path`` when given. matplotlib is imported here, at first use."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 2))
    im = ax.imshow(np.asarray(feat), aspect="auto", origin="lower", interpolation="none")
    plt.colorbar(im, ax=ax)
    fig.canvas.draw()
    if path:
        fig.savefig(path, dpi=80, bbox_inches="tight")
    plt.close(fig)
    return fig


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """A ``torch.profiler`` trace of the block (host activity, and the
    card's kernels when a CUDA device is present), written on every exit
    from the block to ``<log_dir>/trace.json`` in Chrome's trace format
    (chrome://tracing, Perfetto or TensorBoard's profile plugin). The
    recorder (``tracing``) is enabled for the block, and what its counters
    gained there goes to ``<log_dir>/counters.json``; it is left on if it was
    on, and nothing it held is reset. A falsy ``log_dir`` traces nothing."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    was_on = tracing.enabled()
    before = tracing.snapshot()["counters"]
    tracing.enable()
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        if not was_on:
            tracing.disable()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        after = tracing.snapshot()["counters"]
        with open(os.path.join(log_dir, "counters.json"), "w") as f:
            json.dump({k: n - before.get(k, 0) for k, n in after.items()
                       if n != before.get(k, 0)}, f, indent=1, sort_keys=True)
