"""Host utilities (``genvc_tpu/utils.py``): the reference's feature plot
(utils.py:269-277), used by the dVAE stage's end-of-epoch images."""

from __future__ import annotations

import numpy as np


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
