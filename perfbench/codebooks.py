"""The dVAE codebooks, placed where their encoders' outputs lie.

A codebook drawn apart from its encoder (normal, unit scale) sits far from
the random encoder's outputs, and every position then snaps to the column of
the smallest norm: one code for a whole batch. A trained codebook lies among
the encoder's outputs (its EMA update is a running k-means). So each column
here is the encoder's output at a position of the repo's two sample
recordings, drawn from the seed, plus the column drawn in the weight tree
(unit normal) times ``SPREAD`` of that dimension's spread over the
positions. The traffic is cut from the same recordings, so its positions
spread over many codes, as a trained tokenizer's do.

The encoders are the reference's (:mod:`perfbench.reference.model`) in
float32 without TF32 over the seed's own encoder weights; the program is
handed the finished tree and the reference draws it again.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import audio, weights
from perfbench.reference import model as ref

SPREAD = 0.25


def _place(book: dict, z: torch.Tensor, seed: int, salt: int):
    """Columns of ``book["embed"]`` (D, N) moved to seeded positions of ``z``
    (P, D), keeping the drawn column as noise."""
    embed = book["embed"]
    gen = torch.Generator(device=embed.device).manual_seed(weights.torch_seed(seed + salt))
    idx = torch.randint(z.shape[0], (embed.shape[1],), generator=gen, device=embed.device)
    spread = z.std(dim=0)
    embed.copy_(z[idx].T + SPREAD * spread[:, None] * embed)


def fill(tree: dict, cfg: dict, seed: int, root: str) -> dict:
    """Place the codebook of each dVAE in ``tree`` (``content_dvae`` over
    ContentVec's features, ``acoustic_dvae`` over the dVAE mel); in place."""
    dev = next(tree[k]["codebook"]["embed"].device for k in ("content_dvae", "acoustic_dvae")
               if k in tree)
    with torch.no_grad(), ref.full_precision():
        if "content_dvae" in tree:
            zs = []
            for x in audio.corpus(root, 16000):
                wav = torch.as_tensor(x, device=dev)
                feats = ref.contentvec(tree["contentvec"], wav, wav.shape[0],
                                       cfg["contentvec"]["heads"])
                zs.append(ref.dvae_encode(tree["content_dvae"], feats, feats.shape[0]))
            _place(tree["content_dvae"]["codebook"], torch.cat(zs), seed, 1)
        if "acoustic_dvae" in tree:
            from perfbench.reference import train as rt

            norms = torch.as_tensor(np.load(f"{root}/{cfg['style_mel']['norms_file']}"),
                                    dtype=torch.float32, device=dev)
            zs = []
            for x in audio.corpus(root, cfg["dvae_mel"]["sample_rate"]):
                m = rt.mel(torch.as_tensor(x, device=dev), cfg["dvae_mel"], norms)
                zs.append(ref.dvae_encode(tree["acoustic_dvae"], m.T, m.shape[1]))
            _place(tree["acoustic_dvae"]["codebook"], torch.cat(zs), seed, 2)
    return tree
