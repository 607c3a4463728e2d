"""A training corpus written from the seed: utterances cut from the repo's
sample recordings, one speaker per recording, as 16-bit 24 kHz wav files
with a ``path|speaker`` metafile, the layout the port's datasets read."""

from __future__ import annotations

import os
import wave

import numpy as np

from perfbench import audio, traffic


def write(root: str, mix: dict, seed: int, out_dir: str) -> str:
    """Write ``mix["files"]`` utterances of ``mix["file_seconds"]`` under
    ``out_dir``; returns the metafile's path."""
    os.makedirs(out_dir, exist_ok=True)
    g = traffic.rng(seed, 11)
    rate = mix["sample_rate"]
    lines = []
    for i in range(int(mix["files"])):
        which = i % len(audio.SAMPLES)
        x = audio.clip(root, rate, mix["file_seconds"], which, float(g.random()))
        path = os.path.join(out_dir, f"utt{i:04d}.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes(np.rint(x[0] * 32768.0).clip(-32768, 32767).astype("<i2").tobytes())
        lines.append(f"{path}|spk{which}")
    meta = os.path.join(out_dir, "train.txt")
    with open(meta, "w") as f:
        f.write("\n".join(lines) + "\n")
    return meta
