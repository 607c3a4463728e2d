"""Host-side dataset and collate policy of the GPT stage, numpy only
(``genvc_tpu/data/dataset.py``).

Mirrors the reference data pipeline (dataset.py):

* ``VCWaveDataset`` — metafile lines ``path|spk`` (:60-71); per item the full
  wav @24 kHz plus a 3–6 s conditioning slice from the same utterance
  (``gpt_use_masking_gt_prompt_approach=True``) or a random same-speaker
  utterance; corrupt files substitute a known-good sample (:73-79, 122-129).
  The collate crops the whole batch to one random common length in
  [min,max]_text_len × 1920 samples (:166-169) and pads conditioning to the
  batch max (:171-203).

As in the JAX package, the random common length is quantized to a small
bucket grid (multiples of ``text_bucket`` content tokens) and conditioning
lengths to ``cond_bucket`` samples, keeping the reference's length
distribution while bounding the number of distinct batch shapes.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

import numpy as np

from genvc_tpu_torch.dsp.audio_io import load_audio


def get_prompt_slice(path: str, max_len: int, min_len: int, sample_rate: int,
                     is_eval: bool = False, rng: random.Random | None = None):
    """Reference get_prompt_slice (dataset.py:14-39)."""
    rng = rng or random
    clip = load_audio(path, sample_rate)
    if clip is None:
        return None, None
    if is_eval:
        sample_length = int((min_len + max_len) / 2)
    else:
        sample_length = rng.randint(min_len, max_len)
    gap = clip.shape[-1] - sample_length
    if gap < 0:
        sample_length = clip.shape[-1] // 2
        gap = clip.shape[-1] - sample_length
    start = 0 if is_eval else rng.randint(0, gap)
    piece = clip[:, start : start + sample_length]
    out = np.zeros((1, max_len), np.float32)
    out[:, : piece.shape[-1]] = piece
    return out, piece.shape[-1]


@dataclass
class VCDatasetConfig:
    meta_file: str = ""
    sample_rate: int = 24000
    text_frame_rate: float = 0.02
    min_text_len: int = 15
    max_text_len: int = 100
    min_conditioning_length: int = 72000
    max_conditioning_length: int = 144000
    use_masking_gt_prompt_approach: bool = True
    is_eval: bool = False
    text_bucket: int = 5          # quantize common text len to this grid
    cond_bucket: int = 24000      # quantize cond len to this grid


class VCWaveDataset:
    def __init__(self, cfg: VCDatasetConfig, seed: int = 1994):
        self.cfg = cfg
        self.content2wav = int(cfg.text_frame_rate * cfg.sample_rate) * 4
        self.samples = []
        self.spk2utt: dict[str, list[str]] = {}
        with open(cfg.meta_file) as f:
            for line in f:
                parts = line.strip().split("|")
                if len(parts) != 2:
                    continue
                path, spk = parts
                self.samples.append({"audio_file": path, "spk": spk})
                self.spk2utt.setdefault(spk, []).append(path)
        self.substitution = None
        for s in self.samples[:64]:
            if load_audio(s["audio_file"], cfg.sample_rate) is not None:
                self.substitution = s["audio_file"]
                break
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.samples)

    def load_item(self, index: int, rng: random.Random):
        cfg = self.cfg
        sample = self.samples[index]
        path = sample["audio_file"]
        wav = load_audio(path, cfg.sample_rate)
        if wav is None:
            path = self.substitution
            wav = load_audio(path, cfg.sample_rate)
            ref = path
        elif cfg.use_masking_gt_prompt_approach:
            ref = path
        else:
            ref = rng.choice(self.spk2utt[sample["spk"]])
        cond, cond_len = get_prompt_slice(
            ref, cfg.max_conditioning_length, cfg.min_conditioning_length,
            cfg.sample_rate, cfg.is_eval, rng)
        if cond is None:
            cond, cond_len = get_prompt_slice(
                path, cfg.max_conditioning_length, cfg.min_conditioning_length,
                cfg.sample_rate, cfg.is_eval, rng)
        return {"wav": wav, "cond": cond, "cond_len": cond_len, "path": path}

    def collate(self, indices, rng: random.Random | None = None):
        """Build one fixed-shape batch (reference collate_fn, dataset.py:145-205
        with bucketed lengths)."""
        cfg = self.cfg
        rng = rng or self._rng
        items = []
        for i in indices:
            try:
                items.append(self.load_item(i, rng))
            except Exception:
                items.append(self.load_item(1 % len(self.samples), rng))
        b = len(items)

        # random common crop length, quantized to the text bucket grid
        text_len = rng.randint(cfg.min_text_len, cfg.max_text_len)
        text_len = max(cfg.min_text_len,
                       (text_len // cfg.text_bucket) * cfg.text_bucket)
        max_avail = max(it["wav"].shape[-1] for it in items) // self.content2wav
        batch_text_len = max(1, min(text_len, max_avail))
        batch_wav_len = batch_text_len * self.content2wav

        cond_len = max(it["cond_len"] for it in items)
        cond_len = min(int(np.ceil(cond_len / cfg.cond_bucket)) * cfg.cond_bucket,
                       cfg.max_conditioning_length)

        wav = np.zeros((b, 1, batch_wav_len), np.float32)
        conds = np.zeros((b, 1, 1, cond_len), np.float32)
        wav_lengths = np.zeros((b,), np.int64)
        text_lengths = np.zeros((b,), np.int64)
        cond_lens = np.full((b,), cond_len, np.int64)
        for i, it in enumerate(items):
            w = it["wav"]
            gap = w.shape[-1] - batch_wav_len
            if gap < 0:
                seg_len = (w.shape[-1] // self.content2wav) * self.content2wav
                wav[i, :, :seg_len] = w[:, :seg_len]
                wav_lengths[i] = seg_len
                text_lengths[i] = seg_len // self.content2wav
            else:
                start = rng.randint(0, gap)
                wav[i, 0] = w[0, start : start + batch_wav_len]
                wav_lengths[i] = batch_wav_len
                text_lengths[i] = batch_text_len
            c = it["cond"][0]
            gap = c.shape[-1] - cond_len
            start = rng.randint(0, max(gap, 0))
            conds[i, 0, 0] = c[start : start + cond_len]
        return {"wav": wav, "wav_lengths": wav_lengths,
                "text_lengths": text_lengths, "conditioning": conds,
                "cond_lens": cond_lens}
