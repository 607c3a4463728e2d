"""Listening samples of the GPT stage (``genvc_tpu/train/eval_samples.py``).

The reference's ``GPTTrainer.generate_eval_sample`` with ``GPT.eval_sample``
(trainers/gpt_trainer.py:146-170, layers/gpt.py:539-566): once per epoch,
generate sample 0's codes conditioned on its own speaker (a
self-reconstruction) and on another row's (a cross-speaker conversion),
decode them through the frozen acoustic dVAE and invert the mel with
Griffin-Lim.
"""

from __future__ import annotations

import numpy as np
import torch

from genvc_tpu_torch.decode import engine
from genvc_tpu_torch.dsp.griffinlim import invert_mel
from genvc_tpu_torch.models import gpt as gpt_model


@torch.no_grad()
def generate_eval_samples(model: gpt_model.GPT, acoustic_dvae, feats: dict, mel_norms,
                          generator: torch.Generator | None = None,
                          sampler: engine.SamplerConfig | None = None,
                          tgt_idx: int | None = None):
    """``feats``: ``gpt_stage.prepare_features`` of a batch. Returns
    (self_wav, cross_wav, tgt_idx), the waves float32 numpy at the dVAE's
    24 kHz. Each generation prefills and decodes up to
    ``max_gen_mel_tokens`` over an f32 cache, as the JAX package does."""
    sampler = sampler or engine.SamplerConfig()
    cfg = model.cfg
    cond_latents = gpt_model.get_style_emb(model, feats["cond_mels"])
    text = feats["text_inputs"][0:1]
    text_len = feats["text_lengths"][0:1]
    if tgt_idx is None:
        tgt_idx = int(np.random.default_rng(0).integers(0, cond_latents.shape[0]))

    def gen(cond):
        prefix, valid = gpt_model.build_prefix_emb(model, cond, text, text_len)
        state = engine.init_state(cfg, prefix.shape[1], 1, prefix.device,
                                  cache_dtype=torch.float32, generator=generator)
        engine.prefill(model, state, prefix, valid, sampler)
        toks, n_gen = engine.decode_all(model, state, sampler, cfg.max_gen_mel_tokens)
        toks = toks[0, : int(n_gen[0])].tolist()
        return [t for t in toks if t != cfg.stop_audio_token]

    def vocode(codes):
        if not codes:
            return np.zeros(1024, np.float32)
        # a code past the codebook (the GPT's start token, or any code of a
        # codebook smaller than the GPT's vocabulary) takes the last entry:
        # the JAX package's gather clamps the index
        codes = torch.tensor([codes], device=cond_latents.device)
        mel = acoustic_dvae.decode(codes.clamp(max=acoustic_dvae.cfg.num_tokens - 1))
        return invert_mel(mel[0], mel_norms)

    self_codes = gen(cond_latents[0:1])
    cross_codes = gen(cond_latents[tgt_idx: tgt_idx + 1])
    return vocode(self_codes), vocode(cross_codes), tgt_idx
