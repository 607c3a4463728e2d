"""Voice conversion, streaming and offline (``genvc_tpu/inference/pipeline.py``
without the quantized modes; the serving pool is
``serving.server.StreamServer``, built on ``stream_chunk_batch`` here).

The chain: resample the source to 16 kHz; ContentVec -> content-dVAE codes
per 6 s segment; Perceiver speaker latents from the reference's mel; GPT
prefix + prefill; then

* streaming (``synthesize_streaming``, and ``synthesize_streaming_batch`` for
  B utterances in lockstep): decode in windows (the first of
  ``first_chunk_tokens`` tokens, 4 by default: the prefill latent plus 3
  decode steps; later ones 8); each window's latents x4-interpolated and vocoded by
  HiFi-GAN with its own conv context; windows joined with a 1024-sample
  crossfade;
* offline (``synthesize``, and ``synthesize_batch``): decode each segment to
  its stop token or cap (``engine.decode_all``, or with ``num_beams > 1`` /
  ``penalty_alpha > 0`` one of the engine's beam, group-beam and contrastive
  searches over the segment tiled to the beams), re-run the generated codes
  teacher-forced through the GPT for their latents (the latent pass, whose
  attention is the flash-attention kernel), and vocode the whole utterance
  in one masked call.

The streaming loops emit the same windows as the JAX ones. Their speculative
in-flight depth and multi-window calls hid TPU-link round trips and are not
needed here: a loop decodes one window, reads its tokens back, vocodes, and
goes on. Static widths (6 s segments, 80 content codes, 6 s reference chunks,
latent widths in buckets of 64) and the KV-cache geometry are the JAX
package's, so both sides compute over the same shapes.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from torch.profiler import record_function

from genvc_tpu_torch import resolve_device
from genvc_tpu_torch.checkpoint import Modules, convert_bundle, load_jax_tree
from genvc_tpu_torch.config import GenVCConfig
from genvc_tpu_torch.decode import engine
from genvc_tpu_torch.dsp import mel as mel_mod
from genvc_tpu_torch.models import contentvec, dvae, gpt as gpt_model, hifigan
from genvc_tpu_torch.ops.conv import linear_interp_x4

COND_CHUNK_SECONDS = 6
COND_MAX_SECONDS = 30
SEG_SECONDS = 6.0
MIN_CHUNK_FRACTION = 0.32
STREAM_CHUNK = 8
CROSSFADE = 1024
TEXT_WIDTH = 80  # static content-code width (6 s @ 12.5 Hz = 75 codes)
# KV-cache headroom past the generation cap: the JAX streaming loop's overshoot of
# one in-flight call (STREAM_CHUNK * chunks_per_call = 16 steps). Kept so the
# cache geometry is the JAX package's (T = 384 for the flagship at cap 1.875).
CACHE_SLACK = 16
LATENT_BUCKET = 64  # latent-pass and offline-vocoder widths, in codes


def _bucket(n: int, step: int = LATENT_BUCKET) -> int:
    return max(step, int(np.ceil(n / step) * step))


class GenVCPipeline:
    def __init__(self, config: GenVCConfig, modules: Modules, mel_norms,
                 device, seed: int = 0, kv_cache_dtype: str | None = None):
        self.config = config
        self.device = device
        self.gpt = modules.gpt
        self.gpt_cfg = modules.gpt.cfg
        self.hifigan = modules.hifigan
        self.content_dvae = modules.content_dvae
        self.contentvec = modules.contentvec
        self.mel_norms = mel_norms
        if kv_cache_dtype is None:
            self.cache_dtype = self.gpt.compute_dtype
        elif kv_cache_dtype == "fp8":
            self.cache_dtype = torch.float8_e4m3fn
        else:
            raise ValueError(f"unsupported kv_cache_dtype {kv_cache_dtype!r}; "
                             "supported: 'fp8'")
        self.sample_rate = config.audio.sample_rate
        self.content_sample_rate = config.audio.content_sample_rate
        self.hifigan_scale_factor = int(config.model_args.gpt_code_stride_len
                                        // config.vocoder_config.hop_length)
        self.style_spec = mel_mod.MelSpec(
            sample_rate=self.sample_rate, n_fft=2048, win_length=1024,
            hop_length=256, n_mels=80, fmin=0, fmax=8000.0, scale="htk")
        self.sampler = engine.SamplerConfig(
            temperature=config.temperature, top_k=config.top_k,
            top_p=config.top_p, repetition_penalty=config.repetition_penalty)
        self._seg_len_16k = int(SEG_SECONDS * self.content_sample_rate)
        self._min_chunk_16k = int(MIN_CHUNK_FRACTION * self.content_sample_rate)
        self._cond_chunk = COND_CHUNK_SECONDS * self.sample_rate
        self._prefix_width = self.gpt_cfg.n_cond_latents + TEXT_WIDTH + 2
        self.generator = torch.Generator(device=device).manual_seed(seed)
        # with random (untrained) weights generation never reaches the stop
        # token; cap new tokens at ratio x content codes (a trained model
        # emits ~1.875 audio codes per content code)
        self.gen_cap_tokens_per_code: float | None = None
        # first emitted window of a stream, in AR tokens (the latency knob):
        # 4 is the prefill latent plus 3 decode steps; later windows keep the
        # 8-token cadence; STREAM_CHUNK mirrors the reference exactly
        self.first_chunk_tokens: int = 4
        self.last_timing: dict = {}
        self._cond_latent = None

    # ------------------------------------------------------------ host maths

    def _host_n_codes(self, t_real: int) -> int:
        """Content-code count for ``t_real`` samples (the conv stride chains
        of ContentVec and the content dVAE)."""
        valid = t_real
        for _, k, s in contentvec.CONV_LAYERS:
            valid = max((valid - k) // s + 1, 0)
        for _ in range(self.content_dvae.cfg.num_layers):
            valid = (valid - 1) // 2 + 1
        return valid

    def _max_new(self, n_codes: int) -> int:
        max_new = self.gpt_cfg.max_gen_mel_tokens
        if self.gen_cap_tokens_per_code is not None:
            cap = max(8, int(n_codes * self.gen_cap_tokens_per_code))
            max_new = min(max_new, int(np.ceil(cap / 16) * 16))
        return max_new

    def _cache_gen_tokens(self) -> int | None:
        """KV-cache generation capacity: None (architectural max) without a
        cap, else a full segment's cap plus ``CACHE_SLACK``."""
        if self.gen_cap_tokens_per_code is None:
            return None
        full_codes = self._host_n_codes(self._seg_len_16k)
        return min(self.gpt_cfg.max_gen_mel_tokens,
                   self._max_new(full_codes) + CACHE_SLACK)

    @staticmethod
    def _pcm16(x: np.ndarray) -> np.ndarray:
        """Quantize to int16 PCM, as the JAX pipeline does before its transfer,
        so both see the same signal."""
        return np.clip(np.rint(np.asarray(x) * 32768.0), -32768, 32767).astype(np.int16)

    def _to_device_pcm(self, pcm: np.ndarray):
        return torch.as_tensor(pcm.astype(np.float32), device=self.device) / 32768.0

    # ------------------------------------------------------- building blocks

    def _prep_ref_chunks(self, ref_audio: np.ndarray):
        """Split the reference into up to 5 6-s chunks, reflect-pad each
        around its true extent, zero-pad to the static width. Returns
        (int16 chunks (5, W), n_frames_valid (5,), chunk_valid (5,))."""
        sr = self.sample_rate
        audio = np.asarray(ref_audio)
        if audio.shape[1] > sr * COND_MAX_SECONDS:
            audio = audio[:, : sr * COND_MAX_SECONDS]
        pad_fft = self.style_spec.n_fft // 2
        static_w = self._cond_chunk + 2 * pad_fft
        n_max = COND_MAX_SECONDS // COND_CHUNK_SECONDS
        chunks = np.zeros((n_max, static_w), np.float32)
        n_frames = np.zeros((n_max,), np.int64)
        valid = np.zeros((n_max,), bool)
        row = 0
        for i in range(0, audio.shape[1], self._cond_chunk):
            chunk = audio[:, i : i + self._cond_chunk]
            if chunk.shape[-1] < sr * 0.33:
                continue
            padded = np.pad(chunk, ((0, 0), (pad_fft, pad_fft)), mode="reflect")
            chunks[row, : padded.shape[1]] = padded[0]
            n_frames[row] = chunk.shape[-1] // self.style_spec.hop_length + 1
            valid[row] = True
            row += 1
        return self._pcm16(chunks), n_frames, valid

    @torch.inference_mode()
    def get_gpt_cond_latents(self, ref_audio: np.ndarray):
        """(1, T) 24 kHz reference -> (1, 32, D) speaker latents: the mean of
        the latents of its 6-s chunks (at most 30 s)."""
        return self.get_gpt_cond_latents_batch([ref_audio])

    @torch.inference_mode()
    def get_gpt_cond_latents_batch(self, ref_audios):
        """List of B (1, T) references -> (B, 32, D) latents, each the mean
        over its own valid chunks; the chunks of all references go through
        the mel and the Perceiver as one batch."""
        preps = [self._prep_ref_chunks(r) for r in ref_audios]
        counts = [int(valid.sum()) for _, _, valid in preps]
        if min(counts) == 0:
            raise ValueError("reference audio is shorter than 0.33 s")
        wav = self._to_device_pcm(np.concatenate([pcm[valid] for pcm, _, valid in preps]))
        m = mel_mod.mel_torchaudio(wav, self.style_spec, self.mel_norms,
                                   pre_padded=True)
        frames = torch.as_tensor(np.concatenate([n[valid] for _, n, valid in preps]),
                                 device=self.device)
        frame_valid = torch.arange(m.shape[-1], device=self.device)[None, :] < frames[:, None]
        embs = gpt_model.get_style_emb(self.gpt, m, frame_valid)
        return torch.stack([e.sum(dim=0) / n for e, n in zip(embs.split(counts), counts)])

    @torch.inference_mode()
    def extract_content_codes(self, seg16k: np.ndarray, t_real: int):
        """(1, 96000) zero-padded 16 kHz segment with ``t_real`` true samples
        -> (codes (1, TEXT_WIDTH) int64 on device, n_codes)."""
        codes, n_codes = self.extract_content_codes_batch(seg16k, [t_real])
        return codes, n_codes[0]

    @torch.inference_mode()
    def extract_content_codes_batch(self, segs16k: np.ndarray, t_reals):
        """(B, 96000) zero-padded 16 kHz segments with ``t_reals`` true
        samples each -> (codes (B, TEXT_WIDTH) int64 on device, n_codes
        list)."""
        wav = self._to_device_pcm(self._pcm16(segs16k))
        sample_valid = torch.tensor(list(t_reals), device=self.device)
        feats = self.contentvec(wav, sample_valid).transpose(1, 2)
        valid = sample_valid
        for _, k, s in contentvec.CONV_LAYERS:
            valid = ((valid - k) // s + 1).clamp_min(0)
        codes = self.content_dvae.get_codebook_indices(feats, valid_len=valid)
        codes = torch.nn.functional.pad(codes, (0, TEXT_WIDTH - codes.shape[1]))
        return codes, [self._host_n_codes(t) for t in t_reals]

    def _segments(self, src_wav: np.ndarray):
        """Split the source into 6 s segments, the last one counted as at
        least 0.32 s; yields (zero-padded segment, true length)."""
        total = src_wav.shape[-1]
        for i in range(0, total, self._seg_len_16k):
            seg = src_wav[:, i : i + self._seg_len_16k]
            t_real = max(seg.shape[-1], self._min_chunk_16k)
            padded = np.pad(seg, ((0, 0), (0, self._seg_len_16k - seg.shape[-1])))
            yield padded, t_real

    def _round_rows(self, seg_lists, r: int):
        """Round ``r`` of a lockstep batch: every utterance's r-th segment.
        An utterance with fewer segments rides along as a zero segment of
        the minimum length and is dropped. Returns (segments (B, 96000),
        true lengths, active flags)."""
        segs, t_reals, active = [], [], []
        for s in seg_lists:
            if r < len(s):
                seg, t_real = s[r]
            else:
                seg = np.zeros((1, self._seg_len_16k), np.float32)
                t_real = self._min_chunk_16k
            segs.append(seg[0])
            t_reals.append(t_real)
            active.append(r < len(s))
        return np.stack(segs), t_reals, active

    @torch.inference_mode()
    def _start_segment(self, segs: np.ndarray, t_reals, cond, per_row: bool = False,
                       row_params=None):
        """Content codes + prefix + prefill for B segments (B, 96000) with
        speaker latents ``cond`` (B, 32, D); returns (state, first tokens
        (B,), first latents (B, D), codes (B, TEXT_WIDTH), n_codes list).
        ``per_row`` gives the state per-row positions (a serving pool's
        admission rows); ``row_params`` samples each row under its own
        config."""
        codes, n_codes = self.extract_content_codes_batch(segs, t_reals)
        text_len = torch.tensor(n_codes, device=self.device)
        prefix, valid = gpt_model.build_prefix_emb(self.gpt, cond, codes, text_len)
        state = engine.init_state(self.gpt_cfg, self._prefix_width, len(n_codes),
                                  self.device, cache_dtype=self.cache_dtype,
                                  generator=self.generator,
                                  gen_tokens=self._cache_gen_tokens(), per_row=per_row)
        tok0, lat0 = engine.prefill(self.gpt, state, prefix, valid, self.sampler,
                                    row_params)
        return state, tok0, lat0, codes, n_codes

    @torch.inference_mode()
    def _tiled_segment(self, codes, n_codes: int, rows: int):
        """One segment's hypothesis tiled to ``rows`` rows (beams or
        candidates): (prefix, prefix_valid, a fresh decode state at the
        pipeline's cache type and capacity)."""
        prefix, valid = gpt_model.build_prefix_emb(
            self.gpt, self._cond_latent.expand(rows, -1, -1), codes.expand(rows, -1),
            torch.full((rows,), n_codes, device=self.device))
        state = engine.init_state(self.gpt_cfg, self._prefix_width, rows, self.device,
                                  cache_dtype=self.cache_dtype, generator=self.generator,
                                  gen_tokens=self._cache_gen_tokens())
        return prefix, valid, state

    @torch.inference_mode()
    def generate_segment_codes(self, codes, n_codes: int, num_beams: int = 1,
                               length_penalty: float = 1.0, penalty_alpha: float = 0.0,
                               contrastive_top_k: int = 4, beam_do_sample: bool = False,
                               num_beam_groups: int = 1, diversity_penalty: float = 1.0):
        """AR generation for one segment (``codes`` (1, TEXT_WIDTH) on the
        device, ``n_codes`` of them valid, after :meth:`get_gpt_cond_latents`
        set ``_cond_latent``); returns (generated tokens incl. the stop token,
        the forwards run; the JAX package returns None there).
        ``penalty_alpha > 0`` with ``num_beams <= 1`` is contrastive search
        over ``contrastive_top_k`` candidates; ``num_beams > 1`` with
        ``num_beam_groups > 1`` group beam search with ``diversity_penalty``
        (``beam_do_sample`` raises there); ``num_beams > 1`` beam search with
        ``length_penalty``, or with ``beam_do_sample`` HF beam_sample under
        the sampler's warpers (what the reference's ``inference(num_beams >
        1)`` reaches); otherwise the sampler's decoding."""
        max_new = self._max_new(n_codes)
        smp = self.sampler
        # HF normalises by the fake input_ids length: cond latents +
        # [start_text | codes | stop_text] + start_audio
        fake_len = self.gpt_cfg.n_cond_latents + n_codes + 3
        if num_beams <= 1 and penalty_alpha > 0.0:
            prefix, valid, state = self._tiled_segment(codes, n_codes, contrastive_top_k)
            buf, n = engine.decode_contrastive(
                self.gpt, state, prefix, valid, max_new, top_k=contrastive_top_k,
                penalty_alpha=float(penalty_alpha),
                repetition_penalty=smp.repetition_penalty)
        elif num_beams > 1 and num_beam_groups > 1:
            if beam_do_sample:
                raise ValueError("group beam search is deterministic; do_sample is "
                                 "not supported with num_beam_groups > 1 (HF rejects "
                                 "it too)")
            prefix, valid, state = self._tiled_segment(codes, n_codes, num_beams)
            buf, n = engine.decode_group_beam(
                self.gpt, state, prefix, valid, max_new, num_beams, num_beam_groups,
                diversity_penalty=float(diversity_penalty), length_penalty=length_penalty,
                repetition_penalty=smp.repetition_penalty, prefix_fake_len=fake_len)
        elif num_beams > 1:
            prefix, valid, state = self._tiled_segment(codes, n_codes, num_beams)
            buf, n = engine.decode_beam(
                self.gpt, state, prefix, valid, max_new, num_beams,
                length_penalty=length_penalty, repetition_penalty=smp.repetition_penalty,
                prefix_fake_len=fake_len, do_sample=beam_do_sample,
                temperature=smp.temperature, top_k=smp.top_k, top_p=smp.top_p)
        else:
            prefix, valid, state = self._tiled_segment(codes, n_codes, 1)
            engine.prefill(self.gpt, state, prefix, valid, smp)
            toks, n_gen = engine.decode_all(self.gpt, state, smp, max_new)
            buf, n = toks[0], int(n_gen[0])
        return buf[:n].tolist(), state.steps

    @torch.inference_mode()
    def _latent_pass(self, codes, n_codes, gens, cond):
        """Teacher-forced latents of the generated codes (the JAX
        ``latent_fn``): ``gens`` holds each row's codes without the stop
        token, at a width bucketed to 64 past the longest + 3. Returns (B,
        W, D) f32; row i's first len(gens[i]) latents are its own."""
        wm = _bucket(max(len(g) for g in gens) + 3)
        gen_arr = np.zeros((len(gens), wm), np.int64)
        n_arr = np.ones((len(gens),), np.int64)
        for i, g in enumerate(gens):
            gen_arr[i, : len(g)] = g
            n_arr[i] = max(len(g), 1)
        dev = self.device
        lat = gpt_model.forward_latent(
            self.gpt, codes, torch.tensor(n_codes, device=dev),
            torch.as_tensor(gen_arr, device=dev),
            torch.as_tensor(n_arr * self.gpt_cfg.code_stride_len, device=dev), cond)
        return lat.float()

    @torch.inference_mode()
    def vocode(self, latents, valid: int | None = None):
        """(N, W, D) latent windows -> (N, W * 1024) audio, each window with
        its own conv context. ``valid`` < W vocodes only the first ``valid``
        latents of a zero-padded window, masked so the valid samples equal an
        exact-width run (the JAX ``vocode_tail_fn``)."""
        x = linear_interp_x4(latents.transpose(1, 2), self.hifigan_scale_factor,
                             valid_len=valid)
        vlen = None if valid is None else valid * self.hifigan_scale_factor
        return self.hifigan(x, valid_len=vlen)[:, 0]

    def _vocode_tail(self, all_lats, row: int, start: int, rem: int, win: int):
        """The end of a segment: ``rem`` latents of row ``row`` of ``all_lats``
        (B, W, D) from ``start``, vocoded in a ``win``-wide window masked past
        ``rem`` (the JAX ``vocode_tail_fn``). The buffer reads as zeros past
        its end, as JAX's ``+win`` pad, so ``start + win`` may run past W.
        Returns (rem * 1024,) audio."""
        lat = torch.zeros(1, win, all_lats.shape[-1], device=all_lats.device)
        src = all_lats[row, start : start + rem]
        lat[0, : src.shape[0]] = src
        wav = self.vocode(lat, valid=rem)
        return wav[0, : rem * self.gpt_cfg.code_stride_len]

    def stream_chunk_batch(self, state, k: int, carry, win: int = STREAM_CHUNK,
                           row_params=None):
        """``k`` decode steps on ``state`` (in place), then every row's
        complete ``win``-latent windows of [carry | new latents] vocoded (the
        JAX ``stream_chunk_batch_fn``, one pool tick). ``carry`` (B, c, D)
        holds latents carried from the last call; ``row_params`` (dict of
        (B,) tensors) only when some row has its own sampler. Returns
        (tokens (B, k), all latents (B, c + k, D), finished-before-step
        (B, k), audio (B, (c + k) // win, win * 1024))."""
        toks, lats, pre_fin = engine.decode_chunk(self.gpt, state, self.sampler,
                                                  chunk=k, row_params=row_params)
        all_lats = torch.cat([carry, lats], dim=1)
        return toks, all_lats, pre_fin, self.batch_window_vocode(all_lats, win)

    def batch_window_vocode(self, all_lats, win: int):
        """(B, W, D) latents -> (B, W // win, win * 1024) audio: each row's
        complete ``win``-latent windows folded into the vocoder's batch, each
        vocoded with its own conv context (the JAX ``batch_window_vocode``)."""
        b, w, d = all_lats.shape
        n = w // win
        wavs = self.vocode(all_lats[:, : n * win].reshape(b * n, win, d))
        return wavs.reshape(b, n, -1)

    def _vocode_utterance(self, lat) -> np.ndarray:
        """(n, D) latents of a whole utterance -> (n * 1024,) audio: one
        vocoder call at width ``_bucket(n)``, masked past n (the JAX
        ``vocode_masked_fn``)."""
        n = lat.shape[0]
        padded = torch.zeros(1, _bucket(n), lat.shape[-1], device=lat.device)
        padded[0, :n] = lat
        wav = self.vocode(padded, valid=n)
        return wav[0, : n * self.gpt_cfg.code_stride_len].float().cpu().numpy()

    # ------------------------------------------------------------ public API

    @torch.inference_mode()
    def synthesize(self, src_wav: np.ndarray, ref_audio: np.ndarray,
                   num_beams: int = 1, length_penalty: float = 1.0,
                   penalty_alpha: float = 0.0, contrastive_top_k: int = 4,
                   beam_do_sample: bool = False, num_beam_groups: int = 1,
                   diversity_penalty: float = 1.0) -> np.ndarray:
        """Non-streaming VC (reference synthesize_utt): ``src_wav`` (1, T) at
        16 kHz, ``ref_audio`` (1, T) at 24 kHz -> (T_out,) at 24 kHz. Per 6 s
        segment: content codes, the tokens of the decoding that
        :meth:`generate_segment_codes` routes to (the sampler's, or with
        ``num_beams > 1`` / ``penalty_alpha > 0`` a search: the reference
        ``HiFiGANTrainer.inference`` surface and the vendored HF generator's
        modes), the latent pass; then one masked vocoder call over the whole
        utterance. ``self.last_timing`` counts ``decode_steps`` (the
        forwards run) and ``latent_passes``."""
        return self._synthesize_with(src_wav, ref_audio, lambda codes, n_code: (
            self.generate_segment_codes(
                codes, n_code, num_beams=num_beams, length_penalty=length_penalty,
                penalty_alpha=penalty_alpha, contrastive_top_k=contrastive_top_k,
                beam_do_sample=beam_do_sample, num_beam_groups=num_beam_groups,
                diversity_penalty=diversity_penalty)))

    @torch.inference_mode()
    def _synthesize_with(self, src_wav: np.ndarray, ref_audio: np.ndarray,
                         decode_segment) -> np.ndarray:
        """:meth:`synthesize` with each segment's tokens from
        ``decode_segment(codes, n_codes)`` -> (tokens incl. the stop token,
        forwards run), as :meth:`generate_segment_codes` returns them."""
        timing = self.last_timing = {"decode_steps": 0, "latent_passes": 0}
        stop = self.gpt_cfg.stop_audio_token
        with record_function("genvc.cond_latents"):
            self._cond_latent = self.get_gpt_cond_latents(ref_audio)
        final = []
        for seg, t_real in self._segments(src_wav):
            with record_function("genvc.content_codes"):
                codes, n_code = self.extract_content_codes(seg, t_real)
            with record_function("genvc.decode"):
                toks, steps = decode_segment(codes, n_code)
            timing["decode_steps"] += steps
            gen = [int(t) for t in toks if t != stop]
            if not gen:
                continue
            with record_function("genvc.latent_pass"):
                lat = self._latent_pass(codes, [n_code], [gen], self._cond_latent)
            timing["latent_passes"] += 1
            final.append(lat[0, : len(gen)])
        if not final:
            # every segment decoded straight to the stop token
            return np.zeros((0,), np.float32)
        with record_function("genvc.vocode"):
            return self._vocode_utterance(torch.cat(final))

    @torch.inference_mode()
    def synthesize_batch(self, src_wavs, ref_audios):
        """Batched offline conversion: B utterances' segments decode together,
        round r taking every utterance's r-th segment. ``src_wavs`` /
        ``ref_audios``: lists of (1, T) arrays at 16 kHz / 24 kHz. Returns a
        list of (T_out,) waveforms at 24 kHz."""
        bsz = len(src_wavs)
        timing = self.last_timing = {"decode_steps": 0, "latent_passes": 0}
        stop = self.gpt_cfg.stop_audio_token
        conds = self.get_gpt_cond_latents_batch(ref_audios)
        seg_lists = [list(self._segments(s)) for s in src_wavs]
        latents = [[] for _ in range(bsz)]
        for r in range(max(len(s) for s in seg_lists)):
            segs, t_reals, active = self._round_rows(seg_lists, r)
            state, _, _, codes, n_codes = self._start_segment(segs, t_reals, conds)
            toks, n_gen = engine.decode_all(self.gpt, state, self.sampler,
                                            max(self._max_new(n) for n in n_codes))
            timing["decode_steps"] += state.n_generated - 1
            toks, n_gen = toks.tolist(), n_gen.tolist()
            # per-row generation cap (the batch decodes to the largest)
            gens = [[t for t in toks[i][: n_gen[i]] if t != stop][: self._max_new(n_codes[i])]
                    if active[i] else [] for i in range(bsz)]
            if not any(gens):
                continue
            lat = self._latent_pass(codes, n_codes, gens, conds)
            timing["latent_passes"] += 1
            for i, g in enumerate(gens):
                if g:
                    latents[i].append(lat[i, : len(g)])
        return [self._vocode_utterance(torch.cat(lats)) if lats
                else np.zeros((0,), np.float32) for lats in latents]

    @torch.inference_mode()
    def synthesize_streaming(self, src_wav: np.ndarray, ref_audio: np.ndarray,
                             verbose: bool = True):
        """Streaming VC (reference synthesize_utt_streaming). ``src_wav``
        (1, T) at 16 kHz, ``ref_audio`` (1, T) at 24 kHz. Returns (wav,
        first-chunk latency in s, RTF); ``self.last_timing["decode_steps"]``
        counts the AR steps run."""
        begin = time.perf_counter()
        timing = self.last_timing = {}
        stop = self.gpt_cfg.stop_audio_token
        csz = STREAM_CHUNK
        d = self.gpt_cfg.model_dim
        pred_audios = []
        wav_overlap = None
        latency = None

        def emit(wav_gen):
            nonlocal wav_overlap, latency
            chunk_wav, wav_overlap = _handle_chunk(
                wav_gen.float().cpu().numpy(), wav_overlap, CROSSFADE)
            pred_audios.append(chunk_wav)
            if latency is None:
                latency = time.perf_counter() - begin
                if verbose:
                    print(f"Latency: {latency:.3f}s")

        self._cond_latent = None
        for seg, t_real in self._segments(src_wav):
            if self._cond_latent is None:
                with record_function("genvc.cond_latents"):
                    self._cond_latent = self.get_gpt_cond_latents(ref_audio)
                win = max(1, min(self.first_chunk_tokens, csz))
            else:
                win = csz
            with record_function("genvc.prefill"):
                state, _, lat0, _, _ = self._start_segment(seg, [t_real],
                                                           self._cond_latent)
            max_new = self._max_new(self._host_n_codes(t_real))
            carry, carry_n, k = lat0[:, None, :], 1, win - 1
            n_total = 1
            first_chunk = True
            while True:
                with record_function("genvc.decode"):
                    toks, lats, pre_fin = engine.decode_chunk(self.gpt, state,
                                                              self.sampler, chunk=k)
                    all_lats = torch.cat([carry, lats], dim=1)
                    toks_np = toks[0].cpu().numpy()
                timing["decode_steps"] = timing.get("decode_steps", 0) + k
                if first_chunk and bool(pre_fin[0, 0]):
                    # EOS on the prefill-sampled token: vocode that latent only
                    with record_function("genvc.vocode"):
                        emit(self._vocode_tail(all_lats, 0, 0, 1, win))
                    break
                first_chunk = False
                eos_j, _, full, rem = window_accounting(
                    toks_np, n_total, max_new, stop, carry_n, win)
                with record_function("genvc.vocode"):
                    if full:
                        wavs = self.vocode(all_lats[:, : full * win].reshape(full, win, d))
                        for w in range(full):
                            emit(wavs[w])
                    if eos_j is not None and rem > 0:
                        emit(self._vocode_tail(all_lats, 0, full * win, rem, win))
                if eos_j is not None:
                    break
                n_total += k
                carry = all_lats[:, :0]
                carry_n, k, win = 0, csz, csz

        wav = np.concatenate(pred_audios, axis=-1)
        rtf = (time.perf_counter() - begin) / (src_wav.shape[-1] / self.content_sample_rate)
        if verbose:
            print(f"Real-time factor: {rtf:.3f}")
        return wav, latency, rtf

    @torch.inference_mode()
    def synthesize_streaming_batch(self, src_wavs, ref_audios, verbose: bool = True):
        """B utterances streamed in lockstep through the batched decode: per-
        row EOS and cap, per-row crossfade, the short first window in round 0
        (each row's first audio). ``src_wavs`` / ``ref_audios``: lists of
        (1, T) arrays at 16 kHz / 24 kHz. Returns (list of (T_out,) wavs at
        24 kHz, per-row first-chunk latency in s, aggregate RTF = elapsed /
        total source audio); ``self.last_timing["decode_steps"]`` counts the
        AR steps run."""
        begin = time.perf_counter()
        timing = self.last_timing = {"decode_steps": 0}
        bsz = len(src_wavs)
        stop = self.gpt_cfg.stop_audio_token
        csz = STREAM_CHUNK
        outs = [[] for _ in range(bsz)]
        overlaps = [None] * bsz
        latencies = [None] * bsz

        def emit(i, wav_gen):
            chunk, overlaps[i] = _handle_chunk(wav_gen.float().cpu().numpy(),
                                               overlaps[i], CROSSFADE)
            outs[i].append(chunk)
            if latencies[i] is None:
                latencies[i] = time.perf_counter() - begin

        conds = self.get_gpt_cond_latents_batch(ref_audios)
        seg_lists = [list(self._segments(s)) for s in src_wavs]
        for r in range(max(len(s) for s in seg_lists)):
            segs, t_reals, active = self._round_rows(seg_lists, r)
            state, _, lat0, _, n_codes = self._start_segment(segs, t_reals, conds)
            caps = [self._max_new(n) if a else 1 for n, a in zip(n_codes, active)]
            done = [not a for a in active]
            win = max(1, min(self.first_chunk_tokens, csz)) if r == 0 else csz
            carry, carry_n, k = lat0[:, None, :], 1, win - 1
            n_total = 1
            first_call = True
            while not all(done):
                toks, lats, pre_fin = engine.decode_chunk(self.gpt, state,
                                                          self.sampler, chunk=k)
                all_lats = torch.cat([carry, lats], dim=1)
                toks_np, pre_fin_np = toks.cpu().numpy(), pre_fin.cpu().numpy()
                timing["decode_steps"] += k
                ends = {}  # row -> (complete windows, remainder), for rows still going
                for i in range(bsz):
                    if done[i]:
                        continue
                    if first_call and bool(pre_fin_np[i, 0]):
                        # EOS on the prefill-sampled token: vocode that latent only
                        emit(i, self._vocode_tail(all_lats, i, 0, 1, win))
                        done[i] = True
                        continue
                    eos_j, _, full, rem = window_accounting(
                        toks_np[i], n_total, caps[i], stop, carry_n, win)
                    ends[i] = (full, rem if eos_j is not None else 0)
                    done[i] = eos_j is not None
                rows = [i for i, (full, _) in ends.items() if full]
                if rows:
                    wavs = self.batch_window_vocode(all_lats[rows], win)
                    for j, i in enumerate(rows):
                        for w in range(ends[i][0]):
                            emit(i, wavs[j, w])
                for i, (full, rem) in ends.items():
                    if rem:
                        emit(i, self._vocode_tail(all_lats, i, full * win, rem, win))
                first_call = False
                n_total += k
                carry = all_lats[:, :0]
                carry_n, k, win = 0, csz, csz

        wavs_out = [np.concatenate(o, axis=-1) if o else np.zeros((0,), np.float32)
                    for o in outs]
        total_audio = sum(s.shape[-1] for s in src_wavs) / self.content_sample_rate
        agg_rtf = (time.perf_counter() - begin) / total_audio
        if verbose:
            lat_s = [f"{v:.3f}" if v is not None else "-" for v in latencies]
            print(f"Batch latencies (s): {lat_s}")
            print(f"Aggregate real-time factor: {agg_rtf:.3f} ({bsz} streams)")
        return wavs_out, latencies, agg_rtf


def window_accounting(toks, n_total: int, max_new: int, stop: int,
                      carry_n: int, win: int):
    """EOS/cap scan + window arithmetic for one decode call's tokens
    (reference consumer semantics). Returns ``(eos_j, n_lat_valid, full,
    rem)``: ``eos_j`` the index of the last valid token (None = the segment
    goes on), ``n_lat_valid`` the valid latents incl. ``carry_n`` carried
    ones, ``full`` the complete ``win``-windows to emit, ``rem`` the
    remainder to vocode exact-width when the segment ends here."""
    k = len(toks)
    eos_j = None
    for j, t in enumerate(toks):
        if n_total + j + 1 > max_new:
            eos_j = j - 1
            break
        if t == stop:
            eos_j = j
            break
    if eos_j is None and n_total + k >= max_new:
        eos_j = k - 1
    n_lat_valid = carry_n + (k if eos_j is None else eos_j + 1)
    full = n_lat_valid // win
    return eos_j, n_lat_valid, full, n_lat_valid - full * win


def _handle_chunk(wav_gen: np.ndarray, wav_overlap, overlap_len: int):
    """Crossfade chunk assembly (reference handle_chunks)."""
    wav_chunk = wav_gen[:-overlap_len]
    if wav_overlap is not None:
        if overlap_len > len(wav_chunk):
            return wav_gen[-overlap_len:], wav_gen[-overlap_len:]
        ramp = np.linspace(0.0, 1.0, overlap_len, dtype=np.float32)
        wav_chunk = wav_chunk.copy()
        wav_chunk[:overlap_len] = wav_overlap * (1.0 - ramp) + wav_chunk[:overlap_len] * ramp
    return wav_chunk, wav_gen[-overlap_len:]


# ---------------------------------------------------------------------------
# Model init


def model_init(checkpoint_path: str, device="cuda", dtype=torch.float32,
               seed: int = 0, kv_cache_dtype: str | None = None) -> GenVCPipeline:
    """Load a reference-format ``.pth`` bundle and build the pipeline.
    ``dtype=torch.bfloat16`` runs the GPT in bf16; ``kv_cache_dtype="fp8"``
    stores the KV cache as float8_e4m3."""
    tree = convert_bundle(checkpoint_path)
    cfg = GenVCConfig.from_dict(tree["config"] or {})
    return build_pipeline(tree, cfg, device=device, dtype=dtype, seed=seed,
                          kv_cache_dtype=kv_cache_dtype)


def build_pipeline(tree: dict, cfg: GenVCConfig, device="cuda",
                   dtype=torch.float32, seed: int = 0,
                   kv_cache_dtype: str | None = None) -> GenVCPipeline:
    dev = resolve_device(device)
    mods = load_jax_tree(tree, cfg, dev, dtype)
    return GenVCPipeline(cfg, mods, _load_mel_norms(cfg, dev), dev, seed=seed,
                         kv_cache_dtype=kv_cache_dtype)


def flagship_config() -> GenVCConfig:
    """The flagship bench configuration (``bench.py`` of the JAX package):
    GPT 30 layers x 1024, 4 heads; content dVAE 256 ch / 256 tokens, codebook
    512, hidden 512, 3 resblocks, 2 layers; default HiFi-GAN; greedy."""
    cfg = GenVCConfig()
    ma = cfg.model_args
    ma.gpt_layers, ma.gpt_n_model_channels, ma.gpt_n_heads = 30, 1024, 4
    ma.gpt_number_text_tokens, ma.gpt_start_text_token, ma.gpt_stop_text_token = 258, 256, 257
    cd = cfg.content_dvae_config
    cd.num_channels, cd.num_tokens = 256, 256
    cd.codebook_dim, cd.hidden_dim, cd.num_resnet_blocks, cd.num_layers = 512, 512, 3, 2
    cfg.top_k = 1  # greedy — recommended for streaming (reference README.md:52)
    return cfg


def random_tree(cfg: GenVCConfig, seed: int, device, contentvec_layers: int = 12) -> dict:
    """Seeded random parameters for every family the streaming path loads,
    drawn on ``device`` with the JAX package's init distributions."""
    gen = torch.Generator(device=device).manual_seed(seed)
    gcfg = gpt_model.GPTConfig(
        layers=cfg.model_args.gpt_layers, model_dim=cfg.model_args.gpt_n_model_channels,
        heads=cfg.model_args.gpt_n_heads)
    cd = cfg.content_dvae_config
    return {
        "gpt": gpt_model.init_tree(gen, gcfg),
        "hifigan": hifigan.init_tree(gen, cfg.vocoder_config),
        "content_dvae": dvae.init_tree(gen, dvae.DVAEConfig(
            channels=cd.num_channels, num_tokens=cd.num_tokens,
            codebook_dim=cd.codebook_dim, hidden_dim=cd.hidden_dim,
            num_resnet_blocks=cd.num_resnet_blocks, kernel_size=cd.kernel_size,
            num_layers=cd.num_layers)),
        "contentvec": contentvec.init_tree(gen, n_layers=contentvec_layers),
        "config": cfg.to_dict(),
    }


def _load_mel_norms(cfg: GenVCConfig, device):
    """Per-bin mel norms from the config's file or the repo's
    ``pre_trained/mel_stats.npy``; ones if neither exists."""
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    candidates = [cfg.model_args.mel_norm_file, "pre_trained/mel_stats.npy",
                  os.path.join(repo_root, "pre_trained/mel_stats.npy")]
    for cand in candidates:
        if cand and os.path.exists(str(cand)):
            if str(cand).endswith(".npy"):
                arr = torch.as_tensor(np.load(cand))
            else:
                arr = torch.load(cand, map_location="cpu", weights_only=True)
            return arr.float().to(device)
    return torch.ones(80, device=device)
