"""Operations and bytes of the work a cell asks for, from the configuration's
shapes alone, and the card's peaks.

Model FLOPs count useful work: each family at the true lengths of the
request (not the program's padded widths), the GPT over the tokens it
emitted. The convolution and attention families are counted by
``FlopCounterMode`` over the benchmark's own reference on the ``meta``
device, so no change to the program can change a count. The GPT is counted
per token: 24 d^2 per block for its four products, 4 d per key attended, and
its head in float32.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import model as ref

# NVIDIA H100 SXM data sheet, dense: bf16 989 TFLOP/s, float32 without
# tensor cores 67 TFLOP/s, int8 1979 TOP/s, HBM3 3.35 TB/s (at 700 W).
PEAK = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
HBM_BYTES_S = 3.35e12
_SIZE = {"bfloat16": 2, "float32": 4, "float8": 1}


def _count(fn, *args) -> float:
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return float(fc.get_total_flops())


def _meta_tree(spec):
    if isinstance(spec, dict):
        return {k: _meta_tree(v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_meta_tree(v) for v in spec]
    return torch.empty(spec[0], device="meta")


@functools.lru_cache(maxsize=None)
def _trees(cfg_key: str):
    import json

    from perfbench import weights

    cfg = json.loads(cfg_key)
    spec = weights.inference_spec(cfg)
    if "acoustic_dvae" in cfg:
        spec["acoustic_dvae"] = weights.dvae_spec(cfg["acoustic_dvae"])
    return cfg, _meta_tree(spec)


@functools.lru_cache(maxsize=None)
def _content(cfg_key: str, t_real: int) -> float:
    cfg, tree = _trees(cfg_key)
    n = ref.n_codes(t_real, 0)
    wav = torch.empty(t_real, device="meta")
    flops = _count(ref.contentvec, tree["contentvec"], wav, t_real, cfg["contentvec"]["heads"])
    feats = torch.empty(n, cfg["contentvec"]["final_dim"], device="meta")
    return flops + _count(ref.dvae_codes, tree["content_dvae"], feats, n)


@functools.lru_cache(maxsize=None)
def _speaker(cfg_key: str, frames: int) -> float:
    cfg, tree = _trees(cfg_key)
    mel = torch.empty(cfg["style_mel"]["n_mels"], frames, device="meta")
    return _count(ref.perceiver, tree["gpt"]["perceiver"], mel, frames, cfg["perceiver"])


@functools.lru_cache(maxsize=None)
def _vocoder(cfg_key: str, n: int) -> float:
    cfg, tree = _trees(cfg_key)
    lat = torch.empty(n, cfg["gpt"]["model_dim"], device="meta")
    return _count(ref.vocode, tree["hifigan"], cfg["hifigan"], lat)


def _key(cfg: dict) -> str:
    import json

    return json.dumps(cfg, sort_keys=True)


def content_flops(cfg: dict, t_real: int) -> float:
    """ContentVec and the content dVAE's encoder over ``t_real`` samples."""
    return _content(_key(cfg), int(t_real))


def speaker_flops(cfg: dict, ref_samples: int) -> float:
    """The Perceiver over each 6 s chunk of a 24 kHz reference."""
    sr, hop = cfg["style_mel"]["sample_rate"], cfg["style_mel"]["hop_length"]
    total = 0.0
    for i in range(0, min(ref_samples, 30 * sr), 6 * sr):
        chunk = min(6 * sr, ref_samples - i)
        if chunk >= sr * 0.33:
            total += _speaker(_key(cfg), chunk // hop + 1)
    return total


def vocoder_flops(cfg: dict, n: int) -> float:
    """Interpolation and HiFi-GAN over a window of ``n`` latents."""
    return _vocoder(_key(cfg), int(n))


def gpt_token_flops(cfg: dict, keys: int) -> tuple[float, float]:
    """(GPT flops in its own type, head flops in float32) of one position
    that attends ``keys`` keys."""
    g = cfg["gpt"]
    d = g["model_dim"]
    return g["layers"] * (24 * d * d + 4 * keys * d), 2 * d * g["num_audio_tokens"]


def gpt_segment_flops(cfg: dict, prefix_keys: int, emitted: int) -> tuple[float, float]:
    """A segment's prefill over its valid prefix and start token, and the
    decode positions that gave its ``emitted`` latents (the first comes from
    the prefill)."""
    body = head = 0.0
    for p in range(prefix_keys + 1):
        b, _ = gpt_token_flops(cfg, p + 1)
        body += b
    for j in range(emitted):
        b, h = gpt_token_flops(cfg, prefix_keys + 1 + j)
        body += b if j else 0.0
        head += h
    return body, head


def _by_type(*parts: dict) -> dict:
    out: dict = {}
    for p in parts:
        for k, v in p.items():
            out[k] = out.get(k, 0.0) + v
    return out


def seconds_at_peak(cfg: dict, flops: dict) -> float:
    """Least time of ``flops`` ({type: flops}) at the card's peaks."""
    return sum(v / PEAK[k] for k, v in flops.items())


def decode_attention_bytes(cfg: dict, rows_keys, write: bool = False) -> tuple[float, float]:
    """(bytes, flops) of one call of the cached decode attention for one
    layer: each row reads its ``keys`` valid keys and values, its query and
    bias, and writes its output (and, with ``write``, its new key and
    value). Idle rows (``keys`` 0) move their query and output only."""
    g = cfg["gpt"]
    h, hd = g["heads"], g["head_dim"]
    el = _SIZE[g["kv_cache_dtype"]]
    q = _SIZE[g["dtype"]]
    byt = flo = 0.0
    for keys in rows_keys:
        byt += 2 * h * keys * hd * el + 2 * h * hd * q + 4 * keys
        if write:
            byt += 2 * h * hd * el
        flo += 4 * h * keys * hd
    return byt, flo


def decode_attention_bound_s(cfg: dict, rows_keys, write: bool = False) -> float:
    byt, flo = decode_attention_bytes(cfg, rows_keys, write)
    return max(byt / HBM_BYTES_S, flo / PEAK[cfg["gpt"]["dtype"]])


@functools.lru_cache(maxsize=None)
def _acoustic(cfg_key: str, frames: int) -> float:
    cfg, tree = _trees(cfg_key)
    mel = torch.empty(frames, cfg["acoustic_dvae"]["channels"], device="meta")
    return _count(ref.dvae_codes, tree["acoustic_dvae"], mel, frames)


def train_step_flops(cfg: dict, feats: dict, batch: dict) -> dict:
    """Model FLOPs of one GPT training step, by type: the frozen tokenizers
    forward in float32 at each row's true length; the GPT forward and
    backward (3x the forward) over each row's kept positions, causal
    attention counted once per key pair, both heads; the Perceiver forward
    (frozen under ``fix_condition_embeddings``). ``feats``: the step's
    feature shapes; ``batch``: its lengths (numpy)."""
    g, tr = cfg["gpt"], cfg["train"]
    d, layers = g["model_dim"], g["layers"]
    wt = feats["text_inputs"][1]
    wm = feats["audio_codes"][1]
    key = _key(cfg)
    f32 = body = 0.0
    hop = cfg["dvae_mel"]["hop_length"]
    for wl, tl, cl in zip(batch["wav_lengths"], batch["text_lengths"], batch["cond_lens"]):
        wl, tl, cl = int(wl), int(tl), int(cl)
        f32 += content_flops(cfg, wl * tr["content_sample_rate"] // tr["sample_rate"]
                             + int(tr["text_frame_rate"] * tr["content_sample_rate"]))
        f32 += _acoustic(key, wl // hop + 1)
        code_len = -(-wl // g["code_stride_len"]) + 3
        n = cfg["perceiver"]["latents"] + min(tl + 1, wt + 2) + min(code_len + 1, wm + 2)
        fwd = layers * (24 * d * d * n + 2 * n * n * d)
        fwd += 2 * d * (g["number_text_tokens"] * (wt + 2) + g["num_audio_tokens"] * (wm + 2))
        body += 3 * fwd + _speaker(key, cl // cfg["style_mel"]["hop_length"])
    return _by_type({g["dtype"]: body}, {"float32": f32})


def flash_bound_s(cfg: dict, feats: dict) -> float:
    """Least time of one step's flash-attention calls (K4 forward, K5 and K6
    backward, one each a layer) over the step's padded sequence: inputs
    read and outputs written once (bf16 activations, f32 row statistics),
    causal products counted once per key pair."""
    g = cfg["gpt"]
    b, wt = feats["text_inputs"]
    wm = feats["audio_codes"][1]
    t = cfg["perceiver"]["latents"] + wt + 2 + wm + 2
    h, hd = g["heads"], g["head_dim"]
    el = _SIZE[g["dtype"]]
    act = b * t * h * hd * el
    stats = b * h * t * 4
    pairs = b * h * t * (t + 1) / 2
    fwd = max((4 * act + stats + b * t) / HBM_BYTES_S, 4 * pairs * hd / PEAK[g["dtype"]])
    bwd = max((8 * act + 2 * stats + b * t) / HBM_BYTES_S, 10 * pairs * hd / PEAK[g["dtype"]])
    return g["layers"] * (fwd + bwd)
