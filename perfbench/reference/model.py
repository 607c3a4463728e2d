"""Plain PyTorch reference of the GenVC inference chain, on the weight tree.

Written from the model's equations for this benchmark; it imports nothing of
the program. Everything runs in float32 on whatever device the tensors are
on, one utterance at a time, with no cache and no batching: a full causal
forward over [speaker latents | text | audio tokens] gives every position's
logits and latents at once. The caller keeps TF32 off
(:func:`full_precision`) unless it computes the lower-precision control.

``mm`` is the product of the GPT's and Perceiver's linears. The reference
passes :func:`f32_mm`; the control passes :func:`e4m3_mm`, which rounds both
operands to float8 e4m3 with a scale per row and per output column, the next
precision below bf16.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

CV_CONV = [(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2
E4M3_MAX = 448.0


@contextlib.contextmanager
def full_precision(tf32: bool = False):
    """float32 products and convolutions without TF32 (``tf32=True``: with)."""
    keep = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep


def f32_mm(x, w):
    return x @ w


def _e4m3(x, dim):
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def e4m3_mm(x, w):
    return _e4m3(x, -1) @ _e4m3(w, 0)


def linear(p, x, mm=f32_mm):
    y = mm(x, p["w"])
    return y + p["b"] if "b" in p else y


def layer_norm(p, x, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], eps)


def attention(q, k, v, mask=None):
    """(H, Tq, hd) x (H, Tk, hd); ``mask`` (Tq, Tk) bool, True = attend."""
    s = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        s = s.masked_fill(~mask, -1e9)
    return torch.softmax(s, dim=-1) @ v


def heads(x, n):
    t, d = x.shape
    return x.reshape(t, n, d // n).transpose(0, 1)


def unheads(x):
    h, t, hd = x.shape
    return x.transpose(0, 1).reshape(t, h * hd)


# ------------------------------------------------------------------ ContentVec


def contentvec(p, wav, t_real, n_heads=12):
    """(T,) 16 kHz samples, zero-padded past ``t_real`` -> (frames, 256).

    A frame is padding when it lies past the true length or all its samples
    are exactly zero; padding frames are zeroed before the positional conv
    and masked as keys."""
    x = wav[None, None, :]
    valid = t_real
    for i, (layer, (_, k, s)) in enumerate(zip(p["feature_extractor"], CV_CONV)):
        x = F.conv1d(x, layer["conv"]["w"], stride=s)
        valid = max((valid - k) // s + 1, 0)
        if i == 0:  # GroupNorm with a group per channel, over the true length
            v = x[..., :valid]
            mean = v.mean(dim=-1, keepdim=True)
            var = (v - mean).square().mean(dim=-1, keepdim=True)
            x = (x - mean) / torch.sqrt(var + 1e-5)
            x = x * layer["norm"]["scale"][None, :, None] + layer["norm"]["bias"][None, :, None]
        x = F.gelu(x)
        x[..., valid:] = 0.0
    feats = x[0].T                                    # (frames, 512)
    n_frames = feats.shape[0]
    per = wav.shape[0] // n_frames
    silent = (wav[: n_frames * per].reshape(n_frames, per) == 0.0).all(dim=-1)
    keep = ~silent & (torch.arange(n_frames, device=wav.device) < valid)
    h = linear(p["post_extract_proj"], layer_norm(p["pre_ln"], feats)) * keep[:, None]
    pc = F.conv1d(h.T[None], p["pos_conv"]["w"], p["pos_conv"]["b"], padding=64,
                  groups=16)[0, :, :-1].T
    h = layer_norm(p["encoder_ln"], h + F.gelu(pc))
    mask = keep[None, :].expand(n_frames, n_frames)
    for lp in p["layers"]:
        a = lp["attn"]
        o = attention(heads(linear(a["q"], h), n_heads), heads(linear(a["k"], h), n_heads),
                      heads(linear(a["v"], h), n_heads), mask)
        h = layer_norm(lp["attn_ln"], h + linear(a["out"], unheads(o)))
        h = layer_norm(lp["final_ln"], h + linear(lp["fc2"], F.gelu(linear(lp["fc1"], h))))
    return linear(p["final_proj"], h)


# ---------------------------------------------------------------- content dVAE


def dvae_encode(p, feats, valid):
    """(frames, C) features, ``valid`` true frames -> (frames / 4, D): the
    encoder's pre-quantization values over the true frames (zero past them)."""
    x = feats.T[None]
    enc = p["encoder"]
    for conv in enc["convs"]:
        x = x.clone()
        x[..., valid:] = 0.0
        x = torch.relu(F.conv1d(x, conv["w"], conv["b"], stride=2, padding=1))
        valid = (valid - 1) // 2 + 1
    for rb in enc["resblocks"]:
        x = x.clone()
        x[..., valid:] = 0.0
        y = torch.relu(F.conv1d(x, rb["conv1"]["w"], rb["conv1"]["b"], padding=1))
        y = torch.relu(F.conv1d(y, rb["conv2"]["w"], rb["conv2"]["b"], padding=1))
        x = F.conv1d(y, rb["conv3"]["w"], rb["conv3"]["b"]) + x
    x = x.clone()
    x[..., valid:] = 0.0
    return F.conv1d(x, enc["out"]["w"], enc["out"]["b"])[0].T


def dvae_dist(p, z):
    """(T, D) pre-quantization values -> (T, N) squared distances to the
    codebook's columns."""
    e = p["codebook"]["embed"]                                # (D, N)
    return z.square().sum(-1, keepdim=True) - 2.0 * (z @ e) + e.square().sum(0)[None]


# A code within this share of |z|^2 of the nearest one is a tie: float32
# round-off of the tokenizers (about 1e-6 of z) moves distances by a few
# 1e-6 of |z|^2, so either side of a tie may pick either code.
TIE = 1e-4


def judged_codes(dist, z, codes=None):
    """The codes a check reads: the nearest column (the first on a tie), or,
    where ``codes`` (the judged side's) names a column within ``TIE`` of the
    nearest, that column."""
    best = torch.argmax(-dist, dim=-1)
    if codes is None:
        return best
    codes = torch.as_tensor(codes, device=dist.device).long()[: dist.shape[0]]
    n = codes.shape[0]
    gap = dist[:n].gather(1, codes[:, None])[:, 0] - dist[:n].min(-1).values
    out = best.clone()
    out[:n] = torch.where(gap <= TIE * z[:n].square().sum(-1), codes, best[:n])
    return out


def dvae_codes(p, feats, valid):
    """(frames, C) features, ``valid`` true frames -> (frames / 4,) codes: the
    nearest codebook column, the first on a tie."""
    z = dvae_encode(p, feats, valid)
    return judged_codes(dvae_dist(p, z), z)


def n_codes(t_real: int, dvae_layers: int) -> int:
    valid = t_real
    for _, k, s in CV_CONV:
        valid = max((valid - k) // s + 1, 0)
    for _ in range(dvae_layers):
        valid = (valid - 1) // 2 + 1
    return valid


# ------------------------------------------------------------ style mel, Perceiver


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def mel_fbank(sr, n_fft, n_mels, fmin, fmax):
    """(n_freqs, n_mels) triangles on the HTK mel scale, area-normalised."""
    freqs = np.linspace(0, sr // 2, n_fft // 2 + 1)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    lo, mid, hi = pts[:-2], pts[1:-1], pts[2:]
    up = (freqs[:, None] - lo[None]) / (mid - lo)[None]
    down = (hi[None] - freqs[:, None]) / (hi - mid)[None]
    fb = np.maximum(0.0, np.minimum(up, down)) * (2.0 / (hi - lo))[None]
    return fb.astype(np.float32)


def style_mel(wav, spec, norms):
    """(T,) 24 kHz samples, already reflect-padded by n_fft / 2 -> (n_mels,
    frames) log mel over the mel norms."""
    win = torch.hann_window(spec["win_length"], periodic=True, device=wav.device)
    st = torch.stft(wav, n_fft=spec["n_fft"], hop_length=spec["hop_length"],
                    win_length=spec["win_length"], window=win, center=False,
                    return_complex=True)
    fb = torch.as_tensor(mel_fbank(spec["sample_rate"], spec["n_fft"], spec["n_mels"],
                                   spec["fmin"], spec["fmax"]), device=wav.device)
    mel = fb.T @ st.abs().square()
    return torch.log(mel.clamp_min(1e-5)) / norms[:, None]


def perceiver(p, mel, n_valid, cfg, mm=f32_mm):
    """(n_mels, frames) mel with ``n_valid`` true frames -> (32, D) latents."""
    ctx_in = linear(p["proj_context"], mel[:, :n_valid].T, mm)
    lat = p["latents"]
    h = cfg["heads"]
    for lp in p["layers"]:
        ctx = torch.cat([lat, ctx_in])
        k, v = linear(lp["to_kv"], ctx, mm).chunk(2, dim=-1)
        o = attention(heads(linear(lp["to_q"], lat, mm), h), heads(k, h), heads(v, h))
        lat = linear(lp["to_out"], unheads(o), mm) + lat
        val, gate = linear(lp["ff_in"], lat, mm).chunk(2, dim=-1)
        lat = linear(lp["ff_out"], F.gelu(gate) * val, mm) + lat
    return F.normalize(lat, dim=-1) * math.sqrt(lat.shape[-1]) * p["norm"]["gamma"]


def speaker_latents(p_gpt, ref24k, cfg, norms, mm=f32_mm):
    """(T,) 24 kHz reference -> (32, D): the mean over its 6 s chunks (at
    most 5; a chunk under 0.33 s is dropped) of each chunk's latents."""
    spec = cfg["style_mel"]
    sr = spec["sample_rate"]
    ref = ref24k[: 30 * sr]
    pad = spec["n_fft"] // 2
    lats = []
    for i in range(0, ref.shape[0], 6 * sr):
        chunk = ref[i: i + 6 * sr]
        if chunk.shape[0] < sr * 0.33:
            continue
        padded = F.pad(chunk[None, None], (pad, pad), mode="reflect")[0, 0]
        mel = style_mel(padded, spec, norms)
        lats.append(perceiver(p_gpt["perceiver"], mel, chunk.shape[0] // spec["hop_length"] + 1,
                              cfg["perceiver"], mm))
    return torch.stack(lats).mean(dim=0)


# ------------------------------------------------------------------------ GPT


def gpt_forward(p, g, cond, codes, audio_in, mm=f32_mm):
    """Causal forward over [cond | start_text, codes, stop_text | start_audio,
    audio_in]: (cond (32, D), codes (n,), audio_in (m,)) -> (latents (m + 1,
    D), logits (m + 1, V)); row j belongs to the position whose input is
    start_audio (j = 0) or audio_in[j - 1], and predicts the j-th token."""
    dev = cond.device
    text = torch.cat([torch.tensor([g["start_text_token"]], device=dev), codes,
                      torch.tensor([g["stop_text_token"]], device=dev)])
    audio = torch.cat([torch.tensor([g["start_audio_token"]], device=dev), audio_in])
    x = torch.cat([cond,
                   p["text_embedding"][text] + p["text_pos"][: text.shape[0]],
                   p["mel_embedding"][audio] + p["mel_pos"][: audio.shape[0]]])
    t = x.shape[0]
    causal = torch.ones(t, t, dtype=torch.bool, device=dev).tril()
    for b in p["core"]["blocks"]:
        y = layer_norm(b["ln_1"], x)
        q, k, v = linear(b["attn"]["c_attn"], y, mm).chunk(3, dim=-1)
        o = attention(heads(q, g["heads"]), heads(k, g["heads"]), heads(v, g["heads"]), causal)
        x = x + linear(b["attn"]["c_proj"], unheads(o), mm)
        y = layer_norm(b["ln_2"], x)
        x = x + linear(b["mlp"]["c_proj"], F.gelu(linear(b["mlp"]["c_fc"], y, mm),
                                                  approximate="tanh"), mm)
    x = layer_norm(p["core"]["ln_f"], x)
    lat = layer_norm(p["final_norm"], x[-audio.shape[0]:])
    return lat, linear(p["mel_head"], lat, mm)


def penalised(logits, tokens, g, penalty):
    """The repetition penalty of the decoding at each row: row j sees the
    start_audio token, id 1 and tokens[:j]. logits (m + 1, V), tokens (m,)."""
    seen = torch.zeros_like(logits, dtype=torch.bool)
    seen[:, 1] = True
    seen[:, g["start_audio_token"]] = True
    for j in range(tokens.shape[0]):
        seen[j + 1:, tokens[j]] = True
    pen = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(seen, pen, logits)


# --------------------------------------------------------------------- HiFi-GAN


def _lrelu(x, s):
    return F.leaky_relu(x, s)


def hifigan(p, h, x):
    """(C, T) latent frames -> (T * 256,) samples."""
    x = F.conv1d(x[None], p["conv_pre"]["w"], p["conv_pre"]["b"], padding=3)
    nk = len(h["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
        x = F.conv_transpose1d(_lrelu(x, 0.1), p["ups"][i]["w"], p["ups"][i]["b"],
                               stride=u, padding=(k - u) // 2)
        acc = 0.0
        for j, (kr, dil) in enumerate(zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"])):
            y = x
            for conv, d in zip(p["resblocks"][i * nk + j]["convs"], dil):
                y = F.conv1d(_lrelu(y, 0.1), conv["w"], conv["b"],
                             padding=(kr * d - d) // 2, dilation=d) + y
            acc = acc + y
        x = acc / nk
    x = F.conv1d(_lrelu(x, 0.01), p["conv_post"]["w"], p["conv_post"]["b"], padding=3)
    return torch.tanh(x)[0, 0]


def vocode(p, h, lat):
    """(n, D) latents -> (n * 1024,) samples: x4 linear interpolation
    (half-sample centres, edges clamped) then HiFi-GAN, the window alone."""
    x = F.interpolate(lat.T[None], scale_factor=h["latent_upsample"], mode="linear",
                      align_corners=False)[0]
    return hifigan(p, h, x)


def crossfade(chunks, overlap):
    """Windows joined as a stream player does: each window's last ``overlap``
    samples are held back and faded linearly into the next window's start."""
    out, held = [], None
    for w in chunks:
        body = w[:-overlap]
        if held is not None:
            if overlap > body.shape[0]:
                out.append(w[-overlap:])
                held = w[-overlap:]
                continue
            ramp = np.linspace(0.0, 1.0, overlap, dtype=np.float32)
            body = body.copy()
            body[:overlap] = held * (1.0 - ramp) + body[:overlap] * ramp
        out.append(body)
        held = w[-overlap:]
    return np.concatenate(out) if out else np.zeros((0,), np.float32)
