"""Plain PyTorch reference of the GPT training step (stage 3).

From the batch's raw waveforms: the frozen tokenizers' codes (the style mel
of the conditioning, the acoustic dVAE's codes of the wav's mel, ContentVec
and the content dVAE's codes of the wav at 16 kHz), the teacher-forced
weighted cross-entropy of the GPT in float32 (in blocks of rows, the
gradients summed), and AdamW with optax's semantics (clip by the global
norm, decay on weights only). Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import model as ref

_NO_DECAY = {"text_embedding", "mel_embedding", "text_pos", "mel_pos"}


def resample(x, orig: int, new: int, width: int = 6, rolloff: float = 0.99):
    """Band-limited resampling with a Hann-windowed sinc, polyphase: (B, T)
    -> (B, ceil(T * new / orig))."""
    g = math.gcd(orig, new)
    o, n = orig // g, new // g
    base = min(o, n) * rolloff / 2.0
    half = int(math.ceil(width * o / (base * 2.0)))
    idx = np.arange(-half, half + o, dtype=np.float64)[None, :] / o
    t = (-np.arange(n, dtype=np.float64)[:, None] / n + idx) * 2.0 * base
    t = np.clip(t, -width, width)
    win = np.cos(t * np.pi / width / 2.0) ** 2
    t = t * np.pi
    kern = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t)) * win * base / o * 2.0
    k = torch.as_tensor(kern.astype(np.float32), device=x.device)[:, None, :]
    length = x.shape[-1]
    y = F.conv1d(F.pad(x[:, None], (half, half + o)), k, stride=o)
    y = y.transpose(1, 2).reshape(x.shape[0], -1)
    return y[:, : int(math.ceil(n * length / o))]


def mel(x, spec, norms):
    """(T,) samples -> (n_mels, frames) log mel over the norms, the signal
    reflect-padded by n_fft / 2 on each side."""
    pad = spec["n_fft"] // 2
    return ref.style_mel(F.pad(x[None, None], (pad, pad), mode="reflect")[0, 0], spec, norms)


def tokenize(trees: dict, cfg: dict, norms, batch: dict, codes: dict | None = None) -> dict:
    """The frozen tokenizers over a batch of raw waveforms: the codes and,
    under ``audio_z`` / ``text_z``, the dVAEs' pre-quantization values. With
    ``codes`` (the judged side's ``audio`` and ``text`` codes) a code within
    a tie of the nearest is taken as that side's (:func:`ref.judged_codes`)."""
    tr = cfg["train"]
    wav = batch["wav"][:, 0].float()
    cond = batch["conditioning"][:, 0, 0].float()
    cond_mels = torch.stack([mel(c, cfg["style_mel"], norms) for c in cond])

    def quantize(p, feats, valid, kind, row):
        z = ref.dvae_encode(p, feats, valid)
        given = None if codes is None or row >= len(codes[kind]) else codes[kind][row]
        return z, ref.judged_codes(ref.dvae_dist(p, z), z, given)

    audio, audio_z = [], []
    for i, w in enumerate(wav):
        m = mel(w, cfg["dvae_mel"], norms)
        z, c = quantize(trees["acoustic_dvae"], m.T, m.shape[1], "audio", i)
        audio_z.append(z)
        audio.append(c)
    c16 = resample(wav, tr["sample_rate"], tr["content_sample_rate"])
    c16 = F.pad(c16, (0, int(tr["text_frame_rate"] * tr["content_sample_rate"])))
    text, text_z = [], []
    for i, w in enumerate(c16):
        feats = ref.contentvec(trees["contentvec"], w, w.shape[0], cfg["contentvec"]["heads"])
        z, c = quantize(trees["content_dvae"], feats, feats.shape[0], "text", i)
        text_z.append(z)
        text.append(c)
    return {"cond_mels": cond_mels, "cond_lens": batch["cond_lens"].long(),
            "audio_codes": F.pad(torch.stack(audio), (0, 4)), "text_inputs": torch.stack(text),
            "text_lengths": batch["text_lengths"].long(), "wav_lengths": batch["wav_lengths"].long(),
            "audio_z": torch.stack(audio_z), "text_z": torch.stack(text_z)}


def _io(tokens, lengths, start, stop):
    b, w = tokens.shape
    pos = torch.arange(w, device=tokens.device)[None]
    toks = torch.where(pos < lengths[:, None], tokens, torch.full_like(tokens, stop))
    s = torch.full((b, 1), start, dtype=toks.dtype, device=toks.device)
    e = torch.full((b, 1), stop, dtype=toks.dtype, device=toks.device)
    return torch.cat([s, toks, e], 1), torch.cat([toks, e, e], 1)


def _nll(logits, targets):
    return -torch.log_softmax(logits, -1).gather(-1, targets[..., None])[..., 0]


def gpt_loss(p, cfg, feats, rows, dens, mm=ref.f32_mm):
    """The weighted loss of batch rows ``rows`` over the whole batch's
    denominators ``dens`` (kept text and mel targets): these rows' share of
    the batch's loss."""
    g, tr = cfg["gpt"], cfg["train"]
    ti, tl = feats["text_inputs"][rows], feats["text_lengths"][rows]
    ac, wl = feats["audio_codes"][rows], feats["wav_lengths"][rows]
    b, wt = ti.shape
    wm = ac.shape[1]
    dev = ti.device
    code_len = torch.ceil(wl / g["code_stride_len"]).long() + 3
    t_in, t_tar = _io(ti, tl, g["start_text_token"], g["stop_text_token"])
    m_in, m_tar = _io(ac, code_len - 3, g["start_audio_token"], g["stop_audio_token"])
    x_t = p["text_embedding"][t_in] + p["text_pos"][: wt + 2]
    x_m = p["mel_embedding"][m_in] + p["mel_pos"][: wm + 2]
    cm, cl = feats["cond_mels"][rows], feats["cond_lens"][rows]
    frames = cl // 256
    with torch.set_grad_enabled(torch.is_grad_enabled() and not tr["fix_condition_embeddings"]):
        cond = torch.stack([ref.perceiver(p["perceiver"], cm[i], int(frames[i]), cfg["perceiver"], mm)
                            for i in range(b)])
    x = torch.cat([cond, x_t, x_m], 1)
    t_keep = torch.arange(wt + 2, device=dev)[None] <= tl[:, None]
    m_keep = torch.arange(wm + 2, device=dev)[None] <= code_len[:, None]
    kv = torch.cat([torch.ones(b, cond.shape[1], dtype=torch.bool, device=dev), t_keep, m_keep], 1)
    n = x.shape[1]
    mask = torch.ones(n, n, dtype=torch.bool, device=dev).tril()[None] & kv[:, None, :]
    h = g["heads"]
    for blk in p["core"]["blocks"]:
        y = ref.layer_norm(blk["ln_1"], x)
        q, k, v = ref.linear(blk["attn"]["c_attn"], y, mm).chunk(3, -1)
        sp = lambda a: a.reshape(b, n, h, -1).transpose(1, 2)  # noqa: E731
        s = (sp(q) @ sp(k).transpose(-1, -2)) / math.sqrt(q.shape[-1] // h)
        o = torch.softmax(s.masked_fill(~mask[:, None], -1e9), -1) @ sp(v)
        x = x + ref.linear(blk["attn"]["c_proj"], o.transpose(1, 2).reshape(b, n, -1), mm)
        y = ref.layer_norm(blk["ln_2"], x)
        x = x + ref.linear(blk["mlp"]["c_proj"],
                           F.gelu(ref.linear(blk["mlp"]["c_fc"], y, mm), approximate="tanh"), mm)
    enc = ref.layer_norm(p["final_norm"], ref.layer_norm(p["core"]["ln_f"], x)[:, cond.shape[1]:])
    lt = ref.linear(p["text_head"], enc[:, : wt + 2], mm)
    lm = ref.linear(p["mel_head"], enc[:, -(wm + 2):], mm)
    loss_t = (_nll(lt, t_tar) * t_keep).sum() / dens[0]
    loss_m = (_nll(lm, m_tar) * m_keep).sum() / dens[1]
    return tr["text_ce_weight"] * loss_t + tr["mel_ce_weight"] * loss_m


def leaves(tree, path=()):
    """(dotted name, tensor) of every leaf, in tree order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (str(i),))
    else:
        yield ".".join(path), tree


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.detach().clone()


def decays(name: str) -> bool:
    parts = name.split(".")
    return parts[-1] not in ("b", "bias", "scale") and not any(q in _NO_DECAY for q in parts)


class Trainer:
    """The reference step over the GPT tree ``p`` (leaves made trainable
    float32 copies)."""

    def __init__(self, p: dict, cfg: dict, mm=ref.f32_mm, rows_per_block: int = 6):
        self.p, self.cfg, self.mm, self.block = _clone(p), cfg, mm, rows_per_block
        self.named = list(leaves(self.p))
        for _, t in self.named:
            t.requires_grad_(True)
        self.mu = {n: torch.zeros_like(t) for n, t in self.named}
        self.nu = {n: torch.zeros_like(t) for n, t in self.named}
        self.count = 0

    def loss_and_grads(self, feats: dict):
        dens = kept(feats, self.cfg)
        b = feats["text_lengths"].shape[0]
        total = 0.0
        for i in range(0, b, self.block):
            rows = torch.arange(i, min(i + self.block, b), device=feats["text_lengths"].device)
            loss = gpt_loss(self.p, self.cfg, feats, rows, dens, self.mm)
            loss.backward()
            total += float(loss.detach())
        grads = {n: (t.grad.detach().clone() if t.grad is not None else torch.zeros_like(t))
                 for n, t in self.named}
        for _, t in self.named:
            t.grad = None
        return total, grads

    @torch.no_grad()
    def update(self, grads: dict) -> dict:
        """One AdamW step; returns the clipped gradient the moments took."""
        tr = self.cfg["train"]
        b1, b2 = tr["betas"]
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        if float(norm) >= tr["max_grad_norm"]:
            grads = {n: g / norm * tr["max_grad_norm"] for n, g in grads.items()}
        self.count += 1
        bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for n, t in self.named:
            g = grads[n]
            self.mu[n].mul_(b1).add_(g, alpha=1.0 - b1)
            self.nu[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            u = (self.mu[n] / bc1) / ((self.nu[n] / bc2).sqrt() + tr["eps"])
            if decays(n):
                u = u + tr["weight_decay"] * t
            t.sub_(tr["lr"] * u)
        return grads


def kept(feats: dict, cfg: dict):
    """The batch's kept text and mel targets: the loss's denominators."""
    wt, wm = feats["text_inputs"].shape[1], feats["audio_codes"].shape[1]
    dev = feats["text_inputs"].device
    code_len = torch.ceil(feats["wav_lengths"] / cfg["gpt"]["code_stride_len"]).long() + 3
    t = (torch.arange(wt + 2, device=dev)[None] <= feats["text_lengths"][:, None]).sum()
    m = (torch.arange(wm + 2, device=dev)[None] <= code_len[:, None]).sum()
    return t.float().clamp_min(1.0), m.float().clamp_min(1.0)
