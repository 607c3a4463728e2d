"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 1 builds every hand-written kernel from ``genvc_tpu_torch/csrc`` (one
``nvcc`` per source, all in parallel), checks each against its plain PyTorch
version at the shapes the paths give it, and times kernel, plain version and
the library yardstick with CUDA events: K1 (cached decode attention, split
over the cache length; K2 is K1 with L = 1) at the flagship decode shape and
at B in {1, 4, 8, 16} x T in {128, 384, 1024}, K3 (the per-row cache write
and attention of the serving pool, K1's split with the write folded into its
logits pass: caches bit-equal to the plain version's, a row past the cache
end untouched, rows on both edges of a key range) at the pool's shapes and
at T = 128 and 1024, K4 (flash-attention
forward, O and LSE; bf16 on the tensor cores) at the latent pass's and the
training step's shapes and at its tile edges, K5 / K6 (flash-attention
backward: dq; dk and dv; bf16 on the tensor cores) at the training step's
shapes (T = 184 and 328) and at tile edges, with device times (a
``torch.profiler`` trace) beside SDPA's backward. It holds K1 and K3 to the
JAX package's e4m3 rule at overflow (0x7F / 0xFF stored past 464, read as
+-480) and records each build's registers, spills and shared memory
(``-Xptxas -v``). Kernel / library ratios are printed for K1, K2, K4 and
K5 + K6. The beam reorder (``engine.reorder_rows``, an ``index_select`` of
the cache by parent beam) at the flagship cache of 4 beams, bf16 and e4m3:
rows bit-equal to their parents', K1 on the reordered cache against its
plain version, and its device time against its byte bound.

Phase 2 runs a small f32 configuration on the card and on the CPU with the
same weights: streaming, offline ``synthesize``, ``synthesize_batch`` and a
2-slot ``StreamServer`` (three streams, one arriving mid-flight), and
offline beam search (3 beams), group beam search (4 beams, 2 groups) and
contrastive search (4 candidates) must give the same lengths and audio
within 1e-3; beam_sample (3 beams) with one noise sequence handed to both
the same tokens; two GPT training steps (K4 / K5 / K6 on the card) must
give the same codes, losses, gradient norms and parameters.

Phase 3 drives every ported path through its entry points at flagship width
(GPT 30 layers x 1024, 4 heads, bf16; ContentVec 12 layers; content dVAE
256 ch; default HiFi-GAN) with seeded random weights on the repo's sample
wavs: ``synthesize_streaming`` (5 runs), ``synthesize`` on a 7.68 s source
(two segments; 3 runs), ``synthesize_batch`` / ``synthesize_streaming_batch``
with 4 utterances (2 runs each), each after one warm-up, and a ``StreamServer``
of 8 slots draining 16 streams submitted at once (one warm-up drain, 2 timed);
and on the 1.54 s source offline beam search and beam_sample (4 beams), group
beam search (4 beams, 2 groups), contrastive search (4 candidates) and, at
the engine level, constrained beam search (4 beams, one two-token phrase),
each once to warm up and twice timed. It checks the audio and that the
kernels of each path were launched as often as the path says: K1 30 times
per lockstep decode step (a search's forward at B = beams or candidates),
K4 30 times per latent pass, K3 30 times per per-row decode step of the
server (and the others not at all there).

Phase 4 trains the GPT at flagship width (stage 3, bf16 on f32 masters,
attention kernels K4 forward, K5 / K6 backward) through
``train.runner.run_gpt_training`` on wavs tiled from the samples, B = 8 with
50-token texts: 1 warm-up and 5 timed steps (K4 = K5 = K6 = 30 a step, K1 =
K3 = 0), a checkpoint written and resumed for one more step; then, on one
fixed batch, steps timed with a device sync (losses must fall), the same
step with ``attn_impl="xla"`` in turns with the kernels', and one step at the
recipe's B = 24 with 100-token texts for peak memory.

Prints measurements on earlier lines, the kernel table as one JSON line, the
GPU's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero on any failure or when no
CUDA device is present.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12            # H100 SXM f32 outside the tensor cores
FLAGSHIP = dict(L=30, H=4, T=384, hd=256)
TOL = 2e-2  # K1 vs plain: same casts; bf16 probabilities and bf16 output
            # round at 2^-8 relative, f32 sums differ in order
# K4 vs plain: the plain version computes in f32 from the same inputs with
# an unrounded p; the bf16 kernel rounds p to bf16 before P.V on the tensor
# cores (2^-9 of each weight, an error under O's own bf16 rounding), the f32
# kernel does not; the sums run in another order (f32, ~1e-6 relative). A
# bf16 O is then rounded to bf16 on both sides, so one rounding may land a
# bf16 ulp apart (2^-8 relative). LSE comes from the f32 p on both sides.
FLASH_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
LSE_TOL = 1e-4
# (B, T, hd, dtype, masked key tail of the last row, masked leading keys of
# row 0, row 0 all masked, causal): the latent pass's shapes (T = 308 for a
# full 6 s segment, 180 for the 1.68 s tail of the flagship source),
# batched, in f32, the small configuration's hd = 16; the training step's
# shapes (T = 184 at 50-token texts, 328 at the recipe's 100); the tile
# edges of the bf16 kernel (16 query rows, 64 keys a tile): T below one
# tile, T not a multiple of it, hd 64 and 72 (padded to 80 in shared
# memory), rows before the first valid key, and a non-causal row with no
# valid key (both the uniform mean over the padded width)
FLASH_CASES = [(1, 308, 256, torch.bfloat16, 0, 0, False, True),
               (1, 180, 256, torch.bfloat16, 0, 0, False, True),
               (1, 308, 256, torch.bfloat16, 57, 0, False, True),
               (8, 308, 256, torch.bfloat16, 57, 0, False, True),
               (1, 308, 256, torch.float32, 0, 0, False, True),
               (1, 180, 16, torch.float32, 23, 0, False, True),
               (8, 184, 256, torch.bfloat16, 0, 0, False, True),
               (8, 328, 256, torch.bfloat16, 0, 0, False, True),
               (1, 11, 256, torch.bfloat16, 0, 0, False, True),
               (2, 77, 256, torch.bfloat16, 5, 0, False, True),
               (2, 184, 64, torch.bfloat16, 9, 0, False, True),
               (2, 184, 72, torch.bfloat16, 9, 0, False, True),
               (2, 184, 256, torch.bfloat16, 0, 37, False, True),
               (2, 136, 256, torch.bfloat16, 11, 0, True, False),
               (2, 136, 64, torch.float32, 11, 0, True, False)]
# K1 cases beyond the flagship shape (B, T): batch rows x cache lengths
DECODE_SHAPES = [(b, t) for b in (1, 4, 8, 16) for t in (128, 384, 1024)]


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=200, warmup=10) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=50, warmup=5, tries=5):
    """Device time of one call of ``fn``: the summed durations of the CUDA
    kernels its calls launch, traced with ``torch.profiler`` over ``iters``
    calls, and the kernels launched per call. ``time_ms`` over a loop of
    calls is bounded below by the host's time per call (the wrapper's Python
    and the launches), which for these small kernels exceeds the device's.

    The tracer now and then loses device records (one run kept 14 of 100).
    A trace counts only if it holds a device record for every launch the
    host made (the ``*LaunchKernel*`` runtime calls it traced) and the same
    number for each call; else it is taken again, up to ``tries`` times, and
    then the time is not measured (None, None)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        spans = [ev.time_range for ev in events
                 if ev.device_type == torch.autograd.DeviceType.CUDA]
        n_launch = sum(1 for ev in events if ev.device_type != torch.autograd.DeviceType.CUDA
                       and "LaunchKernel" in ev.name)
        if spans and len(spans) >= n_launch and len(spans) % iters == 0:
            return sum(tr.end - tr.start for tr in spans) / iters / 1e3, len(spans) // iters
        print(f"device_ms: the trace held {len(spans)} device records for {n_launch} "
              f"launches in {iters} calls: taken again", flush=True)
    print(f"device_ms: no complete trace in {tries} tries: not measured", flush=True)
    return None, None


def ratio(a, b):
    return a / b if a and b else None


def decode_inputs(b, cache_dtype, q_dtype, seed, T=FLAGSHIP["T"]):
    L, H, hd = FLAGSHIP["L"], FLAGSHIP["H"], FLAGSHIP["hd"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, H, hd, generator=g, device="cuda").to(q_dtype)
    ck = torch.randn(L, b, H, T, hd, generator=g, device="cuda").to(cache_dtype)
    cv = torch.randn(L, b, H, T, hd, generator=g, device="cuda").to(cache_dtype)
    lens = torch.randint(T // 4, T + 1, (b,), generator=g, device="cuda")
    if b > 1:
        lens[0] = 1  # a row with a single valid key
    valid = torch.arange(T, device="cuda")[None, :] < lens[:, None]
    bias = torch.where(valid, 0.0, -1e9).float()
    return q, ck, cv, bias


def check_decode_attention(da):
    """K1 vs its plain version: the flagship decode shape in every cache / q
    type, and bf16 at B in {1, 4, 8, 16} x T in {128, 384, 1024} (row 0 of a
    batch has a single valid key). Times kernel, plain version and SDPA;
    returns the timing record of the main-path configuration (bf16 cache,
    bf16 q, B=1, T=384) and of the beam searches' shape (B=4, T=384)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    L, H, T, hd = FLAGSHIP["L"], FLAGSHIP["H"], FLAGSHIP["T"], FLAGSHIP["hd"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    main = beam = None
    bf = torch.bfloat16
    cases = ([(1, T, bf, bf)] + [(b, t, bf, bf) for b, t in DECODE_SHAPES if (b, t) != (1, T)]
             + [(1, T, torch.float8_e4m3fn, bf), (16, T, torch.float8_e4m3fn, bf),
                (4, 1024, torch.float8_e4m3fn, bf), (1, T, bf, torch.float32),
                (8, 1024, bf, torch.float32), (1, T, torch.float8_e4m3fn, torch.float32),
                (16, T, torch.float8_e4m3fn, torch.float32)])
    for i, (b, t, cdt, qdt) in enumerate(cases):
        q, ck, cv, bias = decode_inputs(b, cdt, qdt, seed=i, T=t)
        worst = 0.0
        for layer in (0, 13, L - 1):
            got = da.decode_attention_layer(q, ck, cv, bias, layer).float()
            torch.cuda.synchronize()
            want = da.decode_attention_layer_plain(q, ck, cv, bias, layer).float()
            err = (got - want).abs()
            worst = max(worst, float(err.max()))
            if not bool((err <= TOL + TOL * want.abs()).all()):
                raise AssertionError(f"decode_attention B={b} T={t} cache={cdt} q={qdt} "
                                     f"layer={layer}: max |err| {float(err.max())}")
        # time over every layer in turn (the decode step's access pattern)
        lidx = iter(range(10 ** 9))
        ms = time_ms(lambda: da.decode_attention_layer(q, ck, cv, bias, next(lidx) % L))
        plain_ms = time_ms(lambda: da.decode_attention_layer_plain(q, ck, cv, bias,
                                                                   next(lidx) % L), iters=50)
        lib_ms = None
        if cdt == bf and qdt == bf:
            q4, m4 = q[:, :, None, :], bias[:, None, None, :].to(bf)
            def lib_call():
                layer = next(lidx) % L
                return sdpa(q4, ck[layer], cv[layer], attn_mask=m4)
            lib_ms = time_ms(lib_call)
            lib_dev, _ = device_ms(lib_call)
        dev, per_call = device_ms(lambda: da.decode_attention_layer(q, ck, cv, bias,
                                                                    next(lidx) % L))
        n_bytes = (2 * b * H * t * hd * ck.element_size() + q.numel() * q.element_size()
                   + bias.numel() * 4 + q.numel() * q.element_size())
        flops = 4 * b * H * t * hd
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        rec = {"B": b, "T": t, "cache": str(cdt).replace("torch.", ""),
               "q": str(qdt).replace("torch.", ""), "keys_per_split": da.split_len(b * H, t, da.SPLIT_BLOCKS_PER_SM * n_sm),
               "cuda_launches_per_call": per_call, "max_abs_err": worst, "tol": TOL,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "ratio": ms / lib_ms if lib_ms else None, "device_ms": dev,
               "library_device_ms": lib_dev if lib_ms else None,
               "device_ratio": ratio(dev, lib_dev) if lib_ms else None,
               "bound_ms": bound_ms, "bytes": n_bytes}
        print("decode_attention_layer " + json.dumps(rec), flush=True)
        if i == 0:
            main = rec
        if (b, t, cdt, qdt) == (4, T, bf, bf):
            beam = rec
        del q, ck, cv, bias
    # K2 (single-layer cache) is the same kernel with L = 1
    b = 2
    q, ck, cv, bias = decode_inputs(b, bf, bf, seed=99)
    k2, v2 = ck[3], cv[3]  # contiguous (B, H, T, hd) layer views
    got = da.decode_attention(q, k2, v2, bias).float()
    want = da.decode_attention_plain(q, k2, v2, bias).float()
    err = float((got - want).abs().max())
    if err > TOL + TOL * float(want.abs().max()):
        raise AssertionError(f"decode_attention L=1: max |err| {err}")
    m4 = bias[:, None, None, :].to(bf)
    n_bytes = 2 * b * H * T * hd * 2 + 2 * q.numel() * 2 + bias.numel() * 4
    rec = {"B": b, "cache": "bfloat16", "q": "bfloat16", "keys_per_split": da.split_len(b * H, T, da.SPLIT_BLOCKS_PER_SM * n_sm),
           "max_abs_err": err, "tol": TOL,
           "ms": time_ms(lambda: da.decode_attention(q, k2, v2, bias)),
           "plain_ms": time_ms(lambda: da.decode_attention_plain(q, k2, v2, bias), iters=50),
           "library_ms": time_ms(lambda: sdpa(q[:, :, None, :], k2, v2, attn_mask=m4)),
           "bound_ms": max(n_bytes / HBM_BYTES_PER_S, 4 * b * H * T * hd / BF16_FLOPS) * 1e3,
           "bound_by": "bytes", "bytes": n_bytes}
    rec["ratio"] = rec["ms"] / rec["library_ms"]
    rec["device_ms"], rec["cuda_launches_per_call"] = device_ms(
        lambda: da.decode_attention(q, k2, v2, bias))
    rec["library_device_ms"], _ = device_ms(lambda: sdpa(q[:, :, None, :], k2, v2, attn_mask=m4))
    rec["device_ratio"] = ratio(rec["device_ms"], rec["library_device_ms"])
    print("decode_attention (L=1) " + json.dumps(rec), flush=True)
    return main, beam


def check_beam_reorder(da, engine, gpu):
    """The beam reorder at the flagship cache of 4 beams (30 x 4 x 4 x 384 x
    256, bf16 and e4m3): each row equals its parent's bit for bit under a
    parent vector with a cycle and a repeat, and K1 on the reordered cache
    (a buffer ``index_select`` wrote) agrees with its plain version. Device
    time of one reorder (K and V, key_valid, seen) against its byte bound
    (read and write both caches once). Returns the bf16 record."""
    L, H, T, hd = FLAGSHIP["L"], FLAGSHIP["H"], FLAGSHIP["T"], FLAGSHIP["hd"]
    nb = 4
    parent = torch.tensor([1, 2, 0, 1], device="cuda")
    recs = {}
    for cdt in (torch.bfloat16, torch.float8_e4m3fn):
        q, ck, cv, bias = decode_inputs(nb, cdt, torch.bfloat16, seed=7)
        state = engine.DecodeState(
            cache_k=ck, cache_v=cv, key_valid=bias == 0, cur_index=T - 1, n_generated=1,
            last_token=torch.zeros(nb, dtype=torch.long, device="cuda"),
            seen=torch.zeros(nb, 1026, dtype=torch.bool, device="cuda"),
            finished=torch.zeros(nb, dtype=torch.bool, device="cuda"), generator=None)
        bits = (lambda x: x.view(torch.uint8) if x.element_size() == 1 else x.view(torch.int16))
        want_k, want_v = bits(ck)[:, parent].clone(), bits(cv)[:, parent].clone()
        spare = (torch.empty_like(ck), torch.empty_like(cv))
        spare = engine.reorder_rows(state, parent, spare)
        if not (torch.equal(bits(state.cache_k), want_k) and torch.equal(bits(state.cache_v),
                                                                          want_v)):
            raise AssertionError(f"beam reorder {cdt}: rows differ from their parents'")
        bias = bias[parent]
        worst = 0.0
        for layer in (0, L - 1):
            got = da.decode_attention_layer(q, state.cache_k, state.cache_v, bias, layer).float()
            want = da.decode_attention_layer_plain(q, state.cache_k, state.cache_v, bias,
                                                   layer).float()
            err = (got - want).abs()
            worst = max(worst, float(err.max()))
            if not bool((err <= TOL + TOL * want.abs()).all()):
                raise AssertionError(f"K1 on a reordered {cdt} cache: max |err| {worst}")

        def reorder():
            nonlocal spare
            spare = engine.reorder_rows(state, parent, spare)

        dev, per_call = device_ms(reorder, iters=20)
        n_bytes = 2 * 2 * ck.numel() * ck.element_size()
        rec = {"B": nb, "T": T, "cache": str(cdt).replace("torch.", ""),
               "bytes": n_bytes, "device_ms": dev, "launches_per_call": per_call,
               "ms": time_ms(reorder, iters=20, warmup=2),
               "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
               "k1_on_reordered_max_abs_err": worst, "tol": TOL, "gpu": gpu}
        print("beam_reorder " + json.dumps(rec), flush=True)
        recs[rec["cache"]] = rec
        del q, ck, cv, state, spare
    return recs["bfloat16"]


def flash_inputs(b, t, hd, dtype, tail, seed, h=4):
    """q, k, v as the latent pass gives them: strided (B, H, T, hd) views of
    one fused (B, T, 3 * H * hd) projection; the last row's last ``tail``
    keys masked."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, t, 3 * h * hd, generator=g, device="cuda").to(dtype)
    q, k, v = (x.reshape(b, t, h, hd).transpose(1, 2) for x in qkv.chunk(3, dim=-1))
    valid = torch.ones(b, t, dtype=torch.bool, device="cuda")
    if tail:
        valid[-1, t - tail:] = False
    return q, k, v, valid


def check_flash_attention(fa):
    """K4 vs its plain version on O and LSE at the latent pass's and the
    training step's shapes and at the bf16 kernel's tile edges; times
    kernel, plain version, SDPA with the same boolean mask and, where nothing
    is masked, SDPA with ``is_causal=True`` (the fused flash backend).
    Returns the timing records of the main-path shape (B=1, T=308, bf16) and
    of the training step's (B=8, T=184, bf16)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    recs = {}
    for i, (b, t, hd, dt, tail, lead, unseen, causal) in enumerate(FLASH_CASES):
        h = 4
        q, k, v, valid = flash_inputs(b, t, hd, dt, tail, seed=100 + i)
        if lead:
            valid[0, :lead] = False
        if unseen:
            valid[0] = False
        got_o, got_lse = fa.flash_attention_fwd(q, k, v, valid, None, causal)
        torch.cuda.synchronize()
        want_o, want_lse = fa.flash_attention_plain(q, k, v, valid, None, causal)
        err_o = (got_o.float() - want_o.float()).abs()
        err_lse = float((got_lse - want_lse).abs().max())
        tol = FLASH_TOL[dt]
        if not bool((err_o <= tol + tol * want_o.float().abs()).all()) or err_lse > LSE_TOL:
            raise AssertionError(f"flash_attention B={b} T={t} hd={hd} {dt} tail={tail} "
                                 f"lead={lead} unseen={unseen} causal={causal}: "
                                 f"max |err| O {float(err_o.max())}, LSE {err_lse}")
        mask = valid[:, None, None, :]
        if causal:
            mask = mask & torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
        elt = q.element_size()
        n_bytes = 4 * b * h * t * hd * elt + b * h * t * 4 + b * t
        # q.k and p.v over the pairs the causal mask keeps
        flops = 2 * b * h * t * ((t + 1) if causal else 2 * t) * hd
        peak = BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS
        ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, valid, None, causal))
        lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask))
        dev, _ = device_ms(lambda: fa.flash_attention_fwd(q, k, v, valid, None, causal))
        lib_dev, _ = device_ms(lambda: sdpa(q, k, v, attn_mask=mask))
        lib_causal_ms = lib_causal_dev = None
        if causal and not (tail or lead or unseen):
            lib_causal_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True))
            lib_causal_dev, _ = device_ms(lambda: sdpa(q, k, v, is_causal=True))
        rec = {"B": b, "T": t, "hd": hd, "dtype": str(dt).replace("torch.", ""),
               "masked_tail": tail, "masked_lead": lead, "row_without_keys": unseen,
               "causal": causal, "max_abs_err": float(err_o.max()),
               "max_abs_err_lse": err_lse, "tol": tol, "tol_lse": LSE_TOL, "ms": ms,
               "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, valid, None,
                                                                    causal), iters=50),
               "library_ms": lib_ms, "ratio": ms / lib_ms,
               "library_causal_ms": lib_causal_ms,
               "ratio_causal": ms / lib_causal_ms if lib_causal_ms else None,
               "device_ms": dev, "library_device_ms": lib_dev, "device_ratio": ratio(dev, lib_dev),
               "library_causal_device_ms": lib_causal_dev,
               "device_ratio_causal": ratio(dev, lib_causal_dev),
               "bound_ms": max(n_bytes / HBM_BYTES_PER_S, flops / peak) * 1e3,
               "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= flops / peak
               else "operations", "bytes": n_bytes, "flops": flops}
        print("flash_attention " + json.dumps(rec), flush=True)
        recs[b, t, hd, dt, tail, lead, unseen, causal] = rec
    return (recs[1, 308, 256, torch.bfloat16, 0, 0, False, True],
            recs[8, 184, 256, torch.bfloat16, 0, 0, False, True])


# K5 / K6 vs the plain backward computed in f32 from the same inputs: the
# kernels sum in f32 in a fixed order; a bf16 dq / dk / dv is then rounded to
# bf16 (2^-8 relative) while the f32 reference is not, and the bf16 kernels
# round p and ds to bf16 before the second products (ds in two bf16 parts
# where a row sees no valid key).
BWD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# (B, T, hd, dtype, masked key tail of the last row, masked leading keys of
# row 0, row 0 all masked, causal): the training step's shape (32 cond + 52
# text + 100 audio positions at 50-token texts), the recipe's 100-token
# maximum, a masked tail, f32 with rows before the first valid key, the small
# configuration's hd = 16, and non-causal with a row that sees no valid key;
# then the bf16 kernels' edges: rows before the first valid key (ds in two
# parts), and hd = 72 (padded to 80 in shared memory) with a row that sees
# no valid key
BWD_CASES = [(8, 184, 256, torch.bfloat16, 0, 0, False, True),
             (8, 328, 256, torch.bfloat16, 0, 0, False, True),
             (8, 184, 256, torch.bfloat16, 37, 0, False, True),
             (2, 184, 256, torch.float32, 37, 5, False, True),
             (2, 184, 16, torch.float32, 23, 0, False, True),
             (2, 136, 64, torch.float32, 11, 0, True, False),
             (2, 328, 256, torch.bfloat16, 45, 37, False, True),
             (2, 136, 72, torch.bfloat16, 11, 0, True, False)]
# the rows timed on the device as well (T = 184 and 328 at the step's B = 8)
BWD_DEVICE_ROWS = (0, 1)


def check_flash_backward(fa):
    """K5 and K6 vs the plain backward (f32, same inputs) at the training
    step's shapes: q, k, v strided views of the fused projection, dO the
    (B, H, T, hd) view of a (B, T, H, hd) gradient, as the step gives them.
    Times K5, K6, their wrapper (with D = rowsum(dO * O)), the plain version
    and SDPA's backward (additive mask, autograd over a retained forward
    graph); at BWD_DEVICE_ROWS also their device times. Returns the records of the
    training shapes (B=8, bf16, T=184 and T=328)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    recs = []
    for i, (b, t, hd, dt, tail, lead, unseen, causal) in enumerate(BWD_CASES):
        h = 4
        q, k, v, valid = flash_inputs(b, t, hd, dt, tail, seed=300 + i)
        if lead:
            valid[0, :lead] = False
        if unseen:
            valid[0] = False
        g = torch.Generator(device="cuda").manual_seed(400 + i)
        do = torch.randn(b, t, h, hd, generator=g, device="cuda").to(dt).transpose(1, 2)
        out, lse = fa.flash_attention_fwd(q, k, v, valid, None, causal)
        got = fa.flash_attention_bwd(q, k, v, valid, out, lse, do, None, causal)
        torch.cuda.synchronize()
        f = [x.float() for x in (q, k, v, out, do)]
        want = fa.flash_attention_bwd_plain(f[0], f[1], f[2], valid, f[3], lse, f[4],
                                            None, causal)
        tol = BWD_TOL[dt]
        errs = {}
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            err = (a.float() - w).abs()
            errs[name] = float(err.max())
            if not bool((err <= tol + tol * w.abs()).all()):
                raise AssertionError(f"flash_attention backward B={b} T={t} hd={hd} {dt} "
                                     f"tail={tail} lead={lead} unseen={unseen} "
                                     f"causal={causal}: {name} max |err| {errs[name]}")
        lse_c, dd, g_, valid_c, qkv_st, g_st = fa._bwd_args(q, k, v, valid, out, lse, do)
        args = (q, k, v, valid_c, lse_c, dd, g_, 1.0 / hd ** 0.5, causal, qkv_st, g_st)
        dq_ms = time_ms(lambda: fa.flash_attention_dq(*args))
        dkdv_ms = time_ms(lambda: fa.flash_attention_dkdv(*args))
        ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, valid, out, lse, do, None, causal))
        plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, valid, out, lse, do,
                                                                None, causal), iters=20)
        ok = valid[:, None, None, :]
        if causal:
            ok = ok & torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
        bias = torch.where(ok, 0.0, -1e9).to(dt)
        # SDPA's backward alone: autograd over one retained forward graph
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        lib_out = sdpa(*leaves, attn_mask=bias)

        def lib_bwd():
            return torch.autograd.grad(lib_out, leaves, do, retain_graph=True)
        lib_ms = time_ms(lib_bwd, iters=50)
        dev = {}
        if i in BWD_DEVICE_ROWS:
            dev["dq"], _ = device_ms(lambda: fa.flash_attention_dq(*args))
            dev["dkdv"], _ = device_ms(lambda: fa.flash_attention_dkdv(*args))
            dev["library"], _ = device_ms(lib_bwd)
        elt, n, bht = q.element_size(), b * h * t * hd, b * h * t
        frac = 0.5 if causal else 1.0
        peak = BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS
        # inputs q, k, v, dO, LSE, D and the key mask read once; outputs once
        stats = 2 * bht * 4 + b * t
        bounds = {name: (n_bytes, flops, max(n_bytes / HBM_BYTES_PER_S, flops / peak) * 1e3)
                  for name, n_bytes, flops in (
                      ("dq", 5 * n * elt + stats, 3 * 2 * b * h * t * t * hd * frac),
                      ("dkdv", 6 * n * elt + stats, 4 * 2 * b * h * t * t * hd * frac),
                      ("both", 7 * n * elt + stats, 5 * 2 * b * h * t * t * hd * frac))}
        rec = {"B": b, "T": t, "hd": hd, "dtype": str(dt).replace("torch.", ""),
               "masked_tail": tail, "masked_lead": lead, "row_without_keys": unseen,
               "causal": causal, "max_abs_err": errs, "tol": tol,
               "dq_ms": dq_ms, "dkdv_ms": dkdv_ms, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms,
               "dq_device_ms": dev.get("dq"), "dkdv_device_ms": dev.get("dkdv"),
               "library_device_ms": dev.get("library"),
               "device_ratio": ratio(dev["dq"] + dev["dkdv"], dev["library"])
               if dev.get("dq") and dev.get("dkdv") else None,
               "bound_ms": {k_: v_[2] for k_, v_ in bounds.items()},
               "bound_by": {k_: "bytes" if v_[0] / HBM_BYTES_PER_S >= v_[1] / peak
                            else "operations" for k_, v_ in bounds.items()},
               "bytes": {k_: v_[0] for k_, v_ in bounds.items()},
               "flops": {k_: v_[1] for k_, v_ in bounds.items()}}
        print("flash_attention_backward " + json.dumps(rec), flush=True)
        if i in BWD_DEVICE_ROWS:
            recs.append(rec)
    return recs


def update_inputs(b, cache_dtype, q_dtype, seed, T=FLAGSHIP["T"], pos_dtype=torch.int64):
    """K3's inputs as the pool gives them: q / k_new / v_new strided views of
    one fused projection, positions spread over the cache with rows at 0,
    T - 1, one past the end (an idle slot) and on both edges of one of the
    split's key ranges (its last key, the next range's first), the bias
    marking each row's position valid."""
    from genvc_tpu_torch.ops import decode_attention as da

    L, H, hd = FLAGSHIP["L"], FLAGSHIP["H"], FLAGSHIP["hd"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, 1, 3 * H * hd, generator=g, device="cuda").to(q_dtype)
    q, kn, vn = (x.reshape(b, H, hd) for x in qkv.chunk(3, dim=-1))
    ck = torch.randn(L, b, H, T, hd, generator=g, device="cuda").to(cache_dtype)
    cv = torch.randn(L, b, H, T, hd, generator=g, device="cuda").to(cache_dtype)
    pos = torch.randint(1, T - 1, (b,), generator=g, device="cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    per = da.split_len(b * H, T, da.SPLIT_BLOCKS_PER_SM * n_sm)
    edge = per * max(1, -(-T // per) // 2)
    pos[0], pos[1], pos[2], pos[3], pos[4] = 0, T - 1, T + 7, edge - 1, min(edge, T - 1)
    valid = torch.arange(T, device="cuda")[None, :] <= pos[:, None]
    bias = torch.where(valid, 0.0, -1e9).float()
    return q, kn, vn, ck, cv, bias, pos.to(pos_dtype)


def _bits(x):
    return x.view(torch.uint8)


def check_decode_attention_update(da):
    """K3 vs its plain version at the pool's shapes (B = 8 and 16 slots,
    bf16 / e4m3 caches, bf16 q, and f32 q with either cache, one of them
    with int32 positions; the pool's T = 384, and B = 8 bf16 at T = 128 and
    1024): ``out`` within TOL on layers 0, 13, 29; after each call both
    caches, every layer, bit-equal to the plain version's, and the row past
    the cache end untouched. Also ``out`` against the cache write followed by
    K1 (the same split and arithmetic: equal). Returns the timing records of
    the 8- and 16-slot configurations at T = 384 (bf16 and e4m3 caches, bf16
    q), keyed (B, cache)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    L, H, T, hd = FLAGSHIP["L"], FLAGSHIP["H"], FLAGSHIP["T"], FLAGSHIP["hd"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    main = {}
    bf, f8, i64 = torch.bfloat16, torch.float8_e4m3fn, torch.int64
    cases = [(8, bf, bf, T, i64), (16, bf, bf, T, i64), (8, f8, bf, T, i64),
             (16, f8, bf, T, i64), (8, bf, torch.float32, T, i64),
             (8, f8, torch.float32, T, torch.int32), (8, bf, bf, 128, i64),
             (8, bf, bf, 1024, i64)]
    for i, (b, cdt, qdt, t, pdt) in enumerate(cases):
        q, kn, vn, ck, cv, bias, pos = update_inputs(b, cdt, qdt, seed=200 + i, T=t,
                                                     pos_dtype=pdt)
        ck0 = ck.clone()
        worst = worst_k1 = 0.0
        for layer in (0, 13, L - 1):
            pk, pv = ck.clone(), cv.clone()
            got = da.decode_attention_update_layer(q, kn, vn, ck, cv, bias, pos, layer).float()
            torch.cuda.synchronize()
            want = da.decode_attention_update_layer_plain(q, kn, vn, pk, pv, bias, pos,
                                                          layer).float()
            if not (torch.equal(_bits(ck), _bits(pk)) and torch.equal(_bits(cv), _bits(pv))):
                raise AssertionError(f"decode_attention_update B={b} T={t} cache={cdt} "
                                     f"q={qdt} layer={layer}: caches differ from the plain "
                                     "version's")
            if not torch.equal(_bits(ck[:, 2]), _bits(ck0[:, 2])):
                raise AssertionError("decode_attention_update: the row past the cache "
                                     "end was written")
            err = (got - want).abs()
            worst = max(worst, float(err.max()))
            if not bool((err <= TOL + TOL * want.abs()).all()):
                raise AssertionError(f"decode_attention_update B={b} T={t} cache={cdt} "
                                     f"q={qdt} layer={layer}: max |err| {float(err.max())}")
            k1 = da.decode_attention_layer(q.contiguous(), ck, cv, bias, layer).float()
            worst_k1 = max(worst_k1, float((got - k1).abs().max()))
        lidx = iter(range(10 ** 9))
        ms = time_ms(lambda: da.decode_attention_update_layer(q, kn, vn, ck, cv, bias, pos,
                                                              next(lidx) % L))
        plain_ms = time_ms(lambda: da.decode_attention_update_layer_plain(
            q, kn, vn, ck, cv, bias, pos, next(lidx) % L), iters=50)
        lib_ms = None
        if cdt == bf and qdt == bf:
            rows = torch.arange(b, device="cuda")
            inpos = pos.clamp(max=t - 1)  # index_put_ asserts past the end
            q4, m4 = q[:, :, None, :], bias[:, None, None, :].to(bf)

            def lib_call():
                layer = next(lidx) % L
                ck[layer, rows, :, inpos] = kn
                cv[layer, rows, :, inpos] = vn
                return sdpa(q4, ck[layer], cv[layer], attn_mask=m4)
            lib_ms = time_ms(lib_call)
            lib_dev, _ = device_ms(lib_call)
        dev, per_call = device_ms(lambda: da.decode_attention_update_layer(
            q, kn, vn, ck, cv, bias, pos, next(lidx) % L))
        if per_call is not None and per_call != 2:
            raise AssertionError(f"decode_attention_update: {per_call} CUDA launches a "
                                 "call, not the split's 2")
        qe = q.element_size()
        n_bytes = (2 * b * H * t * hd * ck.element_size() + 2 * b * H * hd * ck.element_size()
                   + 4 * b * H * hd * qe + bias.numel() * 4 + pos.numel() * pos.element_size())
        flops = 4 * b * H * t * hd
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        rec = {"B": b, "T": t, "cache": str(cdt).replace("torch.", ""),
               "q": str(qdt).replace("torch.", ""), "pos": str(pdt).replace("torch.", ""),
               "keys_per_split": da.split_len(b * H, t, da.SPLIT_BLOCKS_PER_SM * n_sm),
               "edge_positions": pos[3:5].tolist(), "cuda_launches_per_call": per_call,
               "max_abs_err": worst, "tol": TOL,
               "max_abs_err_vs_write_then_k1": worst_k1,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "device_ms": dev,
               "library_device_ms": lib_dev if lib_ms else None,
               "device_ratio": ratio(dev, lib_dev) if lib_ms else None,
               "library_call": "index_put_ of k and v + scaled_dot_product_attention",
               "bound_ms": bound_ms, "device_times_bound": ratio(dev, bound_ms),
               "bound_by": "bytes", "bytes": n_bytes}
        print("decode_attention_update_layer " + json.dumps(rec), flush=True)
        if t == T and qdt == bf:
            main[b, rec["cache"]] = rec
        del q, kn, vn, ck, cv, ck0, bias, pos
    return main


# C.1: e4m3 at overflow, as the JAX package writes (astype) and reads
# (_f8e4m3_bits_to_bf16) it: values, the bits stored, the values read back
OVERFLOW = [1e4, 460.0, 500.0, -1e4, 464.0, 447.0]
OVERFLOW_BITS = [0x7F, 0x7E, 0x7F, 0xFF, 0x7E, 0x7E]
OVERFLOW_READ = [480.0, 448.0, 480.0, -480.0, 448.0, 448.0]


def check_fp8_overflow(da):
    """K/V rows holding OVERFLOW (K) and its negation (V) through K3 into an
    e4m3 cache at the pool's shape (8 slots), then K1 over that cache: K3's
    caches equal the plain version's to the bit and hold OVERFLOW_BITS; the
    lockstep write (``to_cache`` on the card) stores the same bits; K1's and
    K3's outputs are finite and within TOL of the plain versions, which read
    0x7F / 0xFF as +-480 (the row whose only valid key is the new one
    returns exactly -OVERFLOW_READ)."""
    L = FLAGSHIP["L"]
    q, kn, vn, ck, cv, bias, pos = update_inputs(8, torch.float8_e4m3fn, torch.bfloat16,
                                                 seed=250)
    over = torch.tensor(OVERFLOW, device="cuda")
    kn[:, :, :6], vn[:, :, :6] = over, -over
    want_bits = torch.tensor(OVERFLOW_BITS, dtype=torch.uint8, device="cuda")
    if not torch.equal(_bits(da.to_cache(kn, ck.dtype))[:, :, :6],
                       want_bits.expand(8, FLAGSHIP["H"], 6)):
        raise AssertionError("fp8 overflow: the lockstep write's bits differ from jnp.astype's")
    worst = 0.0
    for layer in (0, L - 1):
        pk, pv = ck.clone(), cv.clone()
        got3 = da.decode_attention_update_layer(q, kn, vn, ck, cv, bias, pos, layer).float()
        want3 = da.decode_attention_update_layer_plain(q, kn, vn, pk, pv, bias, pos,
                                                       layer).float()
        torch.cuda.synchronize()
        if not (torch.equal(_bits(ck), _bits(pk)) and torch.equal(_bits(cv), _bits(pv))):
            raise AssertionError(f"fp8 overflow, layer {layer}: K3's caches differ from the "
                                 "plain version's")
        if not torch.equal(_bits(ck[layer, 0, :, 0, :6]), want_bits.expand(FLAGSHIP["H"], 6)):
            raise AssertionError(f"fp8 overflow, layer {layer}: K3 stored "
                                 f"{_bits(ck[layer, 0, 0, 0, :6]).tolist()}")
        got1 = da.decode_attention_layer(q.contiguous(), ck, cv, bias, layer).float()
        want1 = da.decode_attention_layer_plain(q, ck, cv, bias, layer).float()
        torch.cuda.synchronize()
        for name, got, want in (("K3", got3, want3), ("K1", got1, want1)):
            err = (got - want).abs()
            worst = max(worst, float(err.max()))
            if not (bool(torch.isfinite(got).all())
                    and bool((err <= TOL + TOL * want.abs()).all())):
                raise AssertionError(f"fp8 overflow, layer {layer}: {name} max |err| "
                                     f"{float(err.max())}, finite {bool(torch.isfinite(got).all())}")
        if want3[0, :, :6].tolist() != [[-x for x in OVERFLOW_READ]] * FLAGSHIP["H"]:
            raise AssertionError(f"fp8 overflow: 0x7F / 0xFF read as {want3[0, 0, :6].tolist()}")
    print("fp8 overflow " + json.dumps({
        "values": OVERFLOW, "bits": OVERFLOW_BITS, "read_as": OVERFLOW_READ,
        "k3_caches_bit_equal_plain": True, "max_abs_err_k1_k3": worst, "tol": TOL}), flush=True)


def ptxas_summary(log):
    """Registers, spill bytes and static shared memory of each kernel
    function in one ``nvcc -Xptxas -v`` log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out[name].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[name]["registers"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                out[name]["static_smem"] = int(m[1])
    return out


def small_config(pipeline):
    cfg = pipeline.flagship_config()
    ma = cfg.model_args
    ma.gpt_layers, ma.gpt_n_model_channels, ma.gpt_n_heads = 2, 64, 4
    cd = cfg.content_dvae_config
    cd.codebook_dim, cd.hidden_dim = 24, 16
    cfg.vocoder_config.input_feat_dim = 64
    cfg.vocoder_config.upsample_initial_channel = 32
    return cfg


def serve(server_cls, pipe, srcs, refs, **kw):
    """All streams through a server; the ones after the first two are
    submitted after the first step (mid-flight). Returns the waveforms."""
    server = server_cls(pipe, **kw)
    sids = [server.submit(s, r) for s, r in zip(srcs[:2], refs[:2])]
    server.step()
    sids += [server.submit(s, r) for s, r in zip(srcs[2:], refs[2:])]
    server.drain()
    return [server.result(sid)[0] for sid in sids]


def beam_sample_tokens(pipe, engine, seg, ref, noise, nb=3):
    """beam_sample over one segment at the engine level, its Gumbel noise
    from ``noise`` (the same draws on every device): the token list."""
    import numpy as np

    pipe._cond_latent = pipe.get_gpt_cond_latents(ref)
    padded = np.pad(seg, ((0, 0), (0, pipe._seg_len_16k - seg.shape[-1])))
    codes, n_codes = pipe.extract_content_codes(padded, seg.shape[-1])
    prefix, valid, state = pipe._tiled_segment(codes, n_codes, nb)
    with torch.inference_mode():
        buf, n = engine.decode_beam(pipe.gpt, state, prefix, valid, pipe._max_new(n_codes),
                                    nb, repetition_penalty=2.0, do_sample=True,
                                    temperature=1.3, top_k=8, top_p=0.9, noise=noise)
    return buf[:n].tolist()


def check_small_against_cpu(pipeline, engine, server_cls, fa, src, ref, ref16):
    """A small f32 configuration (hd = 16) on the card vs the same weights on
    the CPU: greedy streaming, offline, batch (two rows of different lengths),
    a 2-slot server (first window 4, three streams, the third arriving after
    the first step), and offline beam (3 beams), group beam (4 beams, 2
    groups) and contrastive search (4 candidates) give the same lengths and
    audio within 1e-3; beam_sample (3 beams) with one noise sequence, drawn
    on the CPU from a seeded generator and handed to both, the same
    tokens."""
    cfg = small_config(pipeline)
    tree = pipeline.random_tree(cfg, seed=1, device="cpu", contentvec_layers=2)
    seg = src[:, :24000]
    runs = {
        "streaming": lambda p: [p.synthesize_streaming(src[:, :16000], ref, verbose=False)[0]],
        "offline": lambda p: [p.synthesize(seg, ref)],
        "beam": lambda p: [p.synthesize(seg, ref, num_beams=3)],
        "group_beam": lambda p: [p.synthesize(seg, ref, num_beams=4, num_beam_groups=2)],
        "contrastive": lambda p: [p.synthesize(seg, ref, penalty_alpha=0.6,
                                               contrastive_top_k=4)],
        "batch": lambda p: p.synthesize_batch([src[:, :24000], ref16[:, :40000]],
                                              [ref, ref[:, :48000]]),
        "server": lambda p: serve(server_cls, p, [src[:, :16000], ref16[:, :40000],
                                                  src[:, 8000:20000]],
                                  [ref, ref[:, :48000], ref], slots=2, first_window=4),
    }
    gen = torch.Generator().manual_seed(3)
    draws = {}

    def noise(s):  # (3 beams x V,) Gumbel noise of step s, drawn once
        if s not in draws:
            n = 3 * pipeline.gpt_model.GPTConfig.num_audio_tokens
            draws[s] = -torch.log(torch.empty(n).exponential_(generator=gen))
        return draws[s]

    outs, tokens = {}, {}
    for dev in ("cpu", "cuda"):
        pipe = pipeline.build_pipeline(tree, cfg, device=dev, dtype=torch.float32)
        pipe.gen_cap_tokens_per_code = 1.0
        for name, run in runs.items():
            fa.flash_attention.launches = 0
            outs[name, dev] = run(pipe)
            if (dev == "cuda" and name not in ("streaming", "server")
                    and fa.flash_attention.launches == 0):
                raise AssertionError(f"small-config {name}: the flash kernel never ran")
        tokens[dev] = beam_sample_tokens(pipe, engine, seg, ref, noise)
    print(f"small f32 config beam_sample, card vs CPU: {len(tokens['cuda'])} vs "
          f"{len(tokens['cpu'])} tokens, equal {tokens['cuda'] == tokens['cpu']}", flush=True)
    if tokens["cuda"] != tokens["cpu"] or len(tokens["cpu"]) < 2:
        raise AssertionError("small-config beam_sample tokens differ between card and CPU")
    for name in runs:
        for a, b in zip(outs[name, "cpu"], outs[name, "cuda"]):
            err = float(abs(a - b).max()) if a.shape == b.shape and a.size else None
            print(f"small f32 config {name}, card vs CPU: samples {b.shape[0]} vs "
                  f"{a.shape[0]}, max |err| {err} (tol 1e-3)", flush=True)
            if err is None or err > 1e-3:
                raise AssertionError(f"small-config {name} output differs between "
                                     "card and CPU")


def check_audio(name, wav, sample_rate):
    import numpy as np

    if not (wav.ndim == 1 and wav.size > 0 and np.isfinite(wav).all()
            and np.abs(wav).max() <= 1.0 and sample_rate == 24000):
        raise AssertionError(f"{name}: output is not finite 24 kHz audio")


class Launches:
    """The kernels' launch counts over one call of a path: zeroed just
    before it, read just after."""

    def __init__(self, da, fa):
        self.da, self.fa = da, fa

    def __enter__(self):
        self.da.decode_attention_layer.launches = 0
        self.da.decode_attention_update_layer.launches = 0
        self.fa.flash_attention.launches = 0
        self.fa.flash_attention_dq.launches = 0
        self.fa.flash_attention_dkdv.launches = 0
        return self

    def __exit__(self, *exc):
        self.k1 = self.da.decode_attention_layer.launches
        self.k3 = self.da.decode_attention_update_layer.launches
        self.k4 = self.fa.flash_attention.launches
        self.k5 = self.fa.flash_attention_dq.launches
        self.k6 = self.fa.flash_attention_dkdv.launches
        return False

    def counts(self):
        return {"decode_attention_layer": self.k1, "decode_attention_update_layer": self.k3,
                "flash_attention": self.k4, "flash_attention_dq": self.k5,
                "flash_attention_dkdv": self.k6}


def expect(name, got, want):
    if got != want or want == 0:
        raise AssertionError(f"{name}: {got} launches, expected {want} (> 0)")


def expect_none(path, n, kernels):
    """Kernels that are not on ``path`` were not launched during it."""
    for k in kernels:
        if getattr(n, k):
            raise AssertionError(f"{path}: {k.upper()} launched {getattr(n, k)} times")


def check_serving(pipe, server_cls, srcs, refs, da, fa, gpu, runs=3):
    """``StreamServer(pipe, slots=8)`` with its defaults (first window 4,
    waves of up to 4, 2 ticks in flight) drains all streams, submitted at
    one instant; run 0 (after ``warmup_admission``) warms up. Per drain:
    aggregate RTF (wall time over the total source), first-audio latency
    p50 / p95 from that instant, pool counters and launches. Checks the
    audio, that every stream completed, and that the server launched K3 30
    times per per-row decode step and neither K1 nor K4. Returns the last
    drain's launch counts."""
    import numpy as np

    layers = pipe.gpt_cfg.layers
    total_s = sum(s.shape[-1] for s in srcs) / 16000
    for run in range(runs):
        server = server_cls(pipe, slots=8)
        if run == 0:
            server.warmup_admission()
        with Launches(da, fa) as n:
            t0 = time.perf_counter()
            sids = [server.submit(s, r, arrival_t=t0) for s, r in zip(srcs, refs)]
            server.drain()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
        m = server.metrics()
        results = [server.result(sid) for sid in sids]
        for wav, _ in results:
            check_audio("serving", wav, pipe.sample_rate)
        if m["completed"] != len(srcs):
            raise AssertionError(f"serving: {m['completed']} of {len(srcs)} streams completed")
        expect("serving K3", n.k3, layers * m["decode_steps"])
        expect_none("serving", n, ("k1", "k4", "k5", "k6"))
        lat_ms = np.asarray([stats["latency_s"] for _, stats in results]) * 1e3
        print("serving " + json.dumps({
            "run": run, "warm_up": run == 0, "streams": len(srcs), "slots": server.slots,
            "source_s": total_s, "wall_s": elapsed, "aggregate_rtf": elapsed / total_s,
            "first_audio_ms_p50": float(np.percentile(lat_ms, 50)),
            "first_audio_ms_p95": float(np.percentile(lat_ms, 95)),
            "ticks": m["ticks"], "mean_occupancy": m["mean_occupancy"],
            "admissions": m["admissions"], "decode_steps": m["decode_steps"],
            "k1_launches": n.k1, "k3_launches": n.k3, "k4_launches": n.k4,
            "gpu": gpu}), flush=True)
    return n.counts()


def check_search_modes(pipe, engine, src, ref, da, fa, gpu, reorder, runs=2):
    """Offline beam search (4 beams), beam_sample (4), group beam search (4
    beams, 2 groups) and contrastive search (4 candidates) through
    ``synthesize``, and constrained beam search (4 beams, one two-token
    phrase) through ``engine.decode_constrained`` in ``synthesize``'s place of
    the segment decoder, on the 1.54 s source; each after one warm-up.
    Checks the audio and the launches (K1 30 per forward, K4 30 per latent
    pass, K3 / K5 / K6 none); prints wall ms, RTF and forwards, beside the
    beam reorder's device ms per step (``reorder``, phase 1's record at these
    shapes). Returns the launch counts of each mode's last run."""
    seconds = src.shape[-1] / 16000
    layers = pipe.gpt_cfg.layers

    def constrained_segment(codes, n_codes):
        prefix, valid, state = pipe._tiled_segment(codes, n_codes, 4)
        buf, n = engine.decode_constrained(
            pipe.gpt, state, prefix, valid, pipe._max_new(n_codes), 4, [[17, 3]],
            repetition_penalty=pipe.sampler.repetition_penalty,
            prefix_fake_len=pipe.gpt_cfg.n_cond_latents + n_codes + 3)
        return buf[:n].tolist(), state.steps

    modes = {
        "beam": lambda: pipe.synthesize(src, ref, num_beams=4),
        "beam_sample": lambda: pipe.synthesize(src, ref, num_beams=4, beam_do_sample=True),
        "group_beam": lambda: pipe.synthesize(src, ref, num_beams=4, num_beam_groups=2),
        "contrastive": lambda: pipe.synthesize(src, ref, penalty_alpha=0.6,
                                               contrastive_top_k=4),
        "constrained": lambda: pipe._synthesize_with(src, ref, constrained_segment),
    }
    by_path = {}
    for name, run_mode in modes.items():
        run_mode()  # warm-up
        rtf = []
        for run in range(runs):
            with Launches(da, fa) as n:
                t0 = time.perf_counter()
                wav = run_mode()
                torch.cuda.synchronize()
                elapsed = time.perf_counter() - t0
            timing = pipe.last_timing
            check_audio(name, wav, pipe.sample_rate)
            expect(f"{name} K1", n.k1, layers * timing["decode_steps"])
            expect(f"{name} K4", n.k4, layers * timing["latent_passes"])
            expect_none(name, n, ("k3", "k5", "k6"))
            rtf.append(elapsed / seconds)
            print(f"{name} run {run}: {seconds:.2f} s source, {wav.size} samples, "
                  f"{elapsed * 1e3:.1f} ms, RTF {rtf[-1]:.4f}, forwards "
                  f"{timing['decode_steps']}, latent passes {timing['latent_passes']}, "
                  f"K1 launches {n.k1}, K4 launches {n.k4}", flush=True)
        by_path[name] = n.counts()
        print(json.dumps({name: {
            "rtf_median": statistics.median(rtf), "runs": len(rtf),
            "forwards": timing["decode_steps"], "source_s": seconds,
            # contrastive search copies one slot a step instead of reordering
            "reorder_device_ms_per_step": None if name == "contrastive"
            else reorder["device_ms"], "gpu": gpu}}), flush=True)
    return by_path


def _stage_trees(paths):
    from genvc_tpu_torch import checkpoint as ckpt

    return {"contentvec": ckpt.load_contentvec(paths["contentvec"]),
            "acoustic_dvae": ckpt.load_dvae(paths["acoustic_dvae"]),
            "content_dvae": ckpt.load_dvae(paths["content_dvae"])}


def check_small_train_against_cpu(da, fa, tmp):
    """Two GPT training steps of a small f32 configuration (the synthetic
    stage checkpoints: GPT 2 x 64, hd = 16; ContentVec 1 layer; dVAEs hidden
    16) on the card (K4 / K5 / K6) and on the CPU (their plain versions) from
    the same files and batch, ``adamw_grouped`` (lr 1e-3 halved at step 1,
    weight decay 0.1, Adam eps 1e-3). Codes identical; losses, top-10 and
    gradient norms within 1e-4 relative (f32 on both sides, TF32 off, sums in
    other orders); parameters within 1e-5 (updates are ~lr = 1e-3; the large
    eps keeps noise-level gradients from being normalized up to ~lr)."""
    import numpy as np

    from genvc_tpu_torch import checkpoint as ckpt
    from genvc_tpu_torch import config, resolve_device
    from genvc_tpu_torch.models import gpt as gpt_model
    from genvc_tpu_torch.testing_synthetic import write_stage_ckpts
    from genvc_tpu_torch.train import gpt_stage, optim

    paths = write_stage_ckpts(os.path.join(tmp, "small"))
    cfg = config.GenVCConfig()
    for c, ch, nt in ((cfg.acoustic_dvae_config, 80, 64), (cfg.content_dvae_config, 256, 36)):
        c.num_channels, c.num_tokens, c.hidden_dim, c.codebook_dim = ch, nt, 16, 24
        c.num_resnet_blocks = 3
    gcfg = gpt_model.GPTConfig(layers=2, model_dim=64, heads=4)
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((2, 1, 6 * 1920)) * 0.1).astype(np.float32)
    wav[1, :, 4 * 1920:] = 0
    batch = {"wav": wav, "wav_lengths": np.asarray([6 * 1920, 4 * 1920]),
             "conditioning": (rng.standard_normal((2, 1, 1, 48000)) * 0.1).astype(np.float32),
             "cond_lens": np.asarray([48000, 30000]), "text_lengths": np.asarray([6, 4])}
    runs = {}
    for dev in ("cpu", "cuda"):
        dev = resolve_device(dev)
        frozen = gpt_stage.make_frozen(cfg, _stage_trees(paths), np.ones(80, np.float32), dev)
        with torch.device("meta"):
            model = gpt_model.GPT(gcfg)
        ckpt.assign(model, ckpt.load_gpt(paths["gpt"], gcfg.layers), dev)
        flat = optim.FlatParams(model)
        tx = optim.adamw_grouped(optim.multistep_schedule(1e-3, [1], 0.5), eps=1e-3,
                                 weight_decay=0.1, params=flat).init(flat.flat)
        state = gpt_stage.GPTTrainState(model, flat, tx)
        step, _ = gpt_stage.make_train_step(attn_impl="flash", grad_norms=True)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        feats = gpt_stage.prepare_features(frozen, tb)
        metrics = []
        with Launches(da, fa) as n:
            for _ in range(2):
                state, m = step(state, tb, frozen)
                metrics.append({k: float(v) for k, v in m.items()})
        runs[dev.type] = (feats, metrics, ckpt.export_tree(model), n)
    (fc, mc, pc, _), (fg, mg, pg, ng) = runs["cpu"], runs["cuda"]
    if (ng.k4, ng.k5, ng.k6) != (4, 4, 4):
        raise AssertionError(f"small train step: K4/K5/K6 launched {ng.k4}/{ng.k5}/{ng.k6} "
                             "times, expected 4 each (2 layers x 2 steps)")
    for k in ("audio_codes", "text_inputs"):
        if not torch.equal(fc[k], fg[k].cpu()):
            raise AssertionError(f"small train step: {k} differ between card and CPU")
    worst = 0.0
    for a, b in zip(mc, mg):
        for k in a:
            rel = abs(a[k] - b[k]) / max(abs(a[k]), 1e-6)
            worst = max(worst, rel)
            if rel > 1e-4 and abs(a[k] - b[k]) > 1e-6:
                raise AssertionError(f"small train step: {k} {b[k]} on the card vs {a[k]}")

    def leaves(t, prefix=""):
        for k_, v_ in t.items():
            if isinstance(v_, dict):
                yield from leaves(v_, prefix + k_ + ".")
            else:
                yield prefix + k_, v_
    pcpu = dict(leaves(pc))
    perr = max(float(np.abs(pcpu[k_] - v_).max()) for k_, v_ in leaves(pg))
    if perr > 1e-5:
        raise AssertionError(f"small train step: parameters differ by {perr} after 2 steps")
    print("small f32 config training, card vs CPU: 2 steps, losses "
          f"{[m['loss'] for m in mg]} vs {[m['loss'] for m in mc]}, grad_norm/total "
          f"{[m['grad_norm/total'] for m in mg]}, max rel metric err {worst:.2e} (tol 1e-4), "
          f"max |param err| {perr:.2e} (tol 1e-5), codes identical, K4/K5/K6 launches "
          f"{ng.k4}/{ng.k5}/{ng.k6}", flush=True)


def write_training_assets(tmp):
    """Frozen stage checkpoints at flagship width in the reference formats
    (seeded random weights: ContentVec 12 layers; acoustic dVAE 80 ch / 1024
    tokens and content dVAE 256 ch / 256 tokens, codebook 512, hidden 512)
    and a metafile of 48 wavs, each a sample tiled to >= 8.5 s at 24 kHz
    (rolled so no two are equal). Returns (paths, metafile)."""
    import numpy as np

    from genvc_tpu_torch import testing_synthetic as ts
    from genvc_tpu_torch.dsp.audio_io import load_audio, write_wav

    torch.manual_seed(0)
    paths = {"contentvec": os.path.join(tmp, "contentvec.pt"),
             "acoustic_dvae": os.path.join(tmp, "acoustic_dvae.pth"),
             "content_dvae": os.path.join(tmp, "content_dvae.pth")}
    torch.save({"model": ts.contentvec_sd(prefix="", n_layers=12)}, paths["contentvec"])
    torch.save(ts.dvae_sd("", 80, 1024, codebook_dim=512, hidden=512), paths["acoustic_dvae"])
    torch.save(ts.dvae_sd("", 256, 256, codebook_dim=512, hidden=512), paths["content_dvae"])
    srcs = [load_audio(os.path.join(HERE, "samples", f), 24000)[0]
            for f in ("EF4_ENG_0112_1.wav", "EM1_ENG_0037_1.wav")]
    meta = os.path.join(tmp, "train.txt")
    with open(meta, "w") as f:
        for i in range(48):
            src = srcs[i % 2]
            wav = np.roll(np.tile(src, -(-int(8.5 * 24000) // src.size)), 4801 * i)
            path = os.path.join(tmp, f"w{i}.wav")
            write_wav(path, wav, 24000)
            f.write(f"{path}|spk{i % 2}\n")
    return paths, meta


def check_training(da, fa, tmp, gpu):
    """Phase 4: GPT training at flagship width through the runner, then steps
    on one fixed batch. Returns the runner run's launch counts."""
    import random

    import numpy as np

    from genvc_tpu_torch import checkpoint as ckpt
    from genvc_tpu_torch.train import gpt_stage, runner
    from genvc_tpu_torch.train_genVC import recipe_config

    t0 = time.perf_counter()
    paths, meta = write_training_assets(tmp)
    cfg = recipe_config(meta, meta, os.path.join(HERE, "pre_trained", "mel_stats.npy"),
                        paths["acoustic_dvae"], paths["content_dvae"], paths["contentvec"],
                        output_path=os.path.join(tmp, "exp"), batch_size=8, num_workers=4)
    ma = cfg.model_args
    ma.min_text_length = ma.max_text_length = 50
    cfg.print_step = 1
    layers, steps, b, text_len = ma.gpt_layers, 6, cfg.batch_size, 50
    print(f"training assets written in {time.perf_counter() - t0:.1f} s", flush=True)

    # the entry point: 1 warm-up + 5 timed steps, a checkpoint at the end
    torch.cuda.reset_peak_memory_stats()
    with Launches(da, fa) as n:
        t0 = time.perf_counter()
        state = runner.run_gpt_training(cfg, max_steps=steps, bf16=True, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak_b8 = torch.cuda.max_memory_allocated()
    for k in ("k4", "k5", "k6"):
        expect(f"training {k.upper()}", getattr(n, k), layers * steps)
    expect_none("training", n, ("k1", "k3"))
    counts = n.counts()
    with open(os.path.join(cfg.output_path, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    losses = [r["loss"] for r in log]
    step_ms = [1e3 / r["steps_per_sec"] for r in log]
    if len(log) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"training: {len(log)} logged steps, losses {losses}")
    del state

    # resume from the step-6 checkpoint for one more step
    with Launches(da, fa) as n:
        state = runner.run_gpt_training(cfg, max_steps=steps + 1, bf16=True, device="cuda")
    if state.step != steps + 1 or state.opt.count != steps + 1:
        raise AssertionError(f"resume: step {state.step}, optimizer count {state.opt.count}")
    expect("resumed K5", n.k5, layers)

    # one fixed batch: the step timed with a device sync, flash vs xla in turns
    frozen = gpt_stage.make_frozen(cfg, _stage_trees(paths),
                                   ckpt.load_mel_norms(ma.mel_norm_file), torch.device("cuda"))
    train_ds, _ = runner.datasets(cfg)
    batch = runner.to_device(train_ds.collate(list(range(b)), random.Random(0)), "cuda")
    feats = gpt_stage.prepare_features(frozen, batch)
    t_len = 32 + feats["text_inputs"].shape[1] + 2 + feats["audio_codes"].shape[1] + 2
    step_fns = {impl: gpt_stage.make_train_step(compute_dtype=torch.bfloat16,
                                                attn_impl=impl)[0] for impl in ("flash", "xla")}
    times, fixed_losses = {"flash": [], "xla": []}, []

    def run(impl, k, record=True):
        nonlocal state
        for _ in range(k):
            with Launches(da, fa) as n:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step_fns[impl](state, batch, frozen)
                loss = float(m["loss"])
                ms = (time.perf_counter() - t0) * 1e3
            want = layers if impl == "flash" else 0
            if (n.k4, n.k5, n.k6) != (want, want, want) or n.k1 or n.k3:
                raise AssertionError(f"fixed-batch {impl} step launches {n.counts()}")
            fixed_losses.append(loss)
            if record:
                times[impl].append(ms)

    run("flash", 1, record=False)
    run("xla", 1, record=False)
    for impl in ("flash", "xla", "xla", "flash"):
        run(impl, 3)
    if not (all(np.isfinite(fixed_losses)) and fixed_losses[-1] < fixed_losses[0]):
        raise AssertionError(f"fixed batch: losses did not fall: {fixed_losses}")

    # the recipe's B = 24 with 100-token texts: one step, peak memory
    ma.min_text_length = ma.max_text_length = 100
    train_ds, _ = runner.datasets(cfg)
    batch = runner.to_device(train_ds.collate(list(range(24)), random.Random(1)), "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = step_fns["flash"](state, batch, frozen)
    loss24 = float(m["loss"])
    ms24 = (time.perf_counter() - t0) * 1e3
    peak_b24 = torch.cuda.max_memory_allocated()
    if not np.isfinite(loss24):
        raise AssertionError(f"B=24 step: loss {loss24}")

    # bench_train.py's analytic count: 6 * sequence tokens * core parameters
    def flops(bsz, tl):
        return 6 * bsz * (32 + tl + 2 + tl * 1920 // 1024 + 6) * 12 * layers * 1024 ** 2

    med = {k: statistics.median(v) for k, v in times.items()}
    rec = {"batch": b, "text_len": text_len, "T": t_len, "layers": layers,
           "dtype": "bf16 on f32 masters", "attn_impl": "flash",
           "runner_steps": steps, "runner_wall_s": wall,
           "runner_step_ms": step_ms, "runner_step_ms_median_timed": statistics.median(
               step_ms[1:]), "runner_losses": losses,
           "fixed_batch_step_ms": times["flash"], "step_ms_median": med["flash"],
           "step_ms_min": min(times["flash"]), "step_ms_max": max(times["flash"]),
           "tokens_per_s": b * text_len * 2.875 / (med["flash"] / 1e3),
           "mfu": flops(b, text_len) / (med["flash"] / 1e3) / BF16_FLOPS,
           "xla_step_ms": times["xla"], "xla_step_ms_median": med["xla"],
           "xla_over_flash": med["xla"] / med["flash"], "fixed_batch_losses": fixed_losses,
           "max_memory_allocated_b8": peak_b8, "resumed_to_step": steps + 1,
           "b24_text_len": 100, "b24_step_ms": ms24, "b24_loss": loss24,
           "b24_mfu": flops(24, 100) / (ms24 / 1e3) / BF16_FLOPS,
           "max_memory_allocated_b24": peak_b24, "launches": counts, "gpu": gpu}
    print("training " + json.dumps(rec), flush=True)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    from genvc_tpu_torch import _build
    from genvc_tpu_torch.decode import engine
    from genvc_tpu_torch.dsp.audio_io import load_audio
    from genvc_tpu_torch.inference import pipeline
    from genvc_tpu_torch.ops import decode_attention as da
    from genvc_tpu_torch.ops import flash_attention as fa
    from genvc_tpu_torch.serving.server import StreamServer

    begin = time.perf_counter()
    gpu = gpu_line()
    print(f"gpu: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32

    # ---- phase 1: build and check every kernel
    t0 = time.perf_counter()
    kernels = ["decode_attention", "flash_attention", "flash_attention_bwd"]
    logs = _build.build_all(kernels)
    print(f"built {kernels} in {time.perf_counter() - t0:.1f} s", flush=True)
    ptxas = {name: ptxas_summary(log) for name, log in logs.items()}
    for name, funcs in ptxas.items():
        for func, info in funcs.items():
            print(f"  ptxas {name}: {func} {json.dumps(info)}")
    # dynamic shared memory per block at the training shapes (B=8, H=4, hd=256)
    bwd_build = {"functions": ptxas["flash_attention_bwd"], "dynamic_smem_bytes": {
        f"{part}_{dt}_T{t}": fa.bwd_smem_bytes(8, 4, t, 256, part == "dkdv", dt == "bf16")
        for part in ("dq", "dkdv") for dt in ("bf16", "f32") for t in (184, 328)}}
    print("flash_attention_bwd build " + json.dumps(bwd_build), flush=True)
    k1, k1_beam = check_decode_attention(da)
    reorder_rec = check_beam_reorder(da, engine, gpu)
    k3_recs = check_decode_attention_update(da)
    k3 = k3_recs[8, "bfloat16"]
    check_fp8_overflow(da)
    k4, k4_train = check_flash_attention(fa)
    k56, k56_328 = check_flash_backward(fa)

    # ---- phase 2: a small f32 configuration, card vs CPU
    src = load_audio(os.path.join(HERE, "samples", "EF4_ENG_0112_1.wav"), 16000)
    ref = load_audio(os.path.join(HERE, "samples", "EM1_ENG_0037_1.wav"), 24000)
    src2 = load_audio(os.path.join(HERE, "samples", "EM1_ENG_0037_1.wav"), 16000)
    ref2 = load_audio(os.path.join(HERE, "samples", "EF4_ENG_0112_1.wav"), 24000)
    if any(x is None for x in (src, ref, src2, ref2)):
        raise RuntimeError("could not load the sample wavs")
    check_small_against_cpu(pipeline, engine, StreamServer, fa, src, ref, src2)
    with tempfile.TemporaryDirectory() as tmp:
        check_small_train_against_cpu(da, fa, tmp)

    # ---- phase 3: every path at flagship width, bf16
    cfg = pipeline.flagship_config()
    t0 = time.perf_counter()
    pipe = pipeline.build_pipeline(pipeline.random_tree(cfg, seed=0, device="cuda"),
                                   cfg, device="cuda", dtype=torch.bfloat16)
    pipe.gen_cap_tokens_per_code = 1.875
    torch.cuda.synchronize()
    print(f"flagship pipeline built in {time.perf_counter() - t0:.1f} s", flush=True)
    layers = pipe.gpt_cfg.layers  # K1 and K4 each run once per GPT block
    by_path = {}

    # streaming, one utterance
    pipe.synthesize_streaming(src, ref, verbose=False)  # warm-up (cuDNN plans)
    lat, rtf = [], []
    for run in range(5):
        with Launches(da, fa) as n:
            wav, latency, r = pipe.synthesize_streaming(src, ref, verbose=False)
        steps = pipe.last_timing["decode_steps"]
        check_audio("streaming", wav, pipe.sample_rate)
        expect("streaming K1", n.k1, layers * steps)
        expect_none("streaming", n, ("k3", "k4", "k5", "k6"))
        lat.append(latency * 1e3)
        rtf.append(r)
        print(f"streaming run {run}: {wav.size} samples, first-chunk latency "
              f"{latency * 1e3:.2f} ms, RTF {r:.4f}, decode steps {steps}, "
              f"K1 launches {n.k1}", flush=True)
    by_path["streaming"] = n.counts()
    print(json.dumps({"streaming": {"latency_ms_median": statistics.median(lat),
                                    "rtf_median": statistics.median(rtf),
                                    "runs": len(lat), "gpu": gpu}}), flush=True)

    # offline, one utterance of two segments (6 s + 1.68 s)
    tiled = np.tile(src, (1, 5))
    seconds = tiled.shape[-1] / 16000
    pipe.synthesize(tiled, ref)  # warm-up
    rtf = []
    for run in range(3):
        with Launches(da, fa) as n:
            t0 = time.perf_counter()
            wav = pipe.synthesize(tiled, ref)
            elapsed = time.perf_counter() - t0
        timing = pipe.last_timing
        check_audio("offline", wav, pipe.sample_rate)
        expect("offline K1", n.k1, layers * timing["decode_steps"])
        expect("offline K4", n.k4, layers * timing["latent_passes"])
        expect_none("offline", n, ("k3", "k5", "k6"))
        rtf.append(elapsed / seconds)
        print(f"offline run {run}: {seconds:.2f} s source, {wav.size} samples, "
              f"{elapsed * 1e3:.1f} ms, RTF {rtf[-1]:.4f}, decode steps "
              f"{timing['decode_steps']}, latent passes {timing['latent_passes']}, "
              f"K1 launches {n.k1}, K4 launches {n.k4}", flush=True)
    by_path["offline"] = n.counts()
    print(json.dumps({"offline": {"rtf_median": statistics.median(rtf), "runs": len(rtf),
                                  "source_s": seconds, "gpu": gpu}}), flush=True)

    # batch, offline and streamed: 4 utterances of 7.68, 1.54, 4.12 and 8.24 s
    srcs = [tiled, src, src2, np.tile(src2, (1, 2))]
    refs = [ref, ref2, ref, ref2]
    total_s = sum(s.shape[-1] for s in srcs) / 16000
    for name, run_batch in (
            ("batch", lambda: pipe.synthesize_batch(srcs, refs)),
            ("streaming_batch",
             lambda: pipe.synthesize_streaming_batch(srcs, refs, verbose=False)[0])):
        run_batch()  # warm-up
        rtf = []
        for run in range(2):
            with Launches(da, fa) as n:
                t0 = time.perf_counter()
                wavs = run_batch()
                elapsed = time.perf_counter() - t0
            timing = pipe.last_timing
            for w in wavs:
                check_audio(name, w, pipe.sample_rate)
            expect(f"{name} K1", n.k1, layers * timing["decode_steps"])
            if name == "batch":
                expect(f"{name} K4", n.k4, layers * timing["latent_passes"])
            expect_none(name, n, ("k3", "k5", "k6") if name == "batch"
                        else ("k3", "k4", "k5", "k6"))
            rtf.append(elapsed / total_s)
            print(f"{name} run {run}: 4 utterances, {total_s:.2f} s of source, "
                  f"{elapsed * 1e3:.1f} ms, aggregate RTF {rtf[-1]:.4f}, decode steps "
                  f"{timing['decode_steps']}, K1 launches {n.k1}, K4 launches {n.k4}",
                  flush=True)
        by_path[name] = n.counts()
        print(json.dumps({name: {"aggregate_rtf_median": statistics.median(rtf),
                                 "runs": len(rtf), "utterances": len(srcs),
                                 "source_s": total_s, "gpu": gpu}}), flush=True)
    by_path.update(check_search_modes(pipe, engine, src, ref, da, fa, gpu, reorder_rec))
    # serving: 16 streams (the batch's 4 sources x 4) into 8 slots at once
    by_path["serving"] = check_serving(pipe, StreamServer, srcs * 4, [ref, ref2] * 8,
                                       da, fa, gpu)
    del pipe
    torch.cuda.empty_cache()

    # ---- phase 4: GPT training at flagship width
    with tempfile.TemporaryDirectory() as tmp:
        by_path["training"] = check_training(da, fa, tmp, gpu)
    print(f"chip_smoke: {time.perf_counter() - begin:.1f} s", flush=True)

    def launches(kernel):
        return {path: counts[kernel] for path, counts in by_path.items()}

    print(json.dumps({"kernels": [{
        "name": "decode_attention_layer", "route": "cuda",
        "design": "cache length split over blocks, two passes",
        "source": "genvc_tpu_torch/csrc/decode_attention.cu",
        "replaces": "genvc_tpu/ops/decode_attention.py:160",
        "launches": sum(launches("decode_attention_layer").values()),
        "launches_by_path": launches("decode_attention_layer"),
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"], "bound_by": "bytes",
        "library_ms": k1["library_ms"], "ratio": k1["ratio"],
        "cuda_launches_per_call": k1["cuda_launches_per_call"],
        "beam_shape": {key: k1_beam[key] for key in (
            "B", "T", "ms", "device_ms", "library_ms", "library_device_ms", "device_ratio",
            "bound_ms", "max_abs_err")},
        "on_reordered_cache_max_abs_err": reorder_rec["k1_on_reordered_max_abs_err"],
        "beam_reorder": {key: reorder_rec[key] for key in (
            "B", "T", "device_ms", "bound_ms", "launches_per_call")}}, {
        "name": "decode_attention_update_layer", "route": "cuda",
        "design": "K1's split over the cache length, two passes, the row write "
                  "folded into the logits pass by the block whose key range holds it",
        "source": "genvc_tpu_torch/csrc/decode_attention.cu",
        "replaces": "genvc_tpu/ops/decode_attention.py:281",
        "launches": sum(launches("decode_attention_update_layer").values()),
        "launches_by_path": launches("decode_attention_update_layer"),
        "max_abs_err": max(r["max_abs_err"] for r in k3_recs.values()), "ms": k3["ms"],
        "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"], "bound_by": "bytes",
        "library_ms": k3["library_ms"], "device_ms": k3["device_ms"],
        "library_device_ms": k3["library_device_ms"],
        "keys_per_split": k3["keys_per_split"],
        "cuda_launches_per_call": k3["cuda_launches_per_call"],
        "by_shape": {f"B{b}_{c}": {key: r[key] for key in (
            "device_ms", "bound_ms", "library_device_ms", "device_ratio")}
            for (b, c), r in k3_recs.items()}}, {
        "name": "flash_attention", "route": "cuda",
        "design": "bf16 mma.sync tiles, cp.async double buffer",
        "source": "genvc_tpu_torch/csrc/flash_attention.cu",
        "replaces": "genvc_tpu/ops/flash_attention.py:134",
        "launches": sum(launches("flash_attention").values()),
        "launches_by_path": launches("flash_attention"),
        "max_abs_err": k4["max_abs_err"], "ms": k4["ms"],
        "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"], "library_ms": k4["library_ms"], "ratio": k4["ratio"],
        "training_shape": {key: k4_train[key] for key in (
            "B", "T", "ms", "library_ms", "library_causal_ms", "ratio", "ratio_causal",
            "bound_ms")}}] + [{
        # K5 / K6: plain_ms and library_ms (SDPA's backward) are of the whole
        # backward, dq, dk and dv together; ms and bound_ms of the kernel alone
        "name": name, "route": "cuda", "design": design,
        "source": "genvc_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": replaces,
        "launches": sum(launches(name).values()), "launches_by_path": launches(name),
        "max_abs_err": max(k56["max_abs_err"][g] for g in grads),
        "ms": k56[f"{part}_ms"], "plain_ms": k56["plain_ms"],
        "bound_ms": k56["bound_ms"][part], "bound_by": k56["bound_by"][part],
        "library_ms": k56["library_ms"], "device_ms": k56[f"{part}_device_ms"],
        "library_device_ms": k56["library_device_ms"],
        "pair_device_ratio": k56["device_ratio"],
        "T328": {key: k56_328[key] for key in (
            f"{part}_ms", f"{part}_device_ms", "library_ms", "library_device_ms",
            "device_ratio")} | {"bound_ms": k56_328["bound_ms"][part]},
        "ptxas": {f: info for f, info in bwd_build["functions"].items() if tag in f},
        "dynamic_smem_bytes": {t: bwd_build["dynamic_smem_bytes"][f"{part}_bf16_T{t}"]
                               for t in (184, 328)}}
        for name, replaces, part, grads, tag, design in (
            ("flash_attention_dq", "genvc_tpu/ops/flash_attention.py:187", "dq", ("dq",),
             "dq_mma", "bf16 mma.sync: 8 warps per 32-row query tile (longest walks "
             "first), S and dP for a 16-row group x 16-key slice of every 64-key K/V "
             "tile (cp.async double buffer), dS through shared memory as bf16, each "
             "warp then 64 columns of its group's dQ over all keys; f32 SIMT"),
            ("flash_attention_dkdv", "genvc_tpu/ops/flash_attention.py:197", "dkdv",
             ("dk", "dv"), "dkdv_mma", "bf16 mma.sync, transposed: 8 warps per 64-key "
             "tile (32 when 64-key tiles leave SMs idle) walking 64-row Q/dO tiles "
             "(cp.async double buffer); S^T, dP^T split over warps by queries, P^T and "
             "dS^T through shared memory, dK and dV split by columns; f32 SIMT"))]}),
          flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
