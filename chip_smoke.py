"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 1 builds every hand-written kernel from ``genvc_tpu_torch/csrc`` (one
``nvcc`` per source, all in parallel), checks each against its plain PyTorch
version at the shapes the paths give it, and times kernel, plain version and
the library yardstick with CUDA events: K1 (cached decode attention; K2 is K1
with L = 1) at the flagship decode shapes, K4 (flash-attention forward, O and
LSE) at the latent pass's shapes.

Phase 2 runs a small f32 configuration on the card and on the CPU with the
same weights: streaming, offline ``synthesize`` and ``synthesize_batch`` must
give the same lengths and audio within 1e-3.

Phase 3 drives every ported path through its entry points at flagship width
(GPT 30 layers x 1024, 4 heads, bf16; ContentVec 12 layers; content dVAE
256 ch; default HiFi-GAN) with seeded random weights on the repo's sample
wavs: ``synthesize_streaming`` (5 runs), ``synthesize`` on a 7.68 s source
(two segments; 3 runs), and ``synthesize_batch`` / ``synthesize_streaming_batch``
with 4 utterances (2 runs each), each after one warm-up. It checks the audio
and that the kernels of each path were launched as often as the path says:
K1 30 times per decode step, K4 30 times per latent pass.

Prints measurements on earlier lines, the kernel table as one JSON line, the
GPU's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero on any failure or when no
CUDA device is present.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
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
# K4 vs plain: both compute in f32 from the same inputs; the sums run in
# another order (f32, ~1e-6 relative). A bf16 O is then rounded to bf16 on
# both sides, so one rounding may land a bf16 ulp apart (2^-8 relative).
FLASH_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
LSE_TOL = 1e-4
# (B, T, hd, dtype, masked key tail of the last row): the latent pass's
# shapes (T = 308 for a full 6 s segment, 180 for the 1.68 s tail of the
# flagship source), batched, in f32, and the small configuration's hd = 16
FLASH_CASES = [(1, 308, 256, torch.bfloat16, 0), (1, 180, 256, torch.bfloat16, 0),
               (1, 308, 256, torch.bfloat16, 57), (8, 308, 256, torch.bfloat16, 57),
               (1, 308, 256, torch.float32, 0), (1, 180, 16, torch.float32, 23)]


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


def decode_inputs(b, cache_dtype, q_dtype, seed):
    L, H, T, hd = FLAGSHIP["L"], FLAGSHIP["H"], FLAGSHIP["T"], FLAGSHIP["hd"]
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
    """K1 vs its plain version at the flagship decode shapes; returns the
    timing record of the main-path configuration (bf16 cache, bf16 q, B=1)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    L, H, T, hd = FLAGSHIP["L"], FLAGSHIP["H"], FLAGSHIP["T"], FLAGSHIP["hd"]
    main = None
    cases = [(1, torch.bfloat16, torch.bfloat16), (16, torch.bfloat16, torch.bfloat16),
             (1, torch.float8_e4m3fn, torch.bfloat16), (16, torch.float8_e4m3fn, torch.bfloat16),
             (1, torch.bfloat16, torch.float32), (1, torch.float8_e4m3fn, torch.float32)]
    for i, (b, cdt, qdt) in enumerate(cases):
        q, ck, cv, bias = decode_inputs(b, cdt, qdt, seed=i)
        worst = 0.0
        for layer in (0, 13, L - 1):
            got = da.decode_attention_layer(q, ck, cv, bias, layer).float()
            torch.cuda.synchronize()
            want = da.decode_attention_layer_plain(q, ck, cv, bias, layer).float()
            err = (got - want).abs()
            worst = max(worst, float(err.max()))
            if not bool((err <= TOL + TOL * want.abs()).all()):
                raise AssertionError(f"decode_attention B={b} cache={cdt} q={qdt} "
                                     f"layer={layer}: max |err| {float(err.max())}")
        # time over every layer in turn (the decode step's access pattern)
        lidx = iter(range(10 ** 9))
        ms = time_ms(lambda: da.decode_attention_layer(q, ck, cv, bias, next(lidx) % L))
        plain_ms = time_ms(lambda: da.decode_attention_layer_plain(q, ck, cv, bias,
                                                                   next(lidx) % L), iters=50)
        lib_ms = None
        if cdt == torch.bfloat16 and qdt == torch.bfloat16:
            q4, m4 = q[:, :, None, :], bias[:, None, None, :].to(torch.bfloat16)
            def lib_call():
                layer = next(lidx) % L
                return sdpa(q4, ck[layer], cv[layer], attn_mask=m4)
            lib_ms = time_ms(lib_call)
        n_bytes = (2 * b * H * T * hd * ck.element_size() + q.numel() * q.element_size()
                   + bias.numel() * 4 + q.numel() * q.element_size())
        flops = 4 * b * H * T * hd
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        rec = {"B": b, "cache": str(cdt).replace("torch.", ""),
               "q": str(qdt).replace("torch.", ""), "max_abs_err": worst, "tol": TOL,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bytes": n_bytes}
        print("decode_attention_layer " + json.dumps(rec), flush=True)
        if b == 1 and cdt == torch.bfloat16 and qdt == torch.bfloat16:
            main = rec
    # K2 (single-layer cache) is the same kernel with L = 1
    b = 2
    q, ck, cv, bias = decode_inputs(b, torch.bfloat16, torch.bfloat16, seed=99)
    k2, v2 = ck[3], cv[3]  # contiguous (B, H, T, hd) layer views
    got = da.decode_attention(q, k2, v2, bias).float()
    want = da.decode_attention_plain(q, k2, v2, bias).float()
    err = float((got - want).abs().max())
    if err > TOL + TOL * float(want.abs().max()):
        raise AssertionError(f"decode_attention L=1: max |err| {err}")
    m4 = bias[:, None, None, :].to(torch.bfloat16)
    n_bytes = 2 * b * H * T * hd * 2 + 2 * q.numel() * 2 + bias.numel() * 4
    rec = {"B": b, "cache": "bfloat16", "q": "bfloat16", "max_abs_err": err, "tol": TOL,
           "ms": time_ms(lambda: da.decode_attention(q, k2, v2, bias)),
           "plain_ms": time_ms(lambda: da.decode_attention_plain(q, k2, v2, bias), iters=50),
           "library_ms": time_ms(lambda: sdpa(q[:, :, None, :], k2, v2, attn_mask=m4)),
           "bound_ms": max(n_bytes / HBM_BYTES_PER_S, 4 * b * H * T * hd / BF16_FLOPS) * 1e3,
           "bound_by": "bytes", "bytes": n_bytes}
    print("decode_attention (L=1) " + json.dumps(rec), flush=True)
    return main


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
    """K4 vs its plain version on O and LSE at the latent pass's shapes;
    returns the timing record of the main-path shape (B=1, T=308, bf16)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    main = None
    for i, (b, t, hd, dt, tail) in enumerate(FLASH_CASES):
        h = 4
        q, k, v, valid = flash_inputs(b, t, hd, dt, tail, seed=100 + i)
        got_o, got_lse = fa.flash_attention_fwd(q, k, v, valid)
        torch.cuda.synchronize()
        want_o, want_lse = fa.flash_attention_plain(q, k, v, valid)
        err_o = (got_o.float() - want_o.float()).abs()
        err_lse = float((got_lse - want_lse).abs().max())
        tol = FLASH_TOL[dt]
        if not bool((err_o <= tol + tol * want_o.float().abs()).all()) or err_lse > LSE_TOL:
            raise AssertionError(f"flash_attention B={b} T={t} hd={hd} {dt} tail={tail}: "
                                 f"max |err| O {float(err_o.max())}, LSE {err_lse}")
        causal = torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
        mask = causal[None, None] & valid[:, None, None, :]
        elt = q.element_size()
        n_bytes = 4 * b * h * t * hd * elt + b * h * t * 4 + b * t
        flops = 2 * b * h * t * (t + 1) * hd  # q.k and p.v over the causal pairs
        peak = BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS
        rec = {"B": b, "T": t, "hd": hd, "dtype": str(dt).replace("torch.", ""),
               "masked_tail": tail, "max_abs_err": float(err_o.max()),
               "max_abs_err_lse": err_lse, "tol": tol, "tol_lse": LSE_TOL,
               "ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v, valid)),
               "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, valid), iters=50),
               "library_ms": time_ms(lambda: sdpa(q, k, v, attn_mask=mask)),
               "bound_ms": max(n_bytes / HBM_BYTES_PER_S, flops / peak) * 1e3,
               "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= flops / peak
               else "operations", "bytes": n_bytes, "flops": flops}
        print("flash_attention " + json.dumps(rec), flush=True)
        if i == 0:
            main = rec
    return main


def small_config(pipeline):
    cfg = pipeline.flagship_config()
    ma = cfg.model_args
    ma.gpt_layers, ma.gpt_n_model_channels, ma.gpt_n_heads = 2, 64, 4
    cd = cfg.content_dvae_config
    cd.codebook_dim, cd.hidden_dim = 24, 16
    cfg.vocoder_config.input_feat_dim = 64
    cfg.vocoder_config.upsample_initial_channel = 32
    return cfg


def check_small_against_cpu(pipeline, fa, src, ref, ref16):
    """A small f32 configuration (hd = 16) on the card vs the same weights on
    the CPU: greedy streaming, offline and batch (two rows of different
    lengths) give the same lengths and audio within 1e-3."""
    cfg = small_config(pipeline)
    tree = pipeline.random_tree(cfg, seed=1, device="cpu", contentvec_layers=2)
    runs = {
        "streaming": lambda p: [p.synthesize_streaming(src[:, :16000], ref, verbose=False)[0]],
        "offline": lambda p: [p.synthesize(src[:, :24000], ref)],
        "batch": lambda p: p.synthesize_batch([src[:, :24000], ref16[:, :40000]],
                                              [ref, ref[:, :48000]]),
    }
    outs = {}
    for dev in ("cpu", "cuda"):
        pipe = pipeline.build_pipeline(tree, cfg, device=dev, dtype=torch.float32)
        pipe.gen_cap_tokens_per_code = 1.0
        for name, run in runs.items():
            fa.flash_attention.launches = 0
            outs[name, dev] = run(pipe)
            if dev == "cuda" and name != "streaming" and fa.flash_attention.launches == 0:
                raise AssertionError(f"small-config {name}: the flash kernel never ran")
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
        self.fa.flash_attention.launches = 0
        return self

    def __exit__(self, *exc):
        self.k1 = self.da.decode_attention_layer.launches
        self.k4 = self.fa.flash_attention.launches
        return False


def expect(name, got, want):
    if got != want or want == 0:
        raise AssertionError(f"{name}: {got} launches, expected {want} (> 0)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    from genvc_tpu_torch import _build
    from genvc_tpu_torch.dsp.audio_io import load_audio
    from genvc_tpu_torch.inference import pipeline
    from genvc_tpu_torch.ops import decode_attention as da
    from genvc_tpu_torch.ops import flash_attention as fa

    begin = time.perf_counter()
    gpu = gpu_line()
    print(f"gpu: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32

    # ---- phase 1: build and check every kernel
    t0 = time.perf_counter()
    kernels = {"decode_attention": da, "flash_attention": fa}
    logs = _build.build_all(list(kernels))
    print(f"built {list(kernels)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")
    k1 = check_decode_attention(da)
    k4 = check_flash_attention(fa)

    # ---- phase 2: a small f32 configuration, card vs CPU
    src = load_audio(os.path.join(HERE, "samples", "EF4_ENG_0112_1.wav"), 16000)
    ref = load_audio(os.path.join(HERE, "samples", "EM1_ENG_0037_1.wav"), 24000)
    src2 = load_audio(os.path.join(HERE, "samples", "EM1_ENG_0037_1.wav"), 16000)
    ref2 = load_audio(os.path.join(HERE, "samples", "EF4_ENG_0112_1.wav"), 24000)
    if any(x is None for x in (src, ref, src2, ref2)):
        raise RuntimeError("could not load the sample wavs")
    check_small_against_cpu(pipeline, fa, src, ref, src2)

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
        lat.append(latency * 1e3)
        rtf.append(r)
        print(f"streaming run {run}: {wav.size} samples, first-chunk latency "
              f"{latency * 1e3:.2f} ms, RTF {r:.4f}, decode steps {steps}, "
              f"K1 launches {n.k1}", flush=True)
    by_path["streaming"] = {"decode_attention_layer": n.k1, "flash_attention": n.k4}
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
        rtf.append(elapsed / seconds)
        print(f"offline run {run}: {seconds:.2f} s source, {wav.size} samples, "
              f"{elapsed * 1e3:.1f} ms, RTF {rtf[-1]:.4f}, decode steps "
              f"{timing['decode_steps']}, latent passes {timing['latent_passes']}, "
              f"K1 launches {n.k1}, K4 launches {n.k4}", flush=True)
    by_path["offline"] = {"decode_attention_layer": n.k1, "flash_attention": n.k4}
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
            rtf.append(elapsed / total_s)
            print(f"{name} run {run}: 4 utterances, {total_s:.2f} s of source, "
                  f"{elapsed * 1e3:.1f} ms, aggregate RTF {rtf[-1]:.4f}, decode steps "
                  f"{timing['decode_steps']}, K1 launches {n.k1}, K4 launches {n.k4}",
                  flush=True)
        by_path[name] = {"decode_attention_layer": n.k1, "flash_attention": n.k4}
        print(json.dumps({name: {"aggregate_rtf_median": statistics.median(rtf),
                                 "runs": len(rtf), "utterances": len(srcs),
                                 "source_s": total_s, "gpu": gpu}}), flush=True)
    print(f"chip_smoke: {time.perf_counter() - begin:.1f} s", flush=True)

    def launches(kernel):
        return {path: counts[kernel] for path, counts in by_path.items()}

    print(json.dumps({"kernels": [{
        "name": "decode_attention_layer", "route": "cuda",
        "source": "genvc_tpu_torch/csrc/decode_attention.cu",
        "replaces": "genvc_tpu/ops/decode_attention.py:160",
        "launches": sum(launches("decode_attention_layer").values()),
        "launches_by_path": launches("decode_attention_layer"),
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"], "bound_by": "bytes",
        "library_ms": k1["library_ms"]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "genvc_tpu_torch/csrc/flash_attention.cu",
        "replaces": "genvc_tpu/ops/flash_attention.py:134",
        "launches": sum(launches("flash_attention").values()),
        "launches_by_path": launches("flash_attention"),
        "max_abs_err": k4["max_abs_err"], "ms": k4["ms"],
        "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"], "library_ms": k4["library_ms"]}]}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
