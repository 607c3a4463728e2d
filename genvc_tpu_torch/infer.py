"""Voice-conversion CLI of the PyTorch / CUDA port.

Usage:
    python -m genvc_tpu_torch.infer --model_path GenVC_small.pth \
        --src_wav samples/EF4_ENG_0112_1.wav \
        --ref_audio samples/EM1_ENG_0037_1.wav \
        --output_path out.wav [--streaming] [--top_k 1] [--bf16] \
        [--quantize int8] [--kv_cache fp8] [--seed 0] [--device cuda] \
        [--profile DIR]

    # offline search modes (single utterance, without --streaming)
    ... --num_beams 4 [--length_penalty 1.0] [--beam_do_sample]
    ... --num_beams 4 --num_beam_groups 2 [--diversity_penalty 1.0]
    ... --penalty_alpha 0.6 [--contrastive_top_k 4]

    # batch: N sources in one lockstep pass (one reference is broadcast)
    python -m genvc_tpu_torch.infer --model_path GenVC_small.pth \
        --src_wavs a.wav b.wav --ref_audios r.wav \
        [--output_paths a_out.wav b_out.wav] [--streaming] [--serve SLOTS]

Without ``--streaming`` the conversion is offline (``synthesize`` /
``synthesize_batch``); with it, streamed (``synthesize_streaming`` /
``synthesize_streaming_batch``, or with ``--serve SLOTS`` a continuous-batching
``StreamServer`` of SLOTS decode slots, which prints each stream's latency and
RTF and the pool's counters). The search flags (``--num_beams``,
``--num_beam_groups``, ``--penalty_alpha`` and their options) act on the
offline conversion of one utterance; streaming and batch ignore them, as in
the JAX package. ``--quantize int8`` runs the GPT's block projections and
heads as int8 W8A8 linears; with ``--kv_cache fp8`` (and ``--bf16``) it is
the recommended serving configuration, on every mode above. ``--model_path``
takes a reference ``.pth`` bundle or a converted ``.npz`` bundle (beside its
``<stem>.config.json``; ``python -m genvc_tpu_torch.tools.convert_checkpoint``).
``--serve`` without ``--src_wavs --streaming`` exits with code 2.
``--profile DIR`` records a ``torch.profiler`` trace of the conversion (after
the models are loaded; the card's kernels included) into ``DIR/trace.json``,
and the recorder's counters (``genvc_tpu_torch.tracing``) into
``DIR/counters.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", type=str, default="pre_trained/GenVC_large.pth")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--src_wav", type=str, default="samples/EF4_ENG_0112_1.wav")
    parser.add_argument("--ref_audio", type=str, default="samples/EM1_ENG_0037_1.wav")
    parser.add_argument("--output_path", type=str, default="samples/converted.wav")
    parser.add_argument("--src_wavs", type=str, nargs="+", default=None,
                        help="batch mode: convert N sources in one lockstep pass")
    parser.add_argument("--ref_audios", type=str, nargs="+", default=None,
                        help="per-source references for --src_wavs (one path "
                             "is broadcast)")
    parser.add_argument("--output_paths", type=str, nargs="+", default=None,
                        help="per-source outputs for --src_wavs (default: "
                             "<output_path stem>_<i>.wav)")
    parser.add_argument("--top_k", type=int, default=15)
    parser.add_argument("--streaming", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", action="store_true",
                        help="run the GPT in bfloat16")
    parser.add_argument("--kv_cache", type=str, default=None, choices=["fp8"],
                        help="store the decode KV cache as float8_e4m3")
    parser.add_argument("--num_beams", type=int, default=1,
                        help="beam search for offline conversion; 1 = sampling")
    parser.add_argument("--beam_do_sample", action="store_true",
                        help="with --num_beams > 1: HF beam_sample (multinomial "
                             "beam search with the sampling warpers)")
    parser.add_argument("--length_penalty", type=float, default=1.0)
    parser.add_argument("--num_beam_groups", type=int, default=1,
                        help="with --num_beams > 1: group (diverse) beam search")
    parser.add_argument("--diversity_penalty", type=float, default=1.0)
    parser.add_argument("--penalty_alpha", type=float, default=0.0,
                        help="contrastive search for offline conversion over "
                             "--contrastive_top_k candidates; 0 = off")
    parser.add_argument("--contrastive_top_k", type=int, default=4)
    parser.add_argument("--serve", type=int, default=0, metavar="SLOTS",
                        help="with --src_wavs --streaming: convert through a "
                             "continuous-batching StreamServer of SLOTS decode slots")
    parser.add_argument("--quantize", type=str, default=None, choices=["int8"],
                        help="int8 W8A8 GPT linears")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="record a torch.profiler trace of the conversion into "
                             "DIR/trace.json (Chrome trace format) and the recorder's "
                             "counters into DIR/counters.json")
    args = parser.parse_args(argv)

    if args.serve > 0 and not (args.src_wavs and args.streaming):
        print("--serve SLOTS takes effect with --src_wavs and --streaming (the "
              "StreamServer, ROADMAP A11)", file=sys.stderr)
        return 2
    if not os.path.exists(args.model_path):
        print(f"model checkpoint not found: {args.model_path}", file=sys.stderr)
        return 1

    import torch

    from genvc_tpu_torch.inference.pipeline import model_init
    from genvc_tpu_torch.utils import profile_trace

    pipe = model_init(args.model_path, device=args.device,
                      dtype=torch.bfloat16 if args.bf16 else torch.float32,
                      seed=args.seed, quantize=args.quantize,
                      kv_cache_dtype=args.kv_cache)
    # top_k is the main quality knob; greedy (top_k=1) is preferred for
    # streaming (reference README.md:52)
    pipe.sampler = dataclasses.replace(pipe.sampler, top_k=args.top_k)
    with profile_trace(args.profile):  # written on every exit path
        return _convert(args, pipe)


def _convert(args, pipe) -> int:
    """Load the audio, convert in the mode the flags ask for, write the
    outputs; returns the exit code."""
    from genvc_tpu_torch.dsp.audio_io import load_audio, write_wav

    if args.src_wavs:
        ref_paths = args.ref_audios or [args.ref_audio]
        if len(ref_paths) == 1:
            ref_paths = ref_paths * len(args.src_wavs)
        outs = args.output_paths
        if not outs:
            stem, ext = os.path.splitext(args.output_path)
            outs = [f"{stem}_{i}{ext or '.wav'}" for i in range(len(args.src_wavs))]
        if len(ref_paths) != len(args.src_wavs) or len(outs) != len(args.src_wavs):
            print("--ref_audios and --output_paths must match --src_wavs (or "
                  "give one reference)", file=sys.stderr)
            return 1
        srcs = [load_audio(p, pipe.content_sample_rate) for p in args.src_wavs]
        refs = [load_audio(p, pipe.sample_rate) for p in ref_paths]
        if any(x is None for x in srcs + refs):
            print("failed to load audio", file=sys.stderr)
            return 1
        if args.serve:
            wavs = _serve(pipe, srcs, refs, args.serve)
        elif args.streaming:
            wavs, _, _ = pipe.synthesize_streaming_batch(srcs, refs)
        else:
            wavs = pipe.synthesize_batch(srcs, refs)
        written = 0
        for path, wav in zip(outs, wavs):
            if wav.shape[-1] == 0:
                print(f"{path}: decode produced no audio; not written", file=sys.stderr)
                continue
            write_wav(path, wav, pipe.sample_rate)
            print(f"wrote {path}")
            written += 1
        return 0 if written else 1

    src_wav = load_audio(args.src_wav, pipe.content_sample_rate)
    ref_audio = load_audio(args.ref_audio, pipe.sample_rate)
    if src_wav is None or ref_audio is None:
        print("failed to load audio", file=sys.stderr)
        return 1
    if args.streaming:
        wav, _, _ = pipe.synthesize_streaming(src_wav, ref_audio)
    else:
        wav = pipe.synthesize(src_wav, ref_audio, num_beams=args.num_beams,
                              length_penalty=args.length_penalty,
                              penalty_alpha=args.penalty_alpha,
                              contrastive_top_k=args.contrastive_top_k,
                              beam_do_sample=args.beam_do_sample,
                              num_beam_groups=args.num_beam_groups,
                              diversity_penalty=args.diversity_penalty)
    if wav.shape[-1] == 0:
        print("decode produced no audio", file=sys.stderr)
        return 1
    write_wav(args.output_path, wav, pipe.sample_rate)
    print(f"wrote {args.output_path}")
    return 0


def _serve(pipe, srcs, refs, slots: int):
    """All sources through a ``StreamServer``; prints per-stream latency and
    RTF and the pool line. Returns the waveforms in source order."""
    from genvc_tpu_torch.serving.server import StreamServer

    server = StreamServer(pipe, slots=slots)
    sids = [server.submit(s, r) for s, r in zip(srcs, refs)]
    server.drain()
    wavs = []
    for sid in sids:
        wav, stats = server.result(sid)
        wavs.append(wav)
        rtf = f"{stats['rtf']:.3f}" if stats["rtf"] is not None else "n/a"
        print(f"stream {sid}: latency {(stats['latency_s'] or 0) * 1000:.0f} ms, rtf {rtf}")
    m = server.metrics()
    print(f"pool: {m['ticks']} ticks, mean occupancy {m['mean_occupancy']:.2f}/"
          f"{m['slots']}, {m['completed']} completed")
    return wavs


if __name__ == "__main__":
    sys.exit(main())
