"""The slice as a whole: ``synthesize_streaming`` of the port against the JAX
package's on the synthetic bundle, in f32 on the CPU, greedy (top_k=1,
temperature 1, top_p 1, repetition penalty 1), ``gen_cap_tokens_per_code =
1.0``. Same audio length; waveform within atol 1e-3 (both sides run the same
f32 arithmetic over the same static shapes; the sums run in other orders)."""

import dataclasses

import numpy as np
import pytest
import torch

from genvc_tpu.decode.engine import SamplerConfig as JSampler
from genvc_tpu_torch.decode.engine import SamplerConfig as TSampler
from genvc_tpu_torch.inference import pipeline as tpipe

GREEDY = dict(temperature=1.0, top_k=1, top_p=1.0, repetition_penalty=1.0,
              do_sample=False)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    from synthetic_bundle import write_bundle

    path = str(tmp_path_factory.mktemp("bundle") / "tiny_genvc.pth")
    write_bundle(path)
    return path


@pytest.fixture(scope="module")
def pipes(bundle):
    from genvc_tpu.inference.pipeline import model_init as jax_init

    jp = jax_init(bundle)
    jp.sampler = JSampler(**GREEDY)
    jp._build_jits()
    jp.gen_cap_tokens_per_code = 1.0
    tp = tpipe.model_init(bundle, device="cpu")
    tp.sampler = TSampler(**GREEDY)
    tp.gen_cap_tokens_per_code = 1.0
    return jp, tp


@pytest.mark.parametrize("seconds", [1.5, 7.0])
def test_torch_streaming_matches_jax(pipes, seconds):
    jp, tp = pipes
    rng = np.random.default_rng(int(seconds * 10))
    src = (rng.standard_normal((1, int(16000 * seconds))) * 0.1).astype(np.float32)
    ref = (rng.standard_normal((1, 24000 * 2)) * 0.1).astype(np.float32)
    want, _, _ = jp.synthesize_streaming(src, ref, verbose=False)
    got, latency, rtf = tp.synthesize_streaming(src, ref, verbose=False)
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert latency > 0 and rtf > 0


def test_torch_streaming_first_window_of_8_matches_jax(pipes):
    """``first_chunk_tokens = 8`` (the reference's cadence from the first
    window on) on both sides: same length, atol 1e-3."""
    jp, tp = pipes
    rng = np.random.default_rng(9)
    src = (rng.standard_normal((1, 24000)) * 0.1).astype(np.float32)
    ref = (rng.standard_normal((1, 24000)) * 0.1).astype(np.float32)
    assert tp.first_chunk_tokens == jp.first_chunk_tokens == 4
    try:
        jp.first_chunk_tokens = tp.first_chunk_tokens = 8
        want, _, _ = jp.synthesize_streaming(src, ref, verbose=False)
        got, _, _ = tp.synthesize_streaming(src, ref, verbose=False)
    finally:
        jp.first_chunk_tokens = tp.first_chunk_tokens = 4
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert tp.last_timing["decode_steps"] % 8 == 7  # 7 steps, then windows of 8


def test_torch_streaming_eos_on_prefill_token(pipes):
    """A stop token sampled at prefill vocodes only its latent (1024 samples,
    all held back for the crossfade), as the JAX pipeline does."""
    jp, tp = pipes
    stop = tp.gpt_cfg.stop_audio_token
    jb = jp.gpt_params["mel_head"]["b"]
    tb = tp.gpt.mel_head.b.clone()
    jp.gpt_params["mel_head"]["b"] = jb.at[stop].set(1e4)
    tp.gpt.mel_head.b[stop] = 1e4
    try:
        rng = np.random.default_rng(3)
        src = (rng.standard_normal((1, 16000)) * 0.1).astype(np.float32)
        ref = (rng.standard_normal((1, 24000)) * 0.1).astype(np.float32)
        want, _, _ = jp.synthesize_streaming(src, ref, verbose=False)
        got, latency, _ = tp.synthesize_streaming(src, ref, verbose=False)
    finally:
        jp.gpt_params["mel_head"]["b"] = jb
        tp.gpt.mel_head.b.copy_(tb)
    assert got.shape == want.shape
    assert tp.last_timing["decode_steps"] == 3 and latency is not None


def test_torch_bf16_and_fp8_cache_run(bundle):
    """bf16 GPT with a bf16 and an e4m3 KV cache (the kernel's plain version
    on the CPU): finite audio in [-1, 1] of whole windows."""
    rng = np.random.default_rng(4)
    src = (rng.standard_normal((1, 16000)) * 0.1).astype(np.float32)
    ref = (rng.standard_normal((1, 24000)) * 0.1).astype(np.float32)
    for kv in (None, "fp8"):
        pipe = tpipe.model_init(bundle, device="cpu", dtype=torch.bfloat16,
                                kv_cache_dtype=kv)
        pipe.gen_cap_tokens_per_code = 1.0
        assert pipe.gpt.final_norm.scale.dtype == torch.float32
        assert pipe.gpt.core.blocks[0].attn.c_attn.w.dtype == torch.bfloat16
        assert pipe.hifigan.conv_pre.w.dtype == torch.float32
        wav, _, _ = pipe.synthesize_streaming(src, ref, verbose=False)
        assert wav.size > 0 and np.isfinite(wav).all() and np.abs(wav).max() <= 1.0


def test_torch_load_jax_tree_matches_own_loader(bundle, pipes):
    from genvc_tpu import checkpoint as jckpt
    from genvc_tpu.config import GenVCConfig as JConfig
    from genvc_tpu_torch.checkpoint import load_jax_tree
    from genvc_tpu_torch.config import GenVCConfig

    _, tp = pipes
    tree = jckpt.convert_bundle(bundle)
    assert dataclasses.asdict(GenVCConfig.from_dict(tree["config"])) == \
        dataclasses.asdict(JConfig.from_dict(tree["config"]))
    mods = load_jax_tree(tree, GenVCConfig.from_dict(tree["config"]), "cpu")
    for name, own in (("gpt", tp.gpt), ("hifigan", tp.hifigan),
                      ("content_dvae", tp.content_dvae), ("contentvec", tp.contentvec)):
        a, b = getattr(mods, name).state_dict(), own.state_dict()
        assert a.keys() == b.keys() and len(a) > 0
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_torch_cuda_request_without_card_raises(bundle, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.model_init(bundle, device="cuda")


def test_torch_window_accounting_matches_jax():
    from genvc_tpu.inference.pipeline import window_accounting as jwa

    stop = 1025
    cases = [([5, 9, 12, stop, 7, 7, 7, 7], 1, 602, 1, 8),
             ([7] * 8, 1, 602, 1, 8), ([7] * 8, 8, 16, 1, 8),
             ([7] * 8, 16, 16, 1, 8), ([7] * 15 + [stop], 9, 602, 0, 8),
             ([7, 7, 7], 1, 602, 1, 4), ([stop, 7, 7], 1, 602, 1, 4)]
    for toks, n_total, max_new, carry, win in cases:
        assert tpipe.window_accounting(toks, n_total, max_new, stop, carry, win) == \
            jwa(toks, n_total, max_new, stop, carry, win)


def test_torch_cache_geometry_matches_jax(pipes):
    """KV-cache length as the JAX pipeline sizes it (T = 384 at the flagship's
    1.875 cap; here the synthetic bundle at cap 1.0)."""
    from genvc_tpu.decode import engine as jeng
    from genvc_tpu_torch.decode import engine as teng

    jp, tp = pipes
    jp._cache_gen_traced = "unset"
    t_jax = jeng.cache_size(jp.gpt_cfg, jp._prefix_width, jp._cache_gen_tokens())
    t_port = teng.cache_size(tp.gpt_cfg, tp._prefix_width, tp._cache_gen_tokens())
    assert t_port == t_jax
    flag = dataclasses.replace(tp.gpt_cfg, layers=30, model_dim=1024)
    cap = tp.gen_cap_tokens_per_code
    try:
        tp.gen_cap_tokens_per_code = 1.875
        assert teng.cache_size(flag, tp._prefix_width, tp._cache_gen_tokens()) == 384
    finally:
        tp.gen_cap_tokens_per_code = cap


def test_torch_infer_cli_writes_audio(bundle, tmp_path):
    from genvc_tpu_torch import infer
    from genvc_tpu_torch.dsp.audio_io import read_wav, write_wav

    rng = np.random.default_rng(6)
    src, ref, out = (str(tmp_path / n) for n in ("src.wav", "ref.wav", "out.wav"))
    write_wav(src, (rng.standard_normal(24000) * 0.1).astype(np.float32), 24000)
    write_wav(ref, (rng.standard_normal(24000) * 0.1).astype(np.float32), 24000)
    rc = infer.main(["--model_path", bundle, "--src_wav", src, "--ref_audio", ref,
                     "--output_path", out, "--streaming", "--top_k", "1",
                     "--device", "cpu"])
    assert rc == 0
    audio, sr = read_wav(out)
    assert sr == 24000 and audio.shape[1] > 0


def _utterances(seed, seconds):
    """Sources of the given lengths and references of 1, 2, ... seconds."""
    rng = np.random.default_rng(seed)
    srcs = [(rng.standard_normal((1, int(16000 * s))) * 0.1).astype(np.float32)
            for s in seconds]
    refs = [(rng.standard_normal((1, 24000 * (i + 1))) * 0.1).astype(np.float32)
            for i in range(len(seconds))]
    return srcs, refs


@pytest.mark.parametrize("seconds", [1.5, 7.0])
def test_torch_synthesize_matches_jax(pipes, seconds):
    """Offline conversion (decode_all, the latent pass, one masked vocoder
    call): same length, waveform within atol 1e-3."""
    jp, tp = pipes
    (src,), (ref,) = _utterances(int(seconds * 10) + 1, [seconds])
    want = jp.synthesize(src, ref)
    got = tp.synthesize(src, ref)
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert tp.last_timing["latent_passes"] == (2 if seconds > 6 else 1)
    assert tp.last_timing["decode_steps"] > 0


def test_torch_synthesize_batch_matches_jax(pipes):
    """Three utterances of 1.5, 7 and 3 s: two lockstep rounds, the second
    with two rows riding along inactive. Per row: same length, atol 1e-3."""
    jp, tp = pipes
    srcs, refs = _utterances(21, [1.5, 7.0, 3.0])
    want = jp.synthesize_batch(srcs, refs)
    got = tp.synthesize_batch(srcs, refs)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.size > 0
        np.testing.assert_allclose(g, w, atol=1e-3)
    assert tp.last_timing["latent_passes"] == 2


def test_torch_synthesize_streaming_batch_matches_jax(pipes):
    """Two streams of 1.5 and 7 s in lockstep: per-row EOS / cap and
    crossfade; per row the same length and waveform within atol 1e-3."""
    jp, tp = pipes
    srcs, refs = _utterances(22, [1.5, 7.0])
    want, _, _ = jp.synthesize_streaming_batch(srcs, refs, verbose=False)
    got, latencies, rtf = tp.synthesize_streaming_batch(srcs, refs, verbose=False)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.size > 0
        np.testing.assert_allclose(g, w, atol=1e-3)
    assert all(v is not None and v > 0 for v in latencies) and rtf > 0


SEARCH_MODES = [{"num_beams": 2}, {"num_beams": 4, "num_beam_groups": 2},
                {"penalty_alpha": 0.6}]


@pytest.mark.parametrize("mode", SEARCH_MODES, ids=["beam", "group_beam", "contrastive"])
def test_torch_synthesize_search_modes_match_jax(pipes, mode):
    """Offline conversion through beam, group beam and contrastive search
    (one segment): same length as the JAX package's, waveform within atol
    1e-3; the latent pass ran once and ``decode_steps`` counts forwards."""
    jp, tp = pipes
    (src,), (ref,) = _utterances(11, [1.5])
    want = jp.synthesize(src, ref, **mode)
    got = tp.synthesize(src, ref, **mode)
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert tp.last_timing["latent_passes"] == 1
    assert 0 < tp.last_timing["decode_steps"] <= tp._max_new(tp._host_n_codes(24000))


def test_torch_offline_search_modes_run(pipes):
    """``synthesize`` with ``num_beams=2`` and with ``penalty_alpha=0.6`` (and
    beam_sample) returns finite audio; group beam search with
    ``beam_do_sample`` raises, as in the JAX package."""
    _, tp = pipes
    (src,), (ref,) = _utterances(23, [1.0])
    for kw in ({"num_beams": 2}, {"penalty_alpha": 0.6},
               {"num_beams": 2, "beam_do_sample": True}):
        wav = tp.synthesize(src, ref, **kw)
        assert wav.ndim == 1 and wav.size > 0 and np.isfinite(wav).all()
    with pytest.raises(ValueError, match="deterministic"):
        tp.synthesize(src, ref, num_beams=4, num_beam_groups=2, beam_do_sample=True)


def test_torch_infer_cli_offline_and_batch(bundle, tmp_path):
    """The CLI without --streaming (offline, the default) and with
    --src_wavs (batch, offline and streamed) writes 24 kHz audio."""
    from genvc_tpu_torch import infer
    from genvc_tpu_torch.dsp.audio_io import read_wav, write_wav

    rng = np.random.default_rng(7)
    paths = {n: str(tmp_path / f"{n}.wav") for n in ("src", "src2", "ref")}
    for n, sec in (("src", 1.0), ("src2", 2.0), ("ref", 1.0)):
        write_wav(paths[n], (rng.standard_normal(int(24000 * sec)) * 0.1).astype(np.float32),
                  24000)
    common = ["--model_path", bundle, "--top_k", "1", "--device", "cpu"]
    out = str(tmp_path / "out.wav")
    assert infer.main(common + ["--src_wav", paths["src"], "--ref_audio", paths["ref"],
                                "--output_path", out]) == 0
    outs = [out]
    stem = str(tmp_path / "batch.wav")
    assert infer.main(common + ["--src_wavs", paths["src"], paths["src2"],
                                "--ref_audios", paths["ref"], "--output_path", stem]) == 0
    outs += [str(tmp_path / "batch_0.wav"), str(tmp_path / "batch_1.wav")]
    streamed = [str(tmp_path / "s0.wav"), str(tmp_path / "s1.wav")]
    assert infer.main(common + ["--src_wavs", paths["src"], paths["src2"], "--streaming",
                                "--ref_audios", paths["ref"], paths["ref"],
                                "--output_paths", *streamed]) == 0
    for path in outs + streamed:
        audio, sr = read_wav(path)
        assert sr == 24000 and audio.shape[1] > 0


@pytest.mark.parametrize("flags", [["--num_beams", "2"],
                                   ["--num_beams", "4", "--num_beam_groups", "2"],
                                   ["--penalty_alpha", "0.6"]],
                         ids=["beam", "group_beam", "contrastive"])
def test_torch_infer_cli_search_modes(bundle, tmp_path, flags):
    """The CLI's offline search flags write 24 kHz audio."""
    from genvc_tpu_torch import infer
    from genvc_tpu_torch.dsp.audio_io import read_wav, write_wav

    rng = np.random.default_rng(9)
    src, ref, out = (str(tmp_path / n) for n in ("src.wav", "ref.wav", "out.wav"))
    write_wav(src, (rng.standard_normal(24000) * 0.1).astype(np.float32), 24000)
    write_wav(ref, (rng.standard_normal(24000) * 0.1).astype(np.float32), 24000)
    assert infer.main(["--model_path", bundle, "--src_wav", src, "--ref_audio", ref,
                       "--output_path", out, "--top_k", "1", "--device", "cpu"] + flags) == 0
    audio, sr = read_wav(out)
    assert sr == 24000 and audio.shape[1] > 0


@pytest.mark.parametrize("flags,item", [(["--serve", "4"], "A11")])  # needs --src_wavs --streaming
def test_torch_infer_cli_refuses_modes_not_ported(flags, item, capsys):
    from genvc_tpu_torch import infer

    assert infer.main(flags) == 2
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("mode", ["offline", "streaming", "batch", "serve"])
def test_torch_infer_cli_quantized(bundle, tmp_path, mode):
    """``--quantize int8 --kv_cache fp8`` (the quantized serving
    configuration) converts offline, streamed, as a batch and through the
    StreamServer, and writes 24 kHz audio."""
    from genvc_tpu_torch import infer
    from genvc_tpu_torch.dsp.audio_io import read_wav, write_wav

    rng = np.random.default_rng(10)
    src, src2, ref = (str(tmp_path / f"{n}.wav") for n in ("src", "src2", "ref"))
    for path in (src, src2, ref):
        write_wav(path, (rng.standard_normal(24000) * 0.1).astype(np.float32), 24000)
    args = ["--model_path", bundle, "--ref_audio", ref, "--top_k", "1", "--device", "cpu",
            "--quantize", "int8", "--kv_cache", "fp8"]
    out = str(tmp_path / "out.wav")
    if mode in ("offline", "streaming"):
        args += ["--src_wav", src, "--output_path", out]
        outs = [out]
    else:
        outs = [str(tmp_path / "out_0.wav"), str(tmp_path / "out_1.wav")]
        args += ["--src_wavs", src, src2, "--output_path", out]
    args += {"offline": [], "streaming": ["--streaming"], "batch": [],
             "serve": ["--streaming", "--serve", "2"]}[mode]
    assert infer.main(args) == 0
    for path in outs:
        audio, sr = read_wav(path)
        assert sr == 24000 and audio.shape[1] > 0 and np.isfinite(audio).all()


def test_torch_infer_cli_serve(bundle, tmp_path, capsys):
    """``--src_wavs a b --streaming --serve 2``: both outputs through the
    StreamServer, with per-stream latency / RTF and the pool line."""
    from genvc_tpu_torch import infer
    from genvc_tpu_torch.dsp.audio_io import read_wav, write_wav

    rng = np.random.default_rng(8)
    paths = [str(tmp_path / f"{n}.wav") for n in ("a", "b", "ref")]
    for path, sec in zip(paths, (1.0, 2.0, 1.0)):
        write_wav(path, (rng.standard_normal(int(24000 * sec)) * 0.1).astype(np.float32),
                  24000)
    outs = [str(tmp_path / "a_out.wav"), str(tmp_path / "b_out.wav")]
    assert infer.main(["--model_path", bundle, "--top_k", "1", "--device", "cpu",
                       "--src_wavs", paths[0], paths[1], "--ref_audios", paths[2],
                       "--streaming", "--serve", "2", "--output_paths", *outs]) == 0
    printed = capsys.readouterr().out
    assert "stream 0: latency" in printed and "stream 1: latency" in printed
    assert "pool:" in printed and "2 completed" in printed
    for path in outs:
        audio, sr = read_wav(path)
        assert sr == 24000 and audio.shape[1] > 0
