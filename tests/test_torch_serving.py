"""The port's continuous-batching ``StreamServer`` on the CPU with the
synthetic bundle in f32, greedy, ``gen_cap_tokens_per_code = 1.0``.

First against the JAX package's ``StreamServer`` on the same bundle: per
stream the same audio length and the waveform within atol 1e-3 (the same f32
arithmetic over the same static shapes; sums run in other orders), with a
stream arriving mid-flight, first windows of 8 and 4 tokens, and a source of
several segments. Then the behaviour of JAX ``tests/test_serving.py``
against the port's own ``synthesize_streaming`` (within 2e-4, as there):
callbacks, cancel, per-stream samplers, a soak whose idle slots run past the
cache end, metrics, ``QueueFull``, the batched admission wave after an
untouching ``warmup_admission``, and the FIFO order of a spilled-back wave.
"""

import numpy as np
import pytest
import torch

from genvc_tpu.decode.engine import SamplerConfig as JSampler
from genvc_tpu_torch.decode.engine import SamplerConfig as TSampler
from genvc_tpu_torch.inference import pipeline as tpipe
from genvc_tpu_torch.serving.server import QueueFull, StreamServer

GREEDY = dict(temperature=1.0, top_k=1, top_p=1.0, repetition_penalty=1.0,
              do_sample=False)
SAMPLED = TSampler(temperature=0.8, top_k=5, top_p=0.9, repetition_penalty=2.0,
                   do_sample=True)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    from synthetic_bundle import write_bundle

    path = str(tmp_path_factory.mktemp("bundle") / "tiny_genvc.pth")
    write_bundle(path)
    return path


@pytest.fixture(scope="module")
def tp(bundle):
    p = tpipe.model_init(bundle, device="cpu")
    p.sampler = TSampler(**GREEDY)
    p.gen_cap_tokens_per_code = 1.0
    p.first_chunk_tokens = 8  # the 8-token reference cadence unless a test sets 4
    return p


@pytest.fixture(scope="module")
def jp(bundle):
    from genvc_tpu.inference.pipeline import model_init

    p = model_init(bundle)
    p.sampler = JSampler(**GREEDY)
    p.gen_cap_tokens_per_code = 1.0
    p.first_chunk_tokens = 8
    p._build_jits()
    return p


def _audio(seed, lengths):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((1, n)) * 0.1).astype(np.float32) for n in lengths]


def _serve(server_cls, pipe, srcs, refs, first_window):
    """Two streams admitted at the start of a 2-slot pool, the rest
    submitted after the first step (mid-flight)."""
    server = server_cls(pipe, slots=2, first_window=first_window)
    sids = [server.submit(s, r) for s, r in zip(srcs[:2], refs[:2])]
    assert server.step()
    sids += [server.submit(s, r) for s, r in zip(srcs[2:], refs[2:])]
    server.drain()
    return [server.result(sid)[0] for sid in sids], server


@pytest.mark.parametrize("first_window", [8, 4])
def test_torch_server_matches_jax_server(jp, tp, first_window):
    """2 slots, 3 streams, the third arriving mid-flight."""
    from genvc_tpu.serving.server import StreamServer as JServer

    srcs = _audio(23, (16000, 24000, 9000))
    refs = _audio(24, (24000, 30000, 24000))
    want, _ = _serve(JServer, jp, srcs, refs, first_window)
    got, server = _serve(StreamServer, tp, srcs, refs, first_window)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.size > 0
        np.testing.assert_allclose(g, w, atol=1e-3)
    m = server.metrics()
    assert m["completed"] == 3 and m["decode_steps"] >= 8 * m["ticks"]


def test_torch_server_multi_segment_matches_jax_server(jp, tp):
    """A 6.25 s source advances to its second segment inside its slot, beside
    a short stream, with the fast-first admission window."""
    from genvc_tpu.serving.server import StreamServer as JServer

    srcs = _audio(29, (100000, 9000))
    refs = _audio(30, (24000, 24000))
    want, _ = _serve(JServer, jp, srcs, refs, 4)
    got, _ = _serve(StreamServer, tp, srcs, refs, 4)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.size > 0
        np.testing.assert_allclose(g, w, atol=1e-3)


def _single(tp, src, ref):
    return tp.synthesize_streaming(src, ref, verbose=False)[0]


def test_torch_on_chunk_callback_delivers_stream(tp):
    """on_chunk delivers exactly the chunks of the final wav, in order; a
    raising callback is disabled and recorded, and synthesis goes on."""
    src, ref = _audio(31, (16000, 24000))
    got_chunks = []

    def bad_cb(sid, chunk):
        raise RuntimeError("client went away")

    server = StreamServer(tp, slots=2)
    sid_ok = server.submit(src, ref, on_chunk=lambda sid, c: got_chunks.append((sid, c)))
    sid_bad = server.submit(src, ref, on_chunk=bad_cb)
    server.drain()
    wav_ok, stats_ok = server.result(sid_ok)
    assert stats_ok["callback_error"] is None and all(s == sid_ok for s, _ in got_chunks)
    np.testing.assert_array_equal(np.concatenate([c for _, c in got_chunks]), wav_ok)
    wav_bad, stats_bad = server.result(sid_bad)
    assert "RuntimeError" in stats_bad["callback_error"]
    assert wav_bad.shape == wav_ok.shape
    np.testing.assert_allclose(wav_ok, _single(tp, src, ref), atol=2e-4)


def test_torch_cancel_stream(tp):
    """Cancel while queued finalizes empty; cancel while active frees the
    slot and keeps the audio so far; the other stream is untouched; cancel
    of a finished stream does nothing."""
    src_a, src_b, src_c, ref = _audio(37, (24000, 24000, 9000, 24000))
    server = StreamServer(tp, slots=2)
    sid_a, sid_b, sid_c = (server.submit(s, ref) for s in (src_a, src_b, src_c))
    server.cancel(sid_c)
    server.step()
    server.cancel(sid_a)
    server.drain()
    wav_c, stats_c = server.result(sid_c)
    assert stats_c["cancelled"] and wav_c.shape == (0,)
    assert server.result(sid_a)[1]["cancelled"]
    wav_b, stats_b = server.result(sid_b)
    assert not stats_b["cancelled"]
    np.testing.assert_allclose(wav_b, _single(tp, src_b, ref), atol=2e-4)
    server.cancel(sid_b)
    assert not server.result(sid_b)[1]["cancelled"]


def test_torch_per_stream_sampler(tp):
    """A greedy stream beside a sampled one (the per-row sampling chain in
    the shared tick) still equals its standalone greedy run."""
    src_a, src_b, ref = _audio(43, (16000, 16000, 24000))
    server = StreamServer(tp, slots=2)
    sid_a = server.submit(src_a, ref)
    sid_b = server.submit(src_b, ref, sampler=SAMPLED)
    server.drain()
    np.testing.assert_allclose(server.result(sid_a)[0], _single(tp, src_a, ref), atol=2e-4)
    wav_b = server.result(sid_b)[0]
    assert wav_b.size > 0 and np.isfinite(wav_b).all() and np.abs(wav_b).max() <= 1.0


def test_torch_server_soak(tp):
    """24 streams of 0.25-0.75 s through 4 slots, then one of 12.5 s (three
    segments): slot reuse, epochs, queue waits; no slot leaks, every stream
    equals its single-stream run, and while the long stream runs alone the
    idle slots tick past the cache end."""
    srcs = _audio(77, [[4000, 8000, 12000][i % 3] for i in range(24)] + [200000])
    (ref,) = _audio(78, (24000,))
    server = StreamServer(tp, slots=4)
    sids = [server.submit(s, ref) for s in srcs]
    server.drain()
    assert len(server._free) == server.slots and not server._queue and not server._slot_map
    pool = server._shards[0].pool
    assert int(pool.cur_index.max()) > pool.cache_k.shape[3]
    for sid, src in zip(sids, srcs):
        wav, stats = server.pop_result(sid)
        assert stats["latency_s"] >= 0
        want = _single(tp, src, ref)
        assert wav.shape == want.shape
        np.testing.assert_allclose(wav, want, atol=2e-4)
    assert not server._results


def test_torch_server_metrics(tp):
    ref, *srcs = _audio(88, (24000,) + (6000,) * 5)
    server = StreamServer(tp, slots=2)
    m0 = server.metrics()
    assert m0["ticks"] == 0 and m0["admissions"] == 0 and m0["decode_steps"] == 0
    sids = [server.submit(s, ref) for s in srcs]
    server.cancel(sids[-1])
    server.drain()
    m = server.metrics()
    assert m["admissions"] >= 4 and m["completed"] == 5 and m["cancelled"] == 1
    assert m["queued"] == 0 and m["active"] == 0 and m["pending_results"] == 5
    assert m["ticks"] > 0 and 0 < m["mean_occupancy"] <= 2
    assert m["decode_steps"] == 8 * m["ticks"]  # first window 8: no admission steps


def test_torch_server_max_queue_backpressure(tp):
    ref, src = _audio(97, (24000, 6000))
    server = StreamServer(tp, slots=1, max_queue=2)
    sids = [server.submit(src, ref) for _ in range(2)]
    with pytest.raises(QueueFull):
        server.submit(src, ref)
    assert server.metrics()["rejected"] == 1
    server.step()  # admits one stream, freeing queue space
    sids.append(server.submit(src, ref))
    server.drain()
    for sid in sids:
        wav, stats = server.result(sid)
        assert wav.shape[-1] > 0 and not stats["cancelled"]
    m = server.metrics()
    assert m["completed"] == 3 and m["rejected"] == 1 and m["queued"] == 0


def _pool_state(server):
    (shard,) = server._shards
    p = shard.pool
    return [x.clone() for x in (p.cache_k, p.cache_v, p.key_valid, p.cur_index,
                                p.n_generated, p.last_token, p.seen, p.finished,
                                shard.carry, *shard.row_params.values())]


@pytest.mark.parametrize("first_window", [8, 4])
def test_torch_batched_admission_wave(tp, first_window):
    """Four streams of different lengths admitted as one wave into four free
    slots, after a ``warmup_admission`` that leaves the pool bit-identical;
    each equals its single-stream run. Then a wave with one custom sampler
    among greedy streams."""
    srcs = _audio(51, (16000, 9000, 24000, 6000))
    refs = _audio(52, (24000, 30000, 24000, 24000))
    old = tp.first_chunk_tokens
    try:
        tp.first_chunk_tokens = first_window
        singles = [_single(tp, s, r) for s, r in zip(srcs, refs)]
        server = StreamServer(tp, slots=4, adm_batch=4)
        assert server._adm_buckets == (1, 2, 4) and server.first_window == first_window
        before = _pool_state(server)
        server.warmup_admission()
        for a, b in zip(before, _pool_state(server)):
            assert torch.equal(a, b)
        sids = [server.submit(s, r) for s, r in zip(srcs, refs)]
        server.drain()
        assert server.metrics()["admissions"] == 4
        for sid, want in zip(sids, singles):
            got = server.result(sid)[0]
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=2e-4)

        server = StreamServer(tp, slots=4, adm_batch=4)
        sid_g = server.submit(srcs[0], refs[0])
        sid_s = server.submit(srcs[1], refs[1], sampler=SAMPLED)
        sid_g2 = server.submit(srcs[2], refs[2])
        server.drain()
        for sid, want in ((sid_g, singles[0]), (sid_g2, singles[2])):
            np.testing.assert_allclose(server.result(sid)[0], want, atol=2e-4)
        wav_s = server.result(sid_s)[0]
        assert wav_s.size > 0 and np.isfinite(wav_s).all()
    finally:
        tp.first_chunk_tokens = old


def test_torch_admission_spillback_order(tp):
    """Waves larger than the largest bucket spill back to the queue head:
    admission stays FIFO and every stream's audio is right."""
    *srcs, ref = _audio(52, [6000 + 2000 * i for i in range(6)] + [24000])
    server = StreamServer(tp, slots=3, adm_batch=2)
    assert server._adm_buckets == (1, 2)
    sids = [server.submit(s, ref) for s in srcs]
    server.drain()
    waits = []
    for sid, src in zip(sids, srcs):
        wav, stats = server.result(sid)
        np.testing.assert_allclose(wav, _single(tp, src, ref), atol=2e-4)
        waits.append(stats["queue_wait_s"])
    assert all(a <= b + 1e-6 for a, b in zip(waits, waits[3:]))


def test_torch_server_zero_length_source_and_mesh(tp):
    """A zero-length source retires at once with empty audio; ``mesh=``
    (sharding the pool) refuses a slot count its first axis does not divide,
    as the JAX server does (tests/test_torch_parallel_serving.py runs it)."""
    from genvc_tpu_torch.parallel.mesh import make_mesh

    (ref,) = _audio(5, (24000,))
    server = StreamServer(tp, slots=2)
    sid = server.submit(np.zeros((1, 0), np.float32), ref)
    assert server.finished(sid) and server.result(sid)[0].shape == (0,)
    assert not server.step()
    with pytest.raises(ValueError, match="divide"):
        StreamServer(tp, slots=3, mesh=make_mesh(n_data=2, devices=["cpu", "cpu"]))
