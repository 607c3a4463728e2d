"""The sharded ``StreamServer`` and fault C.7, on the synthetic bundle in f32
on the CPU, greedy.

* ``StreamServer(mesh=make_mesh(n_data=2, devices=[cpu, cpu]))``: a pool
  of 2 slots in 2 shards of 1 row (one device named twice, which JAX's mesh
  refuses: a stated deviation) gives each stream the unsharded 4-slot
  server's audio within 2e-4, as ``tests/test_multichip.py`` holds JAX's;
* C.7: streaming on a bundle whose GPT has 64 mel tokens (a 67-row
  position table) with weights that never emit the stop token steps its
  last window past the generation cap; the positions clamp, as JAX's
  gather does, and the tokens equal the JAX pipeline's, the audio within
  1e-3 (the streaming holds of ``test_torch_pipeline.py``).
"""

import numpy as np
import pytest
import torch

from genvc_tpu.decode.engine import SamplerConfig as JSampler
from genvc_tpu_torch.decode import engine as tengine
from genvc_tpu_torch.decode.engine import SamplerConfig as TSampler
from genvc_tpu_torch.inference import pipeline as tpipe
from genvc_tpu_torch.parallel.mesh import make_mesh
from genvc_tpu_torch.serving.server import StreamServer

GREEDY = dict(temperature=1.0, top_k=1, top_p=1.0, repetition_penalty=1.0, do_sample=False)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    from synthetic_bundle import write_bundle

    return write_bundle(str(tmp_path_factory.mktemp("bundle") / "tiny_genvc.pth"))


def test_torch_sharded_server_matches_unsharded(bundle):
    tp = tpipe.model_init(bundle, device="cpu")
    tp.sampler = TSampler(**GREEDY)
    tp.gen_cap_tokens_per_code = 1.0
    tp.first_chunk_tokens = 8
    rng = np.random.default_rng(41)
    srcs = [(rng.standard_normal((1, n)) * 0.1).astype(np.float32) for n in (16000, 12000)]
    refs = [(rng.standard_normal((1, 24000)) * 0.1).astype(np.float32) for _ in range(2)]

    plain = StreamServer(tp, slots=4)
    sids = [plain.submit(s, r) for s, r in zip(srcs, refs)]
    plain.drain()
    want = [plain.result(sid)[0] for sid in sids]

    sharded = StreamServer(tp, slots=2, mesh=make_mesh(n_data=2, devices=["cpu", "cpu"]))
    assert [len(sh.carry) for sh in sharded._shards] == [1, 1]
    assert sharded._shards[0].pipe is sharded._shards[1].pipe is tp  # weights shared
    sids = [sharded.submit(s, r) for s, r in zip(srcs, refs)]
    sharded.drain()
    for sid, w in zip(sids, want):
        got, _ = sharded.result(sid)
        assert got.shape == w.shape and got.size > 0
        np.testing.assert_allclose(got, w, atol=2e-4)
    m = sharded.metrics()
    assert m["completed"] == 2 and m["decode_steps"] > 0
    assert all(int(sh.pool.n_generated.max()) > 0 for sh in sharded._shards)  # both ran
    with pytest.raises(ValueError, match="divide"):
        StreamServer(tp, slots=3, mesh=make_mesh(n_data=2, devices=["cpu", "cpu"]))


@pytest.mark.cuda
def test_torch_sharded_server_shares_the_pipes_card(bundle):
    """A pipe built on ``cuda`` (no index) and a mesh naming ``cuda:0``
    twice: both shards use the pipe itself, with no second copy of the
    weights and the pipe's generator."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tp = tpipe.model_init(bundle, device="cuda")
    card = f"cuda:{torch.cuda.current_device()}"
    server = StreamServer(tp, slots=2, mesh=make_mesh(n_data=2, devices=[card, card]))
    assert server._shards[0].pipe is server._shards[1].pipe is tp


def _capped_bundle(bundle, path):
    """The synthetic bundle with 64 mel tokens: ``gpt_max_audio_tokens`` 64
    and the position table cut to its 67 rows."""
    ck = torch.load(bundle, weights_only=False)
    ck["config"]["model_args"]["gpt_max_audio_tokens"] = 64
    key = "gpt.mel_pos_embedding.emb.weight"
    ck["model"][key] = ck["model"][key][:67].clone()
    torch.save(ck, path)
    return path


def test_torch_streaming_past_the_cap_matches_jax(bundle, tmp_path, monkeypatch):
    """Fault C.7 repaired: 2 s of source give 100 content codes, so the cap
    (61 tokens) ends decoding; the windows of 8 after the first of 4 step to
    position 67 of a 67-row table before the window accounting stops them."""
    from genvc_tpu.inference.pipeline import model_init as jax_init

    path = _capped_bundle(bundle, str(tmp_path / "capped.pth"))
    rng = np.random.default_rng(7)
    src = (rng.standard_normal((1, 32000)) * 0.1).astype(np.float32)
    ref = (rng.standard_normal((1, 24000)) * 0.1).astype(np.float32)

    ttoks = []
    decode_chunk = tengine.decode_chunk

    def recording(*a, **kw):
        out = decode_chunk(*a, **kw)
        ttoks.append(out[0].numpy())
        return out

    monkeypatch.setattr(tengine, "decode_chunk", recording)
    tp = tpipe.model_init(path, device="cpu")
    tp.sampler = TSampler(**GREEDY)
    assert tp.gpt.mel_pos.shape[0] == 67 and tp.gpt_cfg.max_gen_mel_tokens == 61
    got, _, _ = tp.synthesize_streaming(src, ref, verbose=False)
    assert tp.last_timing["decode_steps"] == 67  # past the table's last row, 66

    jp = jax_init(path)
    jp.sampler = JSampler(**GREEDY)
    jp._build_jits()
    jtoks = []
    for name, idx in (("_first_audio_fn", 3), ("_stream_chunk_fn", 1)):
        fn = getattr(jp, name)

        def wrapped(*a, _fn=fn, _idx=idx, **kw):
            out = _fn(*a, **kw)
            jtoks.append(np.asarray(out[_idx]))
            return out

        setattr(jp, name, wrapped)
    want, _, _ = jp.synthesize_streaming(src, ref, verbose=False)
    np.testing.assert_array_equal(np.concatenate(ttoks, axis=1), np.concatenate(jtoks, axis=1))
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=1e-3)
