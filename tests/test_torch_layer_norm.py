"""LayerNorm of the port (``genvc_tpu_torch/ops/nn.py``): the plain PyTorch
ops that CPU tensors take, the hand-written kernel (``csrc/layer_norm.cu``)
that CUDA tensors take, and the rule of what the kernel takes.

The CPU cases hold the rule, the plain path's arithmetic, its gradients and
the kernel's backward (PyTorch ops). The ``cuda`` cases skip without a card;
the file imports no JAX, so on the card it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_layer_norm.py -q
"""

import numpy as np
import pytest
import torch

from genvc_tpu_torch import _build, tracing
from genvc_tpu_torch.ops import nn as tnn

WIDTHS = (512, 768, 1024)
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _seed_layer_norm(x, scale, bias, eps=1e-5):
    """The port's LayerNorm as it stood before the kernel, op for op."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def _inputs(rows, d, x_dtype, p_dtype, device="cpu", seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(rows, d, generator=g, device=device) * 3 + 0.5).to(x_dtype)
    scale = (1 + 0.1 * torch.randn(d, generator=g, device=device)).to(p_dtype)
    bias = (0.1 * torch.randn(d, generator=g, device=device)).to(p_dtype)
    return x, scale, bias


_KERNEL_LN = tnn.layer_norm  # the wrapper, whatever a test patches in its place


class _Launches:
    """The kernel's launches in the block (``layer_norm.launches``)."""

    def __enter__(self):
        self._before = _KERNEL_LN.launches
        return self

    def __exit__(self, *exc):
        self.n = _KERNEL_LN.launches - self._before
        return False


# ---- CPU: the rule, the plain path, the backward


@pytest.mark.parametrize("x_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("p_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("shape", [(1, 1024), (7, 768), (2, 3, 512)])
def test_layer_norm_cpu_is_the_plain_path_bit_for_bit(x_dtype, p_dtype, shape):
    x, scale, bias = _inputs(int(np.prod(shape[:-1])), shape[-1], DTYPES[x_dtype],
                             DTYPES[p_dtype])
    x = x.reshape(shape)
    want = _seed_layer_norm(x, scale, bias)
    assert torch.equal(tnn.layer_norm_plain(x, scale, bias), want)
    got = tnn.layer_norm(x, scale, bias)
    assert got.dtype == x.dtype and torch.equal(got, want)


def _case(name):
    """(x, scale, bias, whether the kernel takes the call) by name, x as the
    wrapper hands it over (made contiguous); CPU tensors stand in for the
    card's."""
    x, scale, bias = _inputs(4, 1024, torch.bfloat16, torch.bfloat16)
    takes = False
    if name == "bf16":
        takes = True
    elif name == "f32_params":
        scale, bias, takes = scale.float(), bias.float(), True
    elif name == "f32_x":
        x, takes = x.float(), True
    elif name == "widest_bf16":
        x, scale, bias = _inputs(2, 2048, torch.bfloat16, torch.bfloat16)
        takes = True
    elif name == "widest_f32":
        x, scale, bias = _inputs(2, 1024, torch.float32, torch.float32)
        takes = True
    elif name == "three_dims":
        x, takes = x.reshape(2, 2, 1024), True
    elif name == "non_contiguous":
        x, takes = _inputs(1024, 4, torch.bfloat16, torch.bfloat16)[0].t(), True
    elif name == "strided_rows":
        x, takes = _inputs(4, 2048, torch.bfloat16, torch.bfloat16)[0][:, :1024], True
    elif name == "width_not_a_vector":
        x, scale, bias = _inputs(4, 1020, torch.bfloat16, torch.bfloat16)
    elif name == "f32_width_not_a_vector":
        x, scale, bias = _inputs(4, 770, torch.float32, torch.float32)
    elif name == "too_wide_bf16":
        x, scale, bias = _inputs(2, 2056, torch.bfloat16, torch.bfloat16)
    elif name == "too_wide_f32":
        x, scale, bias = _inputs(2, 1028, torch.float32, torch.float32)
    elif name == "f16":
        x = x.half()
    elif name == "f64_params":
        scale, bias = scale.double(), bias.double()
    elif name == "mixed_params":
        bias = bias.float()
    elif name == "x_needs_grad":
        x, takes = x.float().requires_grad_(), True
    elif name == "scale_needs_grad":
        scale, bias, takes = scale.float().requires_grad_(), bias.float(), True
    elif name == "bias_needs_grad":
        scale, bias, takes = scale.float(), bias.float().requires_grad_(), True
    elif name == "misaligned_x":
        x = torch.zeros(4 * 1024 + 1, dtype=torch.bfloat16)[1:].view(4, 1024)
    elif name == "misaligned_scale":  # read one element at a time
        scale, takes = torch.ones(1025, dtype=torch.bfloat16)[1:], True
    elif name == "short_scale":
        scale = scale[:512]
    elif name == "strided_scale":
        scale = torch.ones(2048, dtype=torch.bfloat16)[::2]
    else:
        raise KeyError(name)
    return x.contiguous(), scale, bias, takes


RULE_CASES = ["bf16", "f32_params", "f32_x", "widest_bf16", "widest_f32", "three_dims",
              "non_contiguous", "strided_rows", "width_not_a_vector",
              "f32_width_not_a_vector", "too_wide_bf16", "too_wide_f32", "f16", "f64_params",
              "mixed_params", "x_needs_grad", "scale_needs_grad", "bias_needs_grad",
              "misaligned_x", "misaligned_scale", "short_scale", "strided_scale"]


@pytest.mark.parametrize("name", RULE_CASES)
def test_layer_norm_dispatch_rule(name):
    x, scale, bias, takes = _case(name)
    assert tnn.layer_norm_kernel_takes(x, scale, bias) is takes


def test_layer_norm_cpu_builds_and_counts_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"built {name} for a CPU call")

    monkeypatch.setattr(_build, "load", refuse)
    assert tnn._layer_norm_fn.cache_info().currsize == 0  # importing built nothing
    was_on = tracing.enabled()
    before = tracing.snapshot()["counters"].get("ops.layer_norm.kernel", 0)
    tracing.enable()
    try:
        with _Launches() as n:
            for name in ("bf16", "f32_x", "non_contiguous", "too_wide_f32", "f16"):
                x, scale, bias, _ = _case(name)
                tnn.layer_norm(x, scale, bias)
        after = tracing.snapshot()["counters"].get("ops.layer_norm.kernel", 0)
    finally:
        if not was_on:
            tracing.disable()
    assert n.n == 0 and after == before
    assert tnn._layer_norm_fn.cache_info().currsize == 0
    assert "layer_norm" not in _build._loaded


def test_layer_norm_other_devices_raise():
    x, scale, bias = (t.to("meta") for t in _inputs(2, 1024, torch.float32, torch.float32))
    with pytest.raises(ValueError, match="unsupported device"):
        tnn.layer_norm(x, scale, bias)


@pytest.mark.parametrize("x_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("p_dtype", ["bf16", "f32"])
def test_layer_norm_backward_matches_autograd(x_dtype, p_dtype):
    """The backward the kernel's autograd path runs (PyTorch ops, from the
    forward's mean and rstd) against autograd through the plain ops."""
    x, scale, bias = _inputs(6, 768, DTYPES[x_dtype], DTYPES[p_dtype], seed=7)
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    gy = torch.randn(6, 768, generator=torch.Generator().manual_seed(8)).to(x.dtype)
    tnn.layer_norm_plain(*leaves).backward(gy)
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(dim=-1, keepdim=True) + 1e-5)
    got = tnn.layer_norm_backward(gy, x, scale, mean, rstd)
    for g, leaf in zip(got, leaves):
        assert g.dtype == leaf.dtype and g.shape == leaf.shape
        tol = 1e-4 if leaf.dtype == torch.float32 else 2e-2
        np.testing.assert_allclose(g.float().numpy(), leaf.grad.float().numpy(),
                                   rtol=tol, atol=tol)
    some = tnn.layer_norm_backward(gy, x, scale, mean, rstd, (False, True, False))
    assert some[0] is None and some[2] is None and torch.equal(some[1], got[1])


def test_layer_norm_gradients_flow():
    x, scale, bias = _inputs(5, 768, torch.float32, torch.float32, seed=3)
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    g = torch.randn(5, 768, generator=torch.Generator().manual_seed(4))
    (tnn.layer_norm(*leaves) * g).sum().backward()
    ref = [t.clone().requires_grad_() for t in (x, scale, bias)]
    (torch.nn.functional.layer_norm(ref[0], (768,), ref[1], ref[2], 1e-5) * g).sum().backward()
    for got, want in zip(leaves, ref):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(), rtol=1e-4, atol=1e-5)


# ---- the card: the kernel against the plain version


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _bf16_ulp(v):
    """One bf16 ulp at each |v| (8 significant bits)."""
    mag = v.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _f32_slack(x, scale, bias, eps=1e-5):
    """How far the kernel's f32 value of ``n * scale + bias`` may lie from the
    plain version's before the final rounding: the two sums run in another
    order, which moves mean and rstd by a few f32 ulps, and so each output
    by a few ulps (2^-20 here) of the terms it adds. Where those terms cancel
    (an output near 0) that is more than a bf16 ulp of the output itself."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    n = (xf - mean) * torch.rsqrt((xf - mean).square().mean(dim=-1, keepdim=True) + eps)
    return 2.0 ** -20 * ((n * scale.float()).abs() + bias.float().abs())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 4097])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("p_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("x_dtype", ["bf16", "f32"])
def test_layer_norm_kernel_matches_plain(x_dtype, p_dtype, d, rows):
    _needs_card()
    x, scale, bias = _inputs(rows, d, DTYPES[x_dtype], DTYPES[p_dtype], device="cuda",
                             seed=rows * d)
    with torch.inference_mode(), _Launches() as n:
        got = tnn.layer_norm(x, scale, bias)
    want = tnn.layer_norm_plain(x, scale, bias)
    assert n.n == 1
    assert got.dtype == x.dtype and got.shape == x.shape
    slack = _f32_slack(x, scale, bias).cpu()
    got, want = got.float().cpu(), want.float().cpu()
    if x_dtype == "bf16":  # one bf16 ulp of the plain version's value
        err = (got - want).abs() - _bf16_ulp(want) - slack
        assert float(err.max()) <= 0, [(float(got.flatten()[i]), float(want.flatten()[i]))
                                       for i in err.flatten().topk(3).indices]
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def _assert_close_to_plain(got, x, scale, bias):
    """``got`` within one bf16 ulp (bf16 x) or 1e-5 (f32 x) of the plain
    version, the f32 slack of :func:`_f32_slack` added."""
    want = tnn.layer_norm_plain(x, scale, bias).float().cpu()
    got = got.float().cpu()
    if x.dtype == torch.bfloat16:
        err = (got - want).abs() - _bf16_ulp(want) - _f32_slack(x, scale, bias).cpu()
        assert float(err.max()) <= 0
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["non_contiguous", "strided_rows", "misaligned_scale",
                                  "misaligned_f32_bias"])
def test_layer_norm_card_takes_views(name):
    """A non-contiguous x is made contiguous and taken; parameters that are
    not 16-byte aligned (views of one weight buffer) are read an element at
    a time."""
    _needs_card()
    x, scale, bias = _inputs(4, 1024, torch.bfloat16, torch.bfloat16, device="cuda", seed=9)
    if name == "non_contiguous":
        x = _inputs(1024, 4, torch.bfloat16, torch.bfloat16, device="cuda")[0].t()
    elif name == "strided_rows":
        x = _inputs(4, 2048, torch.bfloat16, torch.bfloat16, device="cuda")[0][:, :1024]
    elif name == "misaligned_scale":
        scale = torch.cat([scale[:1], scale])[1:]
    else:  # f32 x of 512, its f32 bias 4 bytes past a boundary
        x, scale, bias = _inputs(299, 512, torch.float32, torch.float32, device="cuda")
        bias = torch.cat([bias[:1], bias])[1:]
    assert name not in ("misaligned_scale", "misaligned_f32_bias") or (
        (scale.data_ptr() | bias.data_ptr()) % 16)
    with torch.inference_mode(), _Launches() as n:
        got = tnn.layer_norm(x, scale, bias)
    assert n.n == 1 and got.shape == x.shape
    _assert_close_to_plain(got, x, scale, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["width_not_a_vector", "f32_width_not_a_vector",
                                  "too_wide_bf16", "too_wide_f32", "f16", "f64_params",
                                  "mixed_params", "misaligned_x", "short_scale",
                                  "strided_scale"])
def test_layer_norm_card_refuses(name):
    """A CUDA call the kernel does not take raises: the card never runs the
    plain ops."""
    _needs_card()
    x, scale, bias, takes = _case(name)
    assert not takes
    x, scale, bias = (t.cuda() for t in (x, scale, bias))
    if name == "misaligned_x":
        x = torch.zeros(4 * 1024 + 1, dtype=torch.bfloat16, device="cuda")[1:].view(4, 1024)
    if name == "strided_scale":
        scale = torch.ones(2048, dtype=torch.bfloat16, device="cuda")[::2]
    with _Launches() as n, pytest.raises(ValueError, match="layer_norm kernel"):
        tnn.layer_norm(x, scale, bias)
    assert n.n == 0


@pytest.mark.cuda
@pytest.mark.parametrize("p_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("x_dtype", ["bf16", "f32"])
def test_layer_norm_card_gradients(x_dtype, p_dtype):
    """Under autograd the kernel runs the forward (one launch) and the
    backward of ``layer_norm_backward`` gives autograd's gradients through
    the plain ops."""
    _needs_card()
    x, scale, bias = _inputs(9, 1024, DTYPES[x_dtype], DTYPES[p_dtype], device="cuda", seed=2)
    gy = torch.randn(9, 1024, generator=torch.Generator(device="cuda").manual_seed(3),
                     device="cuda").to(x.dtype)
    mine = [t.clone().requires_grad_() for t in (x, scale, bias)]
    ref = [t.clone().requires_grad_() for t in (x, scale, bias)]
    with _Launches() as n:
        y = tnn.layer_norm(*mine)
    assert n.n == 1 and y.requires_grad
    y.backward(gy)
    tnn.layer_norm_plain(*ref).backward(gy)
    _assert_close_to_plain(y.detach(), x, scale, bias)
    for got, want in zip(mine, ref):
        assert got.grad.dtype == want.grad.dtype
        tol = 1e-4 if want.dtype == torch.float32 else 2e-2
        np.testing.assert_allclose(got.grad.float().cpu().numpy(),
                                   want.grad.float().cpu().numpy(), rtol=tol, atol=tol)


def _flagship_gpt(dtype):
    """A 30 x 1024 GPT with seeded random weights; in bf16 cast with its
    ``final_norm`` kept in f32, as the inference pipeline builds it."""
    from genvc_tpu_torch.checkpoint import assign
    from genvc_tpu_torch.models import gpt as gpt_model

    cfg = gpt_model.GPTConfig()
    tree = gpt_model.init_tree(torch.Generator(device="cuda").manual_seed(11), cfg)
    with torch.device("meta"):
        model = gpt_model.GPT(cfg)
    assign(model, tree, "cuda")
    if dtype != torch.float32:
        model.to(dtype)
        assign(model.final_norm, tree["final_norm"], "cuda")
    return model.eval()


def _prefilled(model, steps, cache_dtype):
    """A state prefilled with a seeded 75-code prefix, room for ``steps``
    more tokens and a few, and the greedy sampler."""
    from genvc_tpu_torch.decode import engine
    from genvc_tpu_torch.models import gpt as gpt_model

    g = torch.Generator(device="cuda").manual_seed(5)
    cond = torch.randn(1, 32, model.cfg.model_dim, generator=g, device="cuda") * 0.05
    codes = torch.randint(0, 256, (1, 80), generator=g, device="cuda")
    sampler = engine.SamplerConfig(do_sample=False)
    prefix, valid = gpt_model.build_prefix_emb(model, cond, codes,
                                               torch.tensor([75], device="cuda"))
    state = engine.init_state(model.cfg, prefix.shape[1], 1, "cuda",
                              cache_dtype=cache_dtype, gen_tokens=steps + 8)
    engine.prefill(model, state, prefix, valid, sampler)
    return state, sampler


def _decode(model, steps, cache_dtype):
    """``steps`` greedy lockstep steps after the prefill: tokens (steps,),
    latents (steps, D) f32, and the host's kernel launches of one traced
    step (the mean over 4 more)."""
    from genvc_tpu_torch.decode import engine

    with torch.inference_mode():
        state, sampler = _prefilled(model, steps + 4, cache_dtype)
        toks, lats, _ = engine.decode_chunk(model, state, sampler, chunk=steps)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(4):
                engine.decode_chunk(model, state, sampler, chunk=1)
            torch.cuda.synchronize()
    launches = sum(1 for ev in prof.events() if "LaunchKernel" in ev.name) / 4
    return toks[0].cpu(), lats[0].float().cpu(), launches


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _copy(state, cache_dtype=None):
    """A decode state's copy, its cache in ``cache_dtype`` if given."""
    from genvc_tpu_torch.decode import engine

    kw = {}
    for f in state.__dataclass_fields__:
        v = getattr(state, f)
        if torch.is_tensor(v):
            v = v.clone()
            if cache_dtype is not None and f in ("cache_k", "cache_v"):
                v = v.to(cache_dtype)
        kw[f] = v
    return engine.DecodeState(**kw)


@pytest.mark.cuda
def test_decode_step_layer_norm_kernel_at_flagship(monkeypatch):
    """The 30 x 1024 bf16 GPT on a bf16 cache, 32 greedy steps with the
    kernel and with the plain ops: 62 kernel calls a step (ln_1 and ln_2 of
    30 blocks, ln_f, final_norm) and 806 +- 10 fewer launches. Then a run
    prefilled with the kernel and stepped with the plain ops takes each step
    again from its state with the kernel and with an f32 copy of the GPT: the
    kernel moves latents and logits by no more than bf16 itself errs there
    against f32. (The free runs' tokens are not
    compared: one bf16 ulp of a LayerNorm output moves these random weights'
    logits by up to 0.02, above the top-two gap of some steps; the f32 test
    below compares tokens.)"""
    import copy

    from genvc_tpu_torch.decode import engine

    _needs_card()
    model = _flagship_gpt(torch.bfloat16)
    steps = 32
    with _Launches() as n:
        _, _, launches = _decode(model, steps, torch.bfloat16)
    per_step = 2 * model.cfg.layers + 2
    # the prefill, the 32 steps and the 4 traced ones
    assert n.n == per_step * (1 + steps + 4)
    kernel_ln = tnn.layer_norm
    monkeypatch.setattr(tnn, "layer_norm", tnn.layer_norm_plain)
    with _Launches() as n:
        _, _, launches_p = _decode(model, steps, torch.bfloat16)
    assert n.n == 0
    assert abs((launches_p - launches) - 806) <= 10, (launches_p, launches)

    f32 = copy.deepcopy(model).float()
    monkeypatch.setattr(tnn, "layer_norm", kernel_ln)
    with torch.inference_mode():
        state, sampler = _prefilled(model, steps, torch.bfloat16)
        for _ in range(steps):
            monkeypatch.setattr(tnn, "layer_norm", kernel_ln)
            lat_k, logits_k = engine._decode_forward(model, _copy(state))
            monkeypatch.setattr(tnn, "layer_norm", tnn.layer_norm_plain)
            lat_p, logits_p = engine._decode_forward(model, _copy(state))
            lat_f, logits_f = engine._decode_forward(f32, _copy(state, torch.float32))
            assert _rel(lat_k, lat_p) <= _rel(lat_p, lat_f)
            assert (logits_k - logits_p).abs().max() <= (logits_p - logits_f).abs().max()
            engine._decode_one(model, state, sampler)


@pytest.mark.cuda
def test_decode_tokens_layer_norm_kernel_f32_flagship(monkeypatch):
    """The 30 x 1024 GPT in f32 on an f32 cache: 32 greedy steps give the
    same tokens with the kernel as with the plain ops, latents within 1e-4
    (relative), 62 kernel calls a step."""
    _needs_card()
    model = _flagship_gpt(torch.float32)
    steps = 32
    with _Launches() as n:
        toks, lats, _ = _decode(model, steps, torch.float32)
    assert n.n == (2 * model.cfg.layers + 2) * (1 + steps + 4)
    monkeypatch.setattr(tnn, "layer_norm", tnn.layer_norm_plain)
    toks_p, lats_p, _ = _decode(model, steps, torch.float32)
    assert torch.equal(toks, toks_p), (toks, toks_p)
    assert _rel(lats, lats_p) < 1e-4
