"""Parallelism of the port (``genvc_tpu_torch.parallel``) against the JAX
package on the CPU: the sharding rules against ``gpt_param_specs``, the
tensor-parallel GPT forward, the 2 x 2 (data x model) GPT training step,
the VQ-EMA all-reduce and the data-parallel GAN step. The parent computes
JAX's side; the port runs on spawned CPU ranks joined over gloo
(``parallel.launch.run_ranks``), 2 layers x 64 dims x 4 heads.

Tolerances: the TP forward 2e-5, as ``tests/test_multichip.py`` holds JAX's
own sharded forward; the 2 x 2 step's metrics 1e-5 relative and parameters
2e-6 absolute after two steps (the single-card step holds 2e-6 / 1e-6 in
``test_torch_train.py``; the row-parallel sums and the data all-reduce add
sums in other orders; Adam's eps 1e-3 as there); the VQ-EMA codebook at
``test_multichip.py``'s bounds (cluster_size 1e-5 / 1e-6, embed 1e-4 /
1e-5); the data-parallel GAN step against the port's one-process step on
the whole batch: metrics 1e-5 relative, parameters 2e-6 absolute (the
batch means split in two sums), spectral-norm buffers bit-equal across
ranks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from genvc_tpu.config import GenVCConfig as JConfig
from genvc_tpu.models import dvae as jdvae, gpt as jgpt
from genvc_tpu.parallel import mesh as jmesh
from genvc_tpu.train import gpt_stage as jstage, optim as joptim
from genvc_tpu.train.runner import _load_contentvec, _load_dvae
from genvc_tpu_torch import checkpoint as tck
from genvc_tpu_torch.config import GenVCConfig as TConfig, VocoderConfig
from genvc_tpu_torch.models import dvae as tdvae, gpt as tgpt, hifigan as thg
from genvc_tpu_torch.parallel import mesh as tmesh, rank_checks
from genvc_tpu_torch.parallel.launch import run_ranks
from genvc_tpu_torch.testing_synthetic import write_stage_ckpts
from genvc_tpu_torch.train import gpt_stage as tstage, optim as toptim, vocoder_stage as tvs

GCFG = dict(layers=2, model_dim=64, heads=4)
EPS = 1e-3


def _shrink(cfg):
    for c, ch, nt in ((cfg.acoustic_dvae_config, 80, 64), (cfg.content_dvae_config, 256, 36)):
        c.num_channels, c.num_tokens, c.hidden_dim, c.codebook_dim = ch, nt, 16, 24
        c.num_resnet_blocks = 3
    return cfg


@pytest.fixture(scope="module")
def stage(tmp_path_factory):
    paths = write_stage_ckpts(str(tmp_path_factory.mktemp("stage")))
    jtree = {"contentvec": _load_contentvec(paths["contentvec"]),
             "acoustic_dvae": _load_dvae(paths["acoustic_dvae"]),
             "content_dvae": _load_dvae(paths["content_dvae"])}
    ttree = {"contentvec": tck.load_contentvec(paths["contentvec"]),
             "acoustic_dvae": tck.load_dvae(paths["acoustic_dvae"]),
             "content_dvae": tck.load_dvae(paths["content_dvae"])}
    return {"jtree": jtree, "ttree": ttree, "gpt": tck.load_gpt(paths["gpt"], GCFG["layers"])}


def _leaves(tree, prefix=""):
    """(path, leaf) pairs; a tuple (a spec) is a leaf, a list is not."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# ------------------------------------------------------------ sharding rules


def test_torch_gpt_param_specs_split_the_dims_jax_splits(stage):
    """Leaf by leaf, the dimension the port splits over ``model`` is the one
    JAX's ``gpt_param_specs`` names, on the stacked tree; on a per-layer
    (list) tree it is the same dimension counted from the end."""
    tree = stage["gpt"]
    jspecs = dict(_leaves(jmesh.gpt_param_specs(tree)))
    tspecs = dict(_leaves(tmesh.gpt_param_specs(tree)))
    assert set(jspecs) == set(tspecs)
    split = 0
    for path, leaf in _leaves(tree):
        want = tuple(jspecs[path]) + (None,) * (np.ndim(leaf) - len(tuple(jspecs[path])))
        assert tspecs[path] == want, path
        split += "model" in want
    assert split == 6  # c_attn w/b, attn c_proj w, c_fc w/b, mlp c_proj w
    blocks = [{k: v for k, v in _leaves_of_layer(tree["core"]["blocks"], i)}
              for i in range(GCFG["layers"])]
    per_layer = tmesh.gpt_param_specs({"core": {"blocks": blocks}})["core"]["blocks"][1]
    assert per_layer["attn"]["c_attn"]["w"] == (None, "model")
    assert per_layer["attn"]["c_proj"]["w"] == ("model", None)
    assert per_layer["attn"]["c_proj"]["b"] == (None,)


def _leaves_of_layer(blocks, i):
    def take(node):
        return {k: take(v) for k, v in node.items()} if isinstance(node, dict) else node[i]
    return take(blocks).items()


@pytest.mark.parametrize("n", [2, 4])
def test_torch_shard_gather_round_trip_is_exact(stage, n):
    """``shard_tree`` for each model index, loaded into that rank's GPT, and
    the flat vectors joined back (``FlatParams.join``, what ``gather`` does
    after its all-gather) give the whole model's flat vector bit for bit,
    and ``FlatParams.shard`` of it gives each rank's back; each rank's
    ``c_attn`` holds its heads' q, k and v columns, and the row-parallel
    weights its heads' rows."""
    tree = stage["gpt"]
    specs = tmesh.gpt_param_specs(tree)
    mesh = tmesh.make_mesh(n_data=1, n_model=n, devices=["cpu"] * n)
    shards = [tmesh.shard_tree(tree, specs, mesh, rank=m) for m in range(n)]
    d, hd = GCFG["model_dim"], GCFG["model_dim"] // GCFG["heads"]
    w = tree["core"]["blocks"]["attn"]["c_attn"]["w"]
    width = d // n
    for m, sh in enumerate(shards):
        got = sh["core"]["blocks"]["attn"]["c_attn"]["w"]
        assert got.shape == (GCFG["layers"], d, 3 * width)
        for part in range(3):  # q, k, v of heads [m * H / n, (m + 1) * H / n)
            np.testing.assert_array_equal(
                got[..., part * width:(part + 1) * width],
                w[..., part * d + m * width: part * d + (m + 1) * width])
        assert width % hd == 0
        np.testing.assert_array_equal(sh["core"]["blocks"]["attn"]["c_proj"]["w"],
                                      tree["core"]["blocks"]["attn"]["c_proj"]["w"]
                                      [:, m * width:(m + 1) * width])
        np.testing.assert_array_equal(sh["core"]["blocks"]["attn"]["c_proj"]["b"],
                                      tree["core"]["blocks"]["attn"]["c_proj"]["b"])
    ranks = []
    for sh in shards:
        with torch.device("meta"):
            model = tgpt.GPT(tgpt.GPTConfig(**GCFG), n)
        tck.assign(model, sh, "cpu")
        ranks.append(toptim.FlatParams(model))
    assert sum(ranks[0].sharded) == 6 * GCFG["layers"]
    with torch.device("meta"):
        whole = tgpt.GPT(tgpt.GPTConfig(**GCFG))
    tck.assign(whole, tree, "cpu")
    wparams = toptim.FlatParams(whole)
    assert ranks[0].names == wparams.names
    assert ranks[0].whole_shapes() == wparams.shapes
    full = ranks[0].join([p.flat for p in ranks])
    torch.testing.assert_close(full, wparams.flat.detach(), rtol=0, atol=0)
    for m, p in enumerate(ranks):
        torch.testing.assert_close(p.shard(full, m), p.flat.detach(), rtol=0, atol=0)
    # the whole GPT built from the joined vector exports the loaded tree
    back = dict(_leaves(tck.export_tree(tstage.whole_gpt(tgpt.GPTConfig(**GCFG),
                                                           ranks[0], full))))
    assert set(back) == set(dict(_leaves(tree)))
    for path, a in _leaves(tree):
        np.testing.assert_array_equal(a, back[path], err_msg=path)


def test_torch_mesh_and_batch_shards():
    """Row-major placement, repeated devices (a stated deviation), the rows
    of a data index, and a batch the data axis does not divide."""
    mesh = tmesh.make_mesh(n_data=2, n_model=2, devices=["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.axis_names == ("data", "model")
    assert mesh.device == torch.device("cpu") and mesh.backend is None
    with pytest.raises(ValueError, match="devices"):
        tmesh.make_mesh(n_data=3, n_model=2, devices=["cpu"] * 4)
    batch = {"x": np.arange(8)}
    assert list(tmesh.shard_batch(batch, mesh)["x"]) == [0, 1, 2, 3]
    mesh.rank = 3  # data index 1
    assert list(tmesh.shard_batch(batch, mesh)["x"]) == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="divide"):
        tmesh.shard_batch({"x": np.arange(7)}, mesh)
    assert tmesh.choose_backend("cpu") == "gloo"
    assert tmesh.initialize_distributed(world_size=1) is None


@pytest.mark.parametrize("votes,want", [
    ([("nccl", False), ("nccl", False)], "nccl"),
    ([("gloo", True), ("gloo", False)], "gloo"),
    # one rank names a card it does not own: NCCL is out for every rank
    ([("nccl", False), ("gloo", False), ("gloo", False)], "gloo"),
    ([("nccl", True), ("gloo", True)], ValueError),
    ([("nccl", True), ("gloo", False)], ValueError),
])
def test_torch_ranks_agree_on_one_backend(votes, want):
    """Every rank takes the same backend from the same votes, or every rank
    raises: no group is made of mismatched backends."""
    if want is ValueError:
        with pytest.raises(ValueError, match="different backends"):
            tmesh.agree_backend(votes)
    else:
        assert tmesh.agree_backend(votes) == want


# -------------------------------------------------------- tensor parallelism


def _tp_spec(stage):
    rng = np.random.default_rng(0)
    emb = (rng.standard_normal((4, 12, GCFG["model_dim"])) * 0.3).astype(np.float32)
    return {"gpt_cfg": tgpt.GPTConfig(**GCFG), "core": stage["gpt"]["core"], "emb": emb,
            "n_model": 2}


def _vq_spec():
    cfg = tdvae.DVAEConfig(channels=8, num_tokens=16, codebook_dim=8, hidden_dim=4,
                           num_resnet_blocks=1, num_layers=2)
    tree = tdvae.init_tree(torch.Generator().manual_seed(0), cfg, trainable=True)
    x = np.random.default_rng(1).standard_normal((8, 8, 16)).astype(np.float32)
    return {"dvae_cfg": cfg, "tree": jax.tree.map(lambda t: np.asarray(t), tree), "x": x}


SMALL = dict(input_feat_dim=64, upsample_initial_channel=16, msstftd_filters=4,
             mssbcqtd_filters=4, mssbcqtd_hop_lengths=[512], mssbcqtd_n_octavess=[5],
             mssbcqtd_bins_per_octave=[12])


def _gan_spec(stage):
    cfg = VocoderConfig(**SMALL)
    gen_tree = thg.generator_to_weight_norm(thg.init_tree(torch.Generator().manual_seed(4), cfg))
    rng = np.random.default_rng(0)
    lens = np.asarray([2, 1])
    wav = (rng.standard_normal((2, 1, 2 * 1920)) * 0.1).astype(np.float32)
    wav[1, :, 1920:] = 0
    return {"cfg": _shrink(TConfig()), "frozen": stage["ttree"],
            "mel_norms": np.ones(80, np.float32), "gpt_cfg": tgpt.GPTConfig(**GCFG),
            "gpt_tree": stage["gpt"], "vocoder_cfg": cfg,
            "gen_tree": jax.tree.map(lambda t: np.asarray(t), gen_tree),
            "disc_tree": tck.export_tree(tvs.init_discriminators(
                torch.Generator().manual_seed(5), cfg)),
            "families": ("MSD_Discriminator", "MPD_Discriminator"), "steps": 1, "lr": 2e-4,
            "eps": EPS,
            "batch": {"wav": wav, "wav_lengths": lens * 1920, "text_lengths": lens,
                      "conditioning": (rng.standard_normal((2, 1, 1, 24000)) * 0.1
                                       ).astype(np.float32),
                      "cond_lens": np.asarray([24000, 18000])}}


@pytest.fixture(scope="module")
def two_ranks(stage):
    """This file's 2-rank programs in one launch (a spawned rank takes
    seconds to start): the TP forward, the VQ-EMA step and the GAN step.
    Returns (name -> spec, name -> [rank 0's result, rank 1's])."""
    specs = {"core_forward": _tp_spec(stage), "vq_ema": _vq_spec(),
             "gan_train": _gan_spec(stage)}
    outs = run_ranks(rank_checks.sequence, 2, args=(list(specs.items()),))
    return specs, {name: [o[i] for o in outs] for i, name in enumerate(specs)}


def test_torch_tp_forward_matches_jax_replicated_and_sharded(stage, two_ranks):
    """The GPT core over 2 ranks (n_model = 2, each with 2 of the 4 heads)
    against JAX's ``core_forward`` replicated and on the 8-device
    ``make_mesh(n_data=4, n_model=2)``, within 2e-5."""
    specs, outs = two_ranks
    emb = specs["core_forward"]["emb"]
    gcfg = jgpt.GPTConfig(**GCFG)
    params = jax.tree.map(jnp.asarray, stage["gpt"])
    ref = np.asarray(jgpt.core_forward(params["core"], jnp.asarray(emb), gcfg))
    mesh8 = jmesh.make_mesh(n_data=4, n_model=2)
    sharded = jmesh.shard_tree(params, jmesh.gpt_param_specs(params), mesh8)
    emb8 = jax.device_put(jnp.asarray(emb), jax.sharding.NamedSharding(
        mesh8, jax.sharding.PartitionSpec("data")))
    on_mesh = np.asarray(jax.jit(lambda p, e: jgpt.core_forward(p["core"], e, gcfg))(
        sharded, emb8))
    for start, got in outs["core_forward"]:  # both ranks hold all rows
        assert start == 0
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, on_mesh, rtol=2e-5, atol=2e-5)


def _batch4(seed=3):
    """B = 4 in two data shards of 2 rows: 4 + 3 content tokens on data rank
    0 and 2 + 4 on data rank 1 (each row zero past its length), conditioning
    of 1.0, 0.75, 0.5 and 1.0 s."""
    rng = np.random.default_rng(seed)
    lens = np.asarray([4, 3, 2, 4])
    wav = (rng.standard_normal((4, 1, 4 * 1920)) * 0.1).astype(np.float32)
    for i, n in enumerate(lens):
        wav[i, :, n * 1920:] = 0
    return {"wav": wav, "wav_lengths": lens * 1920,
            "conditioning": (rng.standard_normal((4, 1, 1, 24000)) * 0.1).astype(np.float32),
            "cond_lens": np.asarray([24000, 18000, 12000, 24000]), "text_lengths": lens}


def test_torch_tp_dp_gpt_step_matches_jax(stage):
    """Two steps of the port's step on a 2 x 2 mesh (4 ranks: the GPT
    sharded over each model group, the batch over the data groups, whose
    ranks keep different token counts) against JAX's single-device
    ``make_train_step`` on the whole batch: per-step metrics (the global
    batch's means, not a mean of per-rank means) and every parameter. The
    two ranks of a model group get bit-identical batches and keep their
    replicated parameters bit-identical. The attention runs through the
    kernels' wrappers at the 2 local heads (their plain versions here; the
    launches are counted on the card by ``chip_smoke.py``)."""
    batch = _batch4()
    assert batch["text_lengths"][:2].sum() != batch["text_lengths"][2:].sum()
    ones = np.ones(80, np.float32)
    jf = jstage.make_frozen(_shrink(JConfig()), stage["jtree"], ones)
    params = jax.tree.map(jnp.asarray, stage["gpt"])
    tx = joptim.adamw_grouped(joptim.multistep_schedule(1e-3, [1], 0.5), eps=EPS,
                              weight_decay=0.1, params=params)
    jstate = jstage.GPTTrainState(params, tx.init(params), jnp.int32(0))
    jstep = jax.jit(jstage.make_train_step(jgpt.GPTConfig(**GCFG), tx, attn_impl="xla",
                                           grad_norms=True)[0])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmetrics = []
    for _ in range(2):
        jstate, jm = jstep(jstate, jbatch, jf)
        jmetrics.append({k: float(v) for k, v in jm.items()})

    spec = {"cfg": _shrink(TConfig()), "frozen": stage["ttree"], "mel_norms": ones,
            "gpt_cfg": tgpt.GPTConfig(**GCFG), "gpt_tree": stage["gpt"], "batch": batch,
            "n_model": 2, "steps": 2, "dtypes": ["f32"], "attn_impl": "flash", "lr": 1e-3,
            "eps": EPS, "weight_decay": 0.1, "return_params": True}
    outs = [o[0] for o in run_ranks(rank_checks.gpt_train, 4, args=(spec,))]
    assert [(o["data_index"], o["model_index"]) for o in outs] == [(0, 0), (0, 1), (1, 0),
                                                                   (1, 1)]
    for a, b in ((0, 1), (2, 3)):  # one model group each
        assert outs[a]["batch_digest"] == outs[b]["batch_digest"]
        assert outs[a]["replicated_digest"] == outs[b]["replicated_digest"]
    assert outs[0]["batch_digest"] != outs[2]["batch_digest"]
    for o in outs:
        for got, want in zip(o["metrics"], jmetrics):
            assert set(want) <= set(got)
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k
        # per step: 2 forward + 2 backward Megatron all-reduces a block, the
        # clip's norm, the gradient norms' and the data group's two
        # (denominators, gradient) and the metrics
        assert all(c["all_reduce"] > 0 for c in o["collectives"])
    got = dict(_leaves(outs[0]["params"]))
    for path, want in _leaves(jax.tree.map(np.asarray, jstate.params)):
        err = float(np.abs(got[path] - want).max())
        assert err <= 2e-6, f"{path}: max |err| {err:.3e}"


# --------------------------------------------------------------- VQ-EMA, GAN


def test_torch_vq_ema_all_reduce_matches_jax_psum(two_ranks):
    """The codebook after one training forward on 2 data ranks (4 rows
    each, the counts and sums all-reduced) against JAX's ``shard_map`` /
    ``psum`` update over 2 devices, at ``test_multichip.py``'s bounds."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    specs, outs = two_ranks
    spec = specs["vq_ema"]
    jcfg = jdvae.DVAEConfig(channels=8, num_tokens=16, codebook_dim=8, hidden_dim=4,
                            num_resnet_blocks=1, num_layers=2)
    mesh2 = jmesh.make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
    fn = shard_map(lambda p, xb: jdvae.forward_train(p, xb, jcfg, axis_name="data")[3],
                   mesh=mesh2, in_specs=(P(), P("data")), out_specs=P())
    want = jax.tree.map(np.asarray, fn(jax.tree.map(jnp.asarray, spec["tree"]),
                                       jnp.asarray(spec["x"])))
    for got in outs["vq_ema"]:
        np.testing.assert_allclose(got["cluster_size"], want["cluster_size"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["embed"], want["embed"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["embed_avg"], want["embed_avg"], rtol=1e-4, atol=1e-5)


def test_torch_gan_step_data_parallel_matches_one_process(stage, two_ranks):
    """One GAN step over MSD + MPD with the batch of 2 split over 2 data
    ranks against the port's one-process step on the whole batch: metrics,
    the generator's and the discriminators' parameters and spectral-norm
    buffers; the buffers are bit-equal across the ranks (they advance from
    the weights alone, which the averaged gradients keep equal)."""
    from genvc_tpu_torch.train.runner import to_device

    specs, outs = two_ranks
    spec, outs = specs["gan_train"], outs["gan_train"]
    cfg, gen_tree, disc_tree = spec["vocoder_cfg"], spec["gen_tree"], spec["disc_tree"]
    batch, ones = spec["batch"], spec["mel_norms"]
    assert outs[0]["sn_digest"] == outs[1]["sn_digest"] and outs[0]["n_sn"] > 0

    # the same steps in this process on the whole batch
    torch.manual_seed(0)
    tf = tstage.make_frozen(spec["cfg"], stage["ttree"], ones, "cpu")
    with torch.device("meta"):
        gpt = tgpt.GPT(tgpt.GPTConfig(**GCFG))
        generator = thg.Generator(cfg, weight_norm=True)
        discs = thg.Discriminators(cfg)
    tck.assign(gpt, stage["gpt"], "cpu")
    tck.assign(generator, gen_tree, "cpu")
    tck.assign(discs, disc_tree, "cpu")
    gp, dp = toptim.FlatParams(generator), toptim.FlatParams(discs)
    opt = lambda p: toptim.AdamW(2e-4, (0.8, 0.99), EPS, 0.01, None).init(p.flat)
    state = tvs.VocoderTrainState(generator, discs, gp, dp, opt(gp), opt(dp))
    step, _ = tvs.make_train_step(cfg, families=spec["families"])
    tb = to_device(batch, "cpu")
    _, want_m = step(state, tb, tf, gpt.eval())
    for k, v in want_m.items():
        assert outs[0]["metrics"][0][k] == pytest.approx(float(v), rel=1e-5), k
    for name, mod in (("gen", generator), ("disc", discs)):
        got = dict(_leaves(outs[0][name]))
        for path, want in _leaves(tck.export_tree(mod)):
            err = float(np.abs(got[path] - want).max())
            assert err <= 2e-6, f"{name}{path}: max |err| {err:.3e}"
