"""The system under test: ``genvc_tpu_torch``, built from a configuration
file and the benchmark's weights, with recorders of what it serves.

Only this module and the drivers import the program. The recorders keep
what the timed path produced (tokens, content codes and the pre-quantization
values they came from) so the reference can judge it after the window, and
stamp each first chunk of audio with the harness's own clock; they call the
program's own methods unchanged. Each method they wrap is looked up by
:func:`hook`, which fails loudly where the program no longer has it.
"""

from __future__ import annotations

import numpy as np
import torch


def genvc_config(cfg: dict):
    """The program's ``GenVCConfig`` for the configuration file ``cfg``."""
    from genvc_tpu_torch.config import GenVCConfig

    c = GenVCConfig()
    g, ma = cfg["gpt"], c.model_args
    ma.mel_norm_file = cfg["style_mel"]["norms_file"]
    ma.gpt_layers, ma.gpt_n_model_channels, ma.gpt_n_heads = g["layers"], g["model_dim"], g["heads"]
    ma.gpt_max_text_tokens, ma.gpt_max_audio_tokens = g["max_text_tokens"], g["max_mel_tokens"]
    ma.gpt_number_text_tokens, ma.gpt_num_audio_tokens = g["number_text_tokens"], g["num_audio_tokens"]
    ma.gpt_start_text_token, ma.gpt_stop_text_token = g["start_text_token"], g["stop_text_token"]
    ma.gpt_start_audio_token, ma.gpt_stop_audio_token = g["start_audio_token"], g["stop_audio_token"]
    ma.gpt_code_stride_len = g["code_stride_len"]
    cd, d = c.content_dvae_config, cfg["content_dvae"]
    cd.num_channels, cd.num_tokens, cd.codebook_dim = d["channels"], d["num_tokens"], d["codebook_dim"]
    cd.hidden_dim, cd.num_resnet_blocks = d["hidden_dim"], d["num_resnet_blocks"]
    cd.kernel_size, cd.num_layers = d["kernel_size"], d["num_layers"]
    v, h = c.vocoder_config, cfg["hifigan"]
    v.input_feat_dim, v.upsample_initial_channel = h["input_feat_dim"], h["upsample_initial_channel"]
    v.upsample_rates, v.upsample_kernal_sizes = list(h["upsample_rates"]), list(h["upsample_kernel_sizes"])
    v.resblock_kernel_sizes = list(h["resblock_kernel_sizes"])
    v.resblock_dilation_sizes = [list(x) for x in h["resblock_dilation_sizes"]]
    v.resblock_type = h["resblock_type"]
    s = cfg["sampler"]
    c.top_k, c.temperature, c.top_p = s["top_k"], s["temperature"], s["top_p"]
    c.repetition_penalty = s["repetition_penalty"]
    return c


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def hook(obj, name: str):
    """``obj.name``, a callable the recorders wrap; an error naming it where
    the program has none."""
    fn = getattr(obj, name, None)
    if not callable(fn):
        raise RuntimeError(f"the benchmark wraps {getattr(obj, '__name__', type(obj).__name__)}"
                           f".{name}, which the program no longer has")
    return fn


def record_latents(dvae, out: list, on=lambda: True):
    """Wrap ``dvae.nearest_codes`` so each call's pre-quantization values
    (B, T, D) are appended to ``out`` while ``on()``."""
    nearest = hook(dvae, "nearest_codes")

    def nearest_codes(z):
        if on():
            out.append(z.detach())
        return nearest(z)

    dvae.nearest_codes = nearest_codes


def build(cfg: dict, tree: dict, seed: int, device):
    """The program's pipeline over ``tree`` in the configuration's precision."""
    from genvc_tpu_torch.inference import pipeline

    g = cfg["gpt"]
    if g["kv_cache_dtype"] != g["dtype"]:
        raise ValueError("a KV cache type other than the GPT's is not wired here")
    pipe = pipeline.build_pipeline(tree, genvc_config(cfg), device=device,
                                   dtype=_DTYPES[g["dtype"]], seed=seed)
    pipe.gen_cap_tokens_per_code = cfg["stream"]["gen_cap_tokens_per_code"]
    pipe.first_chunk_tokens = cfg["stream"]["first_chunk_tokens"]
    return pipe


class StreamRecorder:
    """Records, per segment that ``pipe`` starts, the content codes and
    their pre-quantization values, the prefill token and every decode
    window's tokens, and the host time of each call's first crossfaded
    chunk (one caller at a time)."""

    def __init__(self, pipe):
        import time

        from genvc_tpu_torch.decode import engine
        from genvc_tpu_torch.inference import pipeline

        self.segments: list[dict] = []
        self.first_chunk_t = None
        self._engine, self._pipeline = engine, pipeline
        self._decode_chunk = hook(engine, "decode_chunk")
        self._handle_chunk = hook(pipeline, "_handle_chunk")
        start = hook(pipe, "_start_segment")
        latents: list = []
        record_latents(pipe.content_dvae, latents)

        def start_segment(*args, **kwargs):
            latents.clear()
            out = start(*args, **kwargs)
            _, tok0, _, codes, n_codes = out
            self.segments.append({"codes": codes[0], "z": latents[-1][0], "n": n_codes[0],
                                  "parts": [tok0]})
            return out

        def decode_chunk(*args, **kwargs):
            out = self._decode_chunk(*args, **kwargs)
            self.segments[-1]["parts"].append(out[0][0])
            return out

        def handle_chunk(*args, **kwargs):
            out = self._handle_chunk(*args, **kwargs)
            if self.first_chunk_t is None:
                self.first_chunk_t = time.perf_counter()
            return out

        pipe._start_segment = start_segment
        engine.decode_chunk = decode_chunk
        pipeline._handle_chunk = handle_chunk

    def close(self):
        self._engine.decode_chunk = self._decode_chunk
        self._pipeline._handle_chunk = self._handle_chunk

    def take(self) -> list[dict]:
        """The segments recorded since the last call (device tensors; see
        :func:`host_segments`)."""
        out, self.segments = self.segments, []
        return out


def host_segments(segments: list[dict]) -> list[dict]:
    """Recorded segments as host arrays: codes, their pre-quantization
    values, n and every token served."""
    return [{"codes": s["codes"].cpu().numpy(), "z": s["z"][: s["n"]].float().cpu().numpy(),
             "n": s["n"],
             "tokens": np.concatenate([p.reshape(-1).cpu().numpy() for p in s["parts"]])}
            for s in segments]


def recording_server(pipe, slots: int, adm_batch: int, depth: int):
    """A ``StreamServer`` that records each (stream, segment)'s codes, their
    pre-quantization values and tokens, and each dispatch's occupied rows
    and their depths."""
    from genvc_tpu_torch.serving.server import StreamServer

    for name in ("_start_on_shard", "_dispatch_tick", "warmup_admission"):
        hook(StreamServer, name)

    class RecordingServer(StreamServer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            for name in ("_slot_map", "_inflight", "_pending_adm"):
                if not hasattr(self, name):
                    raise RuntimeError(f"the benchmark reads StreamServer.{name}, which the "
                                       "program no longer has")
            self.rec: dict = {}        # (sid, segment) -> codes, n, parts, depth
            self.dispatches: list = []  # (host time, [(prefix keys, depth)...]) per tick
            self.admissions: list = []  # (host time, [(t_real, n, prefix keys)...], fast steps)

        def _start_on_shard(self, shard, streams, slots):
            import time

            pipe = shard.pipe
            start, seen, latents = hook(pipe, "_start_segment"), [], []

            def spy(*args, **kwargs):
                out = start(*args, **kwargs)
                seen.append(out)
                return out

            pipe._start_segment = spy
            record_latents(pipe.content_dvae, latents)
            try:
                super()._start_on_shard(shard, streams, slots)
            finally:
                del pipe._start_segment
                del pipe.content_dvae.nearest_codes
            _, tok0, _, codes, n_codes = seen[0]
            fast = 0
            rows = []
            for i, (s, slot) in enumerate(zip(streams, slots)):
                parts = [tok0[i: i + 1]]
                pending = self._pending_adm.get(slot)
                if pending is not None and pending[1] == i:
                    parts.append((_host(pending[0]), i))
                    fast = _host(pending[0]).shape[1]
                keys = pipe.gpt_cfg.n_cond_latents + n_codes[i] + 2
                self.rec[(s.sid, s.seg_idx)] = {"codes": codes[i], "z": latents[0][i],
                                                "n": n_codes[i],
                                                "parts": parts, "depth": 1 + fast,
                                                "keys": keys}
                rows.append((s.segments[s.seg_idx][1], n_codes[i], keys))
            self.admissions.append((time.perf_counter(), rows, fast))

        def _dispatch_tick(self):
            import time

            snap = {slot: (s.sid, s.seg_idx) for slot, s in self._slot_map.items()}
            super()._dispatch_tick()
            tick, _ = self._inflight[-1]
            rows = []
            for shard, res in tick.parts:
                for slot, key in snap.items():
                    if shard.start <= slot < shard.start + len(shard.carry):
                        r = self.rec[key]
                        r["parts"].append((_host(res), slot - shard.start))
                        rows.append((r["keys"], r["depth"]))
                        r["depth"] += _host(res).shape[1]
            self.dispatches.append((time.perf_counter(), rows))

        def served(self, sid: int) -> list[dict]:
            """The stream's segments: codes and tokens, as host arrays."""
            out, seg = [], 0
            while (sid, seg) in self.rec:
                r = self.rec[(sid, seg)]
                toks = [r["parts"][0].reshape(-1).cpu().numpy()]
                toks += [np.asarray(host[row]) for host, row in r["parts"][1:]]
                out.append({"codes": r["codes"].cpu().numpy(),
                            "z": r["z"][: r["n"]].float().cpu().numpy(), "n": r["n"],
                            "tokens": np.concatenate(toks)})
                seg += 1
            return out

    return RecordingServer(pipe, slots=slots, depth=depth, adm_batch=adm_batch)


def _host(res):
    """The host copy of a dispatched decode's tokens."""
    if not hasattr(res, "_host"):
        raise RuntimeError("the benchmark reads a dispatch's _host tokens, which the program "
                           "no longer keeps")
    return res._host[0]


def gpt_trainer(cfg: dict, trees: dict, meta: str, loader_seed: int, device) -> dict:
    """The stage-3 training state, step, frozen tokenizers and loader of the
    configuration, over the benchmark's weight trees and corpus."""
    from genvc_tpu_torch import checkpoint as ckpt
    from genvc_tpu_torch import resolve_device
    from genvc_tpu_torch.data.dataset import VCDatasetConfig, VCWaveDataset
    from genvc_tpu_torch.data.loader import BatchLoader
    from genvc_tpu_torch.models import gpt as gpt_model
    from genvc_tpu_torch.train import gpt_stage, optim

    tr = cfg["train"]
    device = resolve_device(device)   # as the port's runner: TF32 off
    gcfg = train_config(cfg)
    frozen = gpt_stage.make_frozen(gcfg, {k: trees[k] for k in
                                          ("contentvec", "acoustic_dvae", "content_dvae")},
                                   np.load(cfg["style_mel"]["norms_file"]), device)
    with torch.device("meta"):
        model = gpt_model.GPT(ckpt.gpt_config(gcfg))
    ckpt.assign(model, trees["gpt"], device)
    params = optim.FlatParams(model)
    tx = optim.adamw_grouped(tr["lr"], betas=tuple(tr["betas"]), eps=tr["eps"],
                             weight_decay=tr["weight_decay"],
                             max_grad_norm=tr["max_grad_norm"], params=params).init(params.flat)
    state = gpt_stage.GPTTrainState(model, params, tx)
    step, _ = gpt_stage.make_train_step(
        text_ce_weight=tr["text_ce_weight"], mel_ce_weight=tr["mel_ce_weight"],
        fix_condition_embeddings=tr["fix_condition_embeddings"],
        compute_dtype=None if cfg["gpt"]["dtype"] == "float32" else _DTYPES[cfg["gpt"]["dtype"]],
        attn_impl=cfg["gpt"]["attention"])
    ds = VCWaveDataset(VCDatasetConfig(
        meta_file=meta, sample_rate=tr["sample_rate"], text_frame_rate=tr["text_frame_rate"],
        min_text_len=tr["min_text_len"], max_text_len=tr["max_text_len"],
        min_conditioning_length=tr["min_conditioning_length"],
        max_conditioning_length=tr["max_conditioning_length"],
        use_masking_gt_prompt_approach=tr["use_masking_gt_prompt_approach"],
        text_bucket=tr["text_bucket"], cond_bucket=tr["cond_bucket"]), seed=loader_seed)
    loader = BatchLoader(ds, tr["batch_size"], shuffle=True, num_workers=tr["loader_workers"],
                         prefetch=tr["loader_prefetch"], seed=loader_seed)
    return {"state": state, "step": step, "frozen": frozen, "loader": loader}


def train_config(cfg: dict):
    """The program's stage-3 ``GenVCConfig`` for the configuration file."""
    from genvc_tpu_torch.train_genVC import recipe_config

    c = recipe_config("", "", cfg["style_mel"]["norms_file"], "", "", "")
    g, ma = cfg["gpt"], c.model_args
    ma.gpt_layers, ma.gpt_n_model_channels, ma.gpt_n_heads = g["layers"], g["model_dim"], g["heads"]
    for name, vc in (("content_dvae", c.content_dvae_config),
                     ("acoustic_dvae", c.acoustic_dvae_config)):
        d = cfg[name]
        vc.num_channels, vc.num_tokens, vc.codebook_dim = d["channels"], d["num_tokens"], d["codebook_dim"]
        vc.hidden_dim, vc.num_resnet_blocks = d["hidden_dim"], d["num_resnet_blocks"]
        vc.kernel_size, vc.num_layers = d["kernel_size"], d["num_layers"]
    return c
