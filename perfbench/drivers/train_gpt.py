"""GPT training (stage 3): ``gpt_stage.make_train_step``'s step fed by the
port's ``VCWaveDataset`` and ``BatchLoader``.

Set-up writes the seed's corpus under the temporary directory, draws the
weights on the card, builds the frozen tokenizers, the GPT on its flat f32
master vector and AdamW, and drives that one training state through its
first ``checked_steps`` steps on the loader's batches, then
``widest_steps`` steps on a batch of the longest texts and conditioning (so
the allocator has grown to the window's widest shapes). The window then
runs steps on the next batches until ``--seconds`` have passed, and waits
for the last.
``train_audio_s_per_s`` is the 24 kHz audio of the steps' rows over that
time. With ``--trace 1`` the window's first ``trace_steps`` steps are
traced, and traced again on the next steps while the trace lost device
records.

The check follows the checked steps: each step's loss, the first gradient
as the optimizer took it (Adam's first moment after one step over 1 - b1),
the parameters' change after the last, and the tokenizers' codes, against
the plain reference from the same weights and batches.
"""

from __future__ import annotations

import contextlib
import gc
import os
import random
import statistics
import tempfile

import numpy as np
import torch

from perfbench import corpus, program, trace
from perfbench.drivers import common
from perfbench.reference import check_train


class _Widest(random.Random):
    """Draws that always take the upper end: the longest texts and
    conditioning a batch can have."""

    def randint(self, a, b):
        return b


def _cycle(loader):
    while True:
        yield from loader


def _to_device(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(common.DEVICE, non_blocking=True)
            for k, v in batch.items()}


def run(cell: dict, args, process_start: float) -> dict:
    from genvc_tpu_torch.ops import flash_attention as fa
    from genvc_tpu_torch.train import gpt_stage

    cfg, mix = cell["config"], cell["traffic"]
    seed = args.seed
    meta = corpus.write(common.ROOT, mix, seed,
                        os.path.join(tempfile.gettempdir(), "perfbench_corpus"))
    trees = common.draw_training(cfg, seed)
    built = program.gpt_trainer(cfg, trees, meta, mix["loader_seed"], common.DEVICE)
    del trees
    state, step, frozen, loader = built["state"], built["step"], built["frozen"], built["loader"]
    names = list(state.params.names)
    sizes = list(state.params.sizes)
    b1 = cfg["train"]["betas"][0]

    seen: list = []
    keep = {"on": True, "latents": True}
    prepare = program.hook(gpt_stage, "prepare_features")
    audio_z: list = []
    text_z: list = []
    program.record_latents(frozen.acoustic_dvae, audio_z, lambda: keep["latents"])
    program.record_latents(frozen.content_dvae, text_z, lambda: keep["latents"])

    def recorded(*a, **k):
        out = prepare(*a, **k)
        if keep["on"]:
            seen.append(out)
        return out

    gpt_stage.prepare_features = recorded
    batches = _cycle(loader)
    checked, losses, mu1 = [], [], None
    try:
        for i in range(cell["checked_steps"]):
            batch = _to_device(next(batches))
            state, m = step(state, batch, frozen)
            checked.append(batch)
            losses.append(m["loss"].detach().clone())
            if i == 0:
                mu1 = state.opt.mu.detach().to("cpu", copy=True)
        flat_after = state.params.flat.detach().to("cpu", copy=True)
        codes = [{"audio": f["audio_codes"], "text": f["text_inputs"]} for f in seen]
        latents = [{"audio": a.cpu(), "text": t.cpu()} for a, t in zip(audio_z, text_z)]
        seen.clear()
        keep["on"] = keep["latents"] = False
        widest = _to_device(loader.dataset.collate(list(range(loader.batch_size)), _Widest()))
        for _ in range(cell["widest_steps"]):
            state, _ = step(state, widest, frozen)
        torch.cuda.synchronize()

        k_names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")
        steps, waits, traces = [], [], []
        t0 = common.now()
        setup_s = t0 - process_start
        while common.now() - t0 < args.seconds:
            tracing = args.trace and len(traces) < cell["trace_tries"] and \
                (not traces or not traces[-1][1])
            n = cell["trace_steps"] if tracing else 1
            before = (fa.flash_attention.launches, fa.flash_attention_dq.launches,
                      fa.flash_attention_dkdv.launches)
            region: list = []
            group = []
            keep["on"] = bool(tracing)
            ctx = trace.traced(region) if tracing else contextlib.nullcontext()
            with ctx:
                for _ in range(n):
                    a = common.now()
                    host = next(batches)
                    batch = _to_device(host)
                    waits.append(common.now() - a)
                    state, _ = step(state, batch, frozen)
                    group.append({"audio_s": float(host["wav_lengths"].sum()) / cfg["train"]["sample_rate"],
                                  "batch": {k: np.asarray(v) for k, v in host.items()
                                            if k != "wav" and k != "conditioning"}})
            steps += group
            if tracing:
                tr = region[0]
                after = (fa.flash_attention.launches, fa.flash_attention_dq.launches,
                         fa.flash_attention_dkdv.launches)
                whole = tr.whole() and all(tr.count(kn) >= b - a for kn, a, b in
                                           zip(k_names, before, after))
                feats = [{k: tuple(v.shape) for k, v in f.items() if torch.is_tensor(v)}
                         for f in seen]
                seen.clear()
                traces.append((tr, whole, group, feats))
                if not whole:
                    common.note(f"trace {len(traces)}: {len(tr.kernels)} device records for "
                                f"{tr.launches} launches: taken again")
        torch.cuda.synchronize()
        t_end = common.now()
    finally:
        gpt_stage.prepare_features = prepare
    if args.trace and not (traces and traces[-1][1]):
        raise RuntimeError(f"no whole trace in {len(traces)} tries")
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    codes = [{k: v.cpu() for k, v in c.items()} for c in codes]
    del state, step, frozen, loader, built, batches, seen
    gc.collect()
    torch.cuda.empty_cache()

    prog = {"losses": losses, "names": names, "sizes": sizes, "grad1": mu1 / (1.0 - b1),
            "flat_after": flat_after, "codes": codes, "latents": latents}
    judged = check_train.judge(cfg, seed, checked, prog, cell["reference_rows"],
                               control=getattr(args, "control", False))
    numbers = judged["program"]
    end_to_end = {"setup_s": setup_s,
                  "train_audio_s_per_s": sum(s["audio_s"] for s in steps) / (t_end - t0)}
    common.note(f"window: {len(steps)} steps, {t_end - t0:.3f} s, data wait median "
                f"{statistics.median(waits) * 1e3:.3f} ms, setup {setup_s:.3f} s")
    record = None
    if args.trace:
        tr, _, group, feats = traces[-1]
        record = {"cell": "train_gpt", "cfg": cfg, "trace": tr, "steps": group,
                  "feats": feats, "waits": waits}
    return {"correct": check_train.verdict(numbers), "attempted": len(steps), "failed": 0,
            "end_to_end": end_to_end, "memory_peak_bytes": peak, "numbers": numbers,
            "limits": dict(check_train.LIMITS), "record": record,
            "control": judged.get("control"), "half_batch": judged.get("half_batch")}

