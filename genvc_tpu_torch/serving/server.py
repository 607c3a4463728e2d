"""Continuous-batching streaming VC server (``genvc_tpu/serving/server.py``):
a fixed pool of decode slots on one card, with streams admitted and retired
at 8-token tick boundaries.

The lockstep batch (``GenVCPipeline.synthesize_streaming_batch``) starts all
its streams together and holds every row to the slowest row's segment round;
the server keeps a ``slots``-row decode pool ticking, admits a waiting stream
the moment a slot frees (``engine.insert_rows``), and retires each stream on
its own. Per-stream audio is that of ``synthesize_streaming`` with
``first_chunk_tokens == first_window``: the same windows, the same EOS / cap
remainder vocoding, the same 1024-sample crossfade, the same progression
through 6 s segments.

Engine mechanics: pool rows sit at different decode depths, so the pool's
``DecodeState`` has per-row positions (``init_state(per_row=True)``), and its
decode step runs the per-row kernel ``ops.decode_attention_update_layer``
(each row's K/V written at its own position, then the attention) in every
GPT block. A tick is ``pipeline.stream_chunk_batch``: 8 decode steps, then
the completed 8-latent window of every row vocoded. Admission prefills
waiting streams in WAVES of up to ``adm_batch`` (power-of-two buckets), one
batched prefill and one batched slot insertion per wave. Streams may carry
their own decode parameters (``submit(sampler=...)``); a tick threads (B,)
parameter tensors through the per-row sampling chain only while some active
slot has such a config.

Asynchrony: a tick's tokens, finished flags and audio are copied to pinned
host memory without blocking, behind a CUDA event; ``depth`` ticks are kept
in flight, so the host enqueues tick N+1 while the card still runs tick N.
A slot re-admitted while ticks are in flight has their stale rows skipped
(per-slot epochs). On the CPU every result is ready at once.

Sharding (``mesh=``, the JAX server's scale-out serving): the pool splits
over the mesh's first axis into ``slots / n`` rows per shard, each shard
with its own ``DecodeState``, carry and per-row parameters on its device;
the weights are copied once per distinct device and shared by the shards
on one device. A slot maps to (shard, local row). A tick launches shard by
shard without waiting, so shards on different cards overlap; its results
come back per shard. With one shard (no mesh) the code is the one-card
server's.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from collections import deque

import numpy as np
import torch

from genvc_tpu_torch import tracing
from genvc_tpu_torch.decode import engine
from genvc_tpu_torch.inference.pipeline import (CROSSFADE, STREAM_CHUNK, _handle_chunk,
                                                window_accounting)

_PARAM_DTYPES = {"temperature": torch.float32, "top_k": torch.long, "top_p": torch.float32,
                 "repetition_penalty": torch.float32, "do_sample": torch.bool}


class QueueFull(RuntimeError):
    """``submit`` refused: the admission queue holds ``max_queue`` streams.

    Backpressure for producers: catch it and retry after draining
    (``step``/``drain``) or shed the request upstream."""


@dataclasses.dataclass
class _Stream:
    sid: int
    segments: list                 # [(padded 16 kHz segment, true length), ...]
    cond: torch.Tensor             # (1, 32, D) speaker latents (device)
    submit_t: float
    audio_samples: int             # true source length (16 kHz samples)
    seg_idx: int = 0
    n_total: int = 0               # tokens incl. the prefill token, this segment
    max_new: int = 0
    first_tick: bool = True
    chunks: list = dataclasses.field(default_factory=list)
    overlap: np.ndarray | None = None
    latency: float | None = None
    admit_t: float | None = None   # first slot admission (queue wait ends)
    done_t: float | None = None
    on_chunk: object = None        # optional per-stream chunk callback
    callback_error: str | None = None
    sampler: object = None         # the stream's decode config (None: the pipe's)


@dataclasses.dataclass(eq=False)
class _Shard:
    """A contiguous range of the pool's slots, on one device."""

    pipe: object                   # the pipeline whose weights sit on the device
    start: int                     # first global slot
    pool: engine.DecodeState
    carry: torch.Tensor            # (rows, 1, D)
    row_params: dict               # (rows,) tensors


def _indexed(device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` names the current card, so
    ``cuda`` and ``cuda:0`` compare equal there."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _replica(pipe, device):
    """``pipe`` with its modules copied to ``device``."""
    rep = copy.copy(pipe)
    rep.device = device
    for name in ("gpt", "hifigan", "content_dvae", "contentvec"):
        setattr(rep, name, copy.deepcopy(getattr(pipe, name)).to(device))
    rep.mel_norms = torch.as_tensor(pipe.mel_norms).to(device)
    rep.generator = torch.Generator(device=device).manual_seed(pipe.generator.initial_seed())
    rep._cond_latent = None
    return rep


class _Tick:
    """One pool tick's per-shard results, read as the whole pool's rows."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = parts  # [(shard, _Result)]

    def fetch(self):
        fetched = [r.fetch() for _, r in self.parts]
        return [np.concatenate(xs) for xs in zip(*fetched)]

    def lats(self, slot: int):
        """(the slot's shard, that shard's latents, the slot's local row)."""
        for shard, r in self.parts:
            if shard.start <= slot < shard.start + len(shard.carry):
                return shard, r.all_lats, slot - shard.start
        raise IndexError(slot)


class _Result:
    """One dispatch's results. The latents stay on the device (an EOS
    remainder's vocode reads them); tokens, finished-before-step flags and
    audio are copied to pinned host memory without blocking, behind a CUDA
    event (JAX's ``copy_to_host_async`` / ``is_ready``). ``ready()`` asks the
    event, ``fetch()`` waits for it and returns numpy arrays; on the CPU both
    hold at once. A fast-first admission wave shares one among its slots."""

    __slots__ = ("all_lats", "_host", "_event")

    def __init__(self, toks, all_lats, pre_fin, wavs):
        self.all_lats = all_lats
        self._host, self._event = (toks, pre_fin, wavs), None
        if all_lats.device.type == "cuda":
            self._host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                               for t in (toks, pre_fin, wavs))
            for h, t in zip(self._host, (toks, pre_fin, wavs)):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def fetch(self):
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


def _np(wav) -> np.ndarray:
    return wav.float().cpu().numpy()


class StreamServer:
    """Slot-pool server over a built ``GenVCPipeline``.

    Usage::

        server = StreamServer(pipe, slots=8)
        sid = server.submit(src_wav, ref_audio)   # any time
        server.step()                             # admit + one 8-token tick
        ...
        server.drain()                            # run until all streams done
        wav, stats = server.result(sid)
    """

    @torch.inference_mode()
    def __init__(self, pipe, slots: int = 8, depth: int = 2, mesh=None,
                 max_queue: int | None = None, first_window: int | None = None,
                 adm_batch: int = 4):
        """``max_queue`` (optional): cap on WAITING streams; a ``submit``
        past it raises :class:`QueueFull` before any device work.

        ``first_window`` (default: the pipeline's ``first_chunk_tokens``): size
        in AR tokens of each stream's first emitted window. Below STREAM_CHUNK
        the admission runs fast-first: the admitted rows decode
        ``first_window`` tokens and vocode that window before they enter the
        pool, so a stream's first audio does not wait for a full pool tick.
        Later windows and segments keep the 8-token pool cadence.

        ``adm_batch`` (default 4): largest admission wave. Waiting streams
        are prefilled together in power-of-two buckets up to it; 1 admits
        one stream at a time. :meth:`warmup_admission` runs each bucket once.

        ``depth`` (default 2): ticks kept in flight; 1 is synchronous.

        ``mesh`` (optional ``parallel.mesh.Mesh``, one process): shard the
        slot pool over the mesh's FIRST axis, ``slots / n`` rows per device
        (a device may repeat). ``slots`` must divide over it
        (``ValueError``)."""
        self.pipe = pipe
        self.slots = int(slots)
        devices = [pipe.device] if mesh is None else list(mesh.devices[:, 0])
        if self.slots % len(devices):
            raise ValueError(f"slots={self.slots} must divide over mesh axis "
                             f"'{mesh.axis_names[0]}' ({len(devices)} devices)")
        ab = max(1, int(adm_batch))
        self._adm_buckets = tuple(b for b in (1, 2, 4, 8, 16, 32) if b <= ab)
        fw = pipe.first_chunk_tokens if first_window is None else int(first_window)
        self.first_window = max(1, min(int(fw), STREAM_CHUNK))
        self.max_queue = None if max_queue is None else int(max_queue)
        self.depth = max(1, int(depth))
        self._queue: deque[_Stream] = deque()
        self._slot_map: dict[int, _Stream] = {}
        self._free = list(range(self.slots))
        self._results: dict[int, tuple[np.ndarray, dict]] = {}
        self._next_sid = 0
        self._inflight: deque = deque()   # (tick _Result, epoch snapshot)
        # fast-first admission results awaiting host processing, by slot
        self._pending_adm: dict[int, tuple[_Result, int]] = {}
        self._slot_epoch = [0] * self.slots
        self._cancelled: set[int] = set()
        # slots whose stream has its own sampler: only then do ticks take the
        # per-row sampling chain
        self._slot_custom = [False] * self.slots
        self._n_ticks = 0
        self._occupancy_sum = 0
        self._n_admissions = 0
        self._n_completed = 0
        self._n_cancelled = 0
        self._n_rejected = 0
        self._adm_steps = 0  # decode steps of fast-first admission rows

        gcfg = pipe.gpt_cfg
        rows = self.slots // len(devices)
        pipes = {}  # one copy of the weights per distinct device
        self._shards = []
        home = _indexed(pipe.device)
        for i, dev in enumerate(devices):
            dev = _indexed(dev)
            if dev not in pipes:
                pipes[dev] = pipe if dev == home else _replica(pipe, dev)
            sp = pipes[dev]
            pool = engine.init_state(gcfg, sp._prefix_width, rows, sp.device,
                                     cache_dtype=sp.cache_dtype, generator=sp.generator,
                                     gen_tokens=sp._cache_gen_tokens(), per_row=True)
            # never-occupied slots tick too: one valid key each keeps their
            # softmax defined (all-masked keys give NaN latents), and they
            # are finished
            pool.key_valid[:, 0] = True
            pool.finished.fill_(True)
            self._shards.append(_Shard(
                sp, i * rows, pool, torch.zeros(rows, 1, gcfg.model_dim, device=sp.device),
                # per-slot decode parameters; idle slots hold the pipeline's
                self._sampler_values([pipe.sampler] * rows, sp.device)))

    def _shard(self, slot: int) -> _Shard:
        return self._shards[slot // (self.slots // len(self._shards))]

    @staticmethod
    def _sampler_values(samplers, device) -> dict:
        """SamplerConfigs as the (B,) tensors of ``row_params`` on ``device``."""
        return {k: torch.tensor([getattr(s, k) for s in samplers], dtype=dt, device=device)
                for k, dt in _PARAM_DTYPES.items()}

    # ------------------------------------------------------------- submit

    def submit(self, src_wav: np.ndarray, ref_audio: np.ndarray, on_chunk=None,
               sampler=None, arrival_t: float | None = None) -> int:
        """Register a stream (any time). The speaker latents are computed now;
        decoding starts when a slot frees at a later ``step``.

        ``on_chunk(sid, chunk)`` (optional) receives each crossfaded 24 kHz
        chunk as it is emitted; a raising callback is disabled for that
        stream and recorded in its stats (``callback_error``).

        ``sampler`` (optional ``SamplerConfig``): this stream's decode
        parameters; default the pipeline's.

        ``arrival_t`` (optional ``time.perf_counter()`` time) backdates the
        arrival: latency, queue wait and RTF count from it (the
        coordinated-omission correction of a load generator).

        Raises :class:`QueueFull`, before any device work, when the server
        has ``max_queue`` and that many streams wait."""
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            self._n_rejected += 1
            raise QueueFull(f"admission queue full ({len(self._queue)} waiting >= "
                            f"max_queue={self.max_queue}); drain with step() or retry")
        sid = self._next_sid
        self._next_sid += 1
        stream = _Stream(
            sid=sid, segments=list(self.pipe._segments(src_wav)),
            cond=self.pipe.get_gpt_cond_latents(ref_audio),
            submit_t=time.perf_counter() if arrival_t is None else float(arrival_t),
            audio_samples=int(src_wav.shape[-1]), on_chunk=on_chunk, sampler=sampler)
        if not stream.segments:  # zero-length source: retire at once
            self._results[sid] = (np.zeros((0,), np.float32), {
                "latency_s": None, "queue_wait_s": None, "service_s": None,
                "wall_s": 0.0, "audio_s": 0.0, "rtf": None, "rtf_service": None,
                "callback_error": None, "cancelled": False})
            return sid
        self._queue.append(stream)
        return sid

    # ---------------------------------------------------------- admission

    def _start_segments(self, streams: list, slots: list):
        """Prefill one segment per stream and insert the rows into ``slots``:
        one batched prefill and one batched insertion per shard that the
        slots fall in (:meth:`_start_on_shard`)."""
        groups = {}
        for s, slot in zip(streams, slots):
            groups.setdefault(id(self._shard(slot)), []).append((s, slot))
        for group in groups.values():
            self._start_on_shard(self._shard(group[0][1]), *map(list, zip(*group)))

    def _start_on_shard(self, shard: _Shard, streams: list, slots: list):
        """Prefill one segment per stream (one batched prefill) and insert
        the rows into ``slots`` of ``shard`` (one batched insertion).

        With fast-first (``first_window < STREAM_CHUNK``, segment 0 only) the
        rows first decode ``first_window`` tokens and their first windows are
        vocoded; they enter the pool carrying latent ``first_window``, so pool
        ticks continue the window alignment of ``synthesize_streaming``. That
        result is not read here: it is kept per slot in ``_pending_adm`` and
        processed by ``step`` once it reaches the host (or before any later
        tick's data for the slot), where a segment that ended inside the first
        window is handled."""
        pipe = shard.pipe
        fw = self.first_window
        segs, t_reals = [], []
        for s in streams:
            seg, t_real = s.segments[s.seg_idx]
            s.max_new = pipe._max_new(pipe._host_n_codes(t_real))
            segs.append(seg[0])
            t_reals.append(t_real)
        values = self._sampler_values([s.sampler or pipe.sampler for s in streams],
                                      pipe.device)
        rows, _, lat0, _, _ = pipe._start_segment(
            np.stack(segs), t_reals, torch.cat([s.cond for s in streams]).to(pipe.device),
            per_row=True, row_params=values)
        pending = None
        if streams[0].seg_idx == 0 and fw < STREAM_CHUNK:
            toks, lats, pre_fin = engine.decode_chunk(pipe.gpt, rows, pipe.sampler,
                                                      chunk=fw, row_params=values)
            self._adm_steps += rows.steps
            all_lats = torch.cat([lat0[:, None], lats], dim=1)
            pending = _Result(toks, all_lats, pre_fin, pipe.vocode(all_lats[:, :fw]))
            carry = all_lats[:, fw]              # latent fw: the next window's carry
            for s in streams:
                s.n_total = 1 + fw
                s.first_tick = False             # prefill EOS handled with the result
        else:
            carry = lat0
            for s in streams:
                s.n_total = 1
                s.first_tick = True
        local = [slot - shard.start for slot in slots]
        engine.insert_rows(shard.pool, rows, local)
        idx = torch.as_tensor(local, dtype=torch.long, device=pipe.device)
        shard.carry[idx] = carry[:, None].to(shard.carry.dtype)
        for k, v in shard.row_params.items():
            v[idx] = values[k]
        for i, (s, slot) in enumerate(zip(streams, slots)):
            self._slot_epoch[slot] += 1  # ticks in flight hold stale data for it
            self._slot_custom[slot] = s.sampler is not None
            if pending is not None:
                self._pending_adm[slot] = (pending, i)

    def _process_admission(self, slot: int, force: bool):
        """Emit the pending fast-first window of ``slot`` (and the EOS tail
        when the segment ended inside it, advancing the slot). Without
        ``force`` it returns when the result is not on the host yet; ``force``
        waits, and is used only once a later tick's result is on the host."""
        ent = self._pending_adm.get(slot)
        if ent is None:
            return
        rec, i = ent
        if not force and not rec.ready():
            return
        del self._pending_adm[slot]
        s = self._slot_map[slot]
        if s.sid in self._cancelled:
            return  # the tick loop's cancel branch retires the stream
        pipe = self._shard(slot).pipe
        fw = self.first_window
        toks_np, pre_np, wavs_np = rec.fetch()
        if bool(pre_np[i, 0]):
            # EOS at the prefill-sampled token: vocode just its latent
            self._emit(s, _np(pipe._vocode_tail(rec.all_lats, i, 0, 1, fw)))
            self._advance(s, slot)
            return
        eos_j, _, full, rem = window_accounting(toks_np[i], 1, s.max_new,
                                                pipe.gpt_cfg.stop_audio_token,
                                                carry_n=1, win=fw)
        if full >= 1:
            self._emit(s, wavs_np[i])
        if eos_j is not None:
            if rem > 0:
                self._emit(s, _np(pipe._vocode_tail(rec.all_lats, i, full * fw, rem, fw)))
            self._advance(s, slot)

    def _admit(self):
        while self._queue and self._free:
            # the next wave: up to the largest bucket that fits the waiting
            # streams and the free slots; what is not a bucket goes back to
            # the head of the queue, so FIFO order holds
            cap = min(len(self._free), self._adm_buckets[-1])
            wave = []
            while self._queue and len(wave) < cap:
                stream = self._queue.popleft()
                if stream.sid in self._cancelled:
                    self._finalize(stream, cancelled=True)
                    continue
                wave.append(stream)
            if not wave:
                continue
            b = max(x for x in self._adm_buckets if x <= len(wave))
            for s in reversed(wave[b:]):
                self._queue.appendleft(s)
            wave = wave[:b]
            slots = [self._free.pop(0) for _ in wave]
            now = time.perf_counter()
            for s, slot in zip(wave, slots):
                self._slot_map[slot] = s
                self._n_admissions += 1
                if s.admit_t is None:
                    s.admit_t = now
            with tracing.span("genvc.admit"):
                self._start_segments(wave, slots)

    @torch.inference_mode()
    def warmup_admission(self, buckets=None):
        """Run the admission path once at each wave size this server can
        admit (the batched prefill, with fast-first its decode steps, window
        vocode and EOS-tail vocode), on silence, and discard the results:
        the first wave of each size then does not pay the card's first-use
        costs while streams wait. The pool is not touched."""
        fw = self.first_window
        fastfirst = fw < STREAM_CHUNK
        want = [b for b in (buckets or self._adm_buckets)
                if b <= self.slots // len(self._shards)]
        if fastfirst and 1 not in want:
            want.append(1)  # segment advances prefill one row
        for pipe in {id(sh.pipe): sh.pipe for sh in self._shards}.values():
            width = pipe._seg_len_16k
            cond1 = pipe.get_gpt_cond_latents(np.zeros((1, pipe.sample_rate), np.float32))
            for b in sorted(want):
                values = self._sampler_values([pipe.sampler] * b, pipe.device)
                rows, _, lat0, _, _ = pipe._start_segment(
                    np.zeros((b, width), np.float32), [width] * b, cond1.expand(b, -1, -1),
                    per_row=True, row_params=values)
                if fastfirst:
                    _, lats, _ = engine.decode_chunk(pipe.gpt, rows, pipe.sampler, chunk=fw,
                                                     row_params=values)
                    all_lats = torch.cat([lat0[:, None], lats], dim=1)
                    pipe.vocode(all_lats[:, :fw])
                    pipe._vocode_tail(all_lats, 0, 0, 1, fw)
            if pipe.device.type == "cuda":
                torch.cuda.synchronize(pipe.device)

    def cancel(self, sid: int):
        """Cancel a stream. Queued: finalized (empty) at the next admission
        pass; active: its slot frees at the next processed tick; finished: no
        effect. The result keeps the audio emitted so far, with
        ``stats['cancelled'] = True``."""
        if sid not in self._results:
            self._cancelled.add(sid)

    # -------------------------------------------------------------- ticks

    def _dispatch_tick(self):
        self._n_ticks += 1
        self._occupancy_sum += len(self._slot_map)
        k = STREAM_CHUNK
        custom = any(self._slot_custom)
        parts = []
        for shard in self._shards:  # launched one after the other, no wait
            toks, all_lats, pre_fin, wavs = shard.pipe.stream_chunk_batch(
                shard.pool, k, shard.carry, win=k,
                row_params=shard.row_params if custom else None)
            # a copy: admissions write the carry in place, and this tick's
            # latents stay in use until its result is processed
            shard.carry = all_lats[:, k : k + 1].clone()
            parts.append((shard, _Result(toks, all_lats, pre_fin, wavs)))
        self._inflight.append((_Tick(parts), list(self._slot_epoch)))

    @torch.inference_mode()
    def step(self) -> bool:
        """Admit waiting streams, keep ``depth`` 8-token pool ticks in flight,
        and process the oldest tick's results. Returns False when the pool is
        idle and the queue empty."""
        self._admit()
        # emit the fast-first windows that already reached the host
        for slot in list(self._pending_adm):
            self._process_admission(slot, force=False)
        if not self._slot_map and not self._inflight:
            return False
        while self._slot_map and len(self._inflight) < self.depth:
            with tracing.span("genvc.tick"):
                self._dispatch_tick()
        if not self._inflight:
            return False
        tick, epochs = self._inflight.popleft()
        with tracing.span("genvc.fetch"):
            toks_np, pre_fin_np, wavs_np = tick.fetch()

        k = STREAM_CHUNK
        stop = self.pipe.gpt_cfg.stop_audio_token
        for slot in sorted(self._slot_map):
            if slot in self._pending_adm:
                # the admission window goes out before any tick data of the
                # slot; this tick was dispatched after it, so it is on the host
                self._process_admission(slot, force=True)
                if slot not in self._slot_map:
                    continue  # the segment ended at admission: stream retired
                # a segment advance re-inserted the slot: the epoch check
                # below skips this tick's stale row
            s = self._slot_map[slot]
            if s.sid in self._cancelled:
                self._finalize(s, cancelled=True)
                self._release(slot)
                continue
            if epochs[slot] != self._slot_epoch[slot]:
                # dispatched before the slot's current stream or segment was
                # inserted: the row belongs to the previous occupant
                continue
            seg_done = False
            shard, lats, row = tick.lats(slot)
            if s.first_tick and bool(pre_fin_np[slot, 0]):
                # EOS at the prefill-sampled token: vocode just its latent
                self._emit(s, _np(shard.pipe._vocode_tail(lats, row, 0, 1, k)))
                seg_done = True
            else:
                # every tick carries one latent and decodes k = win tokens:
                # at most one full window (carry_n = 1)
                eos_j, _, full, rem = window_accounting(
                    toks_np[slot], s.n_total, s.max_new, stop, carry_n=1, win=k)
                if full >= 1:
                    self._emit(s, wavs_np[slot, 0])
                if eos_j is not None:
                    if rem > 0:
                        self._emit(s, _np(shard.pipe._vocode_tail(lats, row,
                                                                  full * k, rem, k)))
                    seg_done = True
                else:
                    s.n_total += k
            s.first_tick = False
            if seg_done:
                self._advance(s, slot)
        return True

    def _emit(self, s: _Stream, wav_window: np.ndarray):
        chunk, s.overlap = _handle_chunk(wav_window, s.overlap, CROSSFADE)
        s.chunks.append(chunk)
        if s.latency is None:
            s.latency = time.perf_counter() - s.submit_t
        if s.on_chunk is not None:
            try:
                s.on_chunk(s.sid, chunk)
            except Exception as e:  # a client callback must not stop the pool
                s.callback_error = f"{type(e).__name__}: {e}"
                s.on_chunk = None

    def _finalize(self, s: _Stream, cancelled: bool = False):
        s.done_t = time.perf_counter()
        wav = np.concatenate(s.chunks, axis=-1) if s.chunks else np.zeros((0,), np.float32)
        wall = s.done_t - s.submit_t
        audio_s = s.audio_samples / self.pipe.content_sample_rate
        queue_wait = s.admit_t - s.submit_t if s.admit_t is not None else None
        service = s.done_t - s.admit_t if s.admit_t is not None else None
        self._results[s.sid] = (wav, {
            "latency_s": s.latency,          # submit -> first audio (incl. queue)
            "queue_wait_s": queue_wait,      # submit -> slot admission
            "service_s": service,            # admission -> retirement
            "wall_s": wall,
            "audio_s": audio_s,
            "rtf": wall / audio_s if audio_s > 0 else None,
            # without the queue wait: what a capacity planner holds against 1.0
            "rtf_service": (service / audio_s
                            if service is not None and audio_s > 0 else None),
            "callback_error": s.callback_error,
            "cancelled": cancelled,
        })
        self._n_completed += 1
        if cancelled:
            self._n_cancelled += 1
        self._cancelled.discard(s.sid)

    def _release(self, slot: int):
        del self._slot_map[slot]
        self._pending_adm.pop(slot, None)
        self._slot_custom[slot] = False
        self._free.append(slot)
        self._free.sort()

    def _advance(self, s: _Stream, slot: int):
        s.seg_idx += 1
        if s.seg_idx < len(s.segments) and s.sid not in self._cancelled:
            # later segments enter the pool directly (fast-first is segment 0)
            self._start_segments([s], [slot])
            return
        self._finalize(s, cancelled=s.sid in self._cancelled)
        self._release(slot)

    # ------------------------------------------------------------ results

    def drain(self):
        """Run ticks until every submitted stream has retired."""
        while self.step():
            pass

    def finished(self, sid: int) -> bool:
        return sid in self._results

    def result(self, sid: int):
        """(wav, stats) of a finished stream; stats: latency_s (submit ->
        first audio), queue_wait_s, service_s, wall_s, audio_s, rtf (wall /
        audio, queue included), rtf_service, callback_error, cancelled."""
        return self._results[sid]

    def pop_result(self, sid: int):
        """:meth:`result`, releasing the stored audio (for a long-running
        server)."""
        return self._results.pop(sid)

    def metrics(self) -> dict:
        """Pool counters: ticks, mean slot occupancy over dispatched ticks,
        admissions, completions, cancels, rejections, queue depth, active
        slots, stored results, and the per-row decode steps run (pool ticks
        and fast-first admissions; each runs the update kernel once per GPT
        block)."""
        return {
            "slots": self.slots,
            "ticks": self._n_ticks,
            "mean_occupancy": (self._occupancy_sum / self._n_ticks
                               if self._n_ticks else 0.0),
            "admissions": self._n_admissions,
            "completed": self._n_completed,
            "cancelled": self._n_cancelled,
            "rejected": self._n_rejected,
            "queued": len(self._queue),
            "active": len(self._slot_map),
            "pending_results": len(self._results),
            "decode_steps": sum(sh.pool.steps for sh in self._shards) + self._adm_steps,
        }
