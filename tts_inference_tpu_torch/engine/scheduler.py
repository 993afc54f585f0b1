"""Continuous-batching scheduler: multi-stream serving over one EngineCore.

Port of ``tts_inference_tpu/engine/scheduler.py``:

- one EngineCore with B slots; per-slot sampling knobs are tensors, so one
  decode loop serves any mix of requests;
- admission batch-prefills pending requests into free slots in one fused
  launch (prefill + decode steps for every live slot); masked cache writes
  and restored sampling rows leave mid-generation neighbours untouched;
- the fused admission vocode decodes every admitted slot's first chunk on
  the device from the admission's token tensor (one vocoder call: a
  CUDA-graph replay per first-chunk geometry on the card, as the worker's
  batched window decodes are per row and frame bucket; ``warmup``
  captures both);
- each tick fetches one launch's tokens (the next is already running —
  depth-2 pipelining), feeds per-request extractors and lookahead decoders,
  and hands every stream's pending window to a two-stage vocode worker
  (launch thread + fetch/emit thread);
- admission order is FIFO or shortest-job-first with aging
  (``admission_policy``), and ``reserved_short_slots`` keep slots for short
  requests; with paged KV a capacity gate holds requests the block pool
  cannot take yet (``_held``), and with ``kv_on_demand`` a launch whose
  block growth the pool cannot cover first preempts the youngest stream,
  which later resumes by re-prefill and a restore of its sampling state —
  bit-identical to an uninterrupted run;
- ``stagger_chunks``, cancel and the watchdog behave as in the JAX package;
- ``use_native`` routes each stream's token extraction and window
  de-interleave through the C++ runtime (``utils/native.py`` over
  ``native/tts_runtime.cpp``; ``serve --native-protocol``), and raises when
  that library cannot be built — it never falls back to Python;
- ``pipeline_depth`` (launches in flight, default 2) and
  ``enable_tick_profile`` / ``tick_profile`` (wall seconds per tick phase,
  the JAX package's six keys) are the surface ``bench.py`` drives.

Under a (dp, tp) mesh the core is this rank's shard (``mesh=``), and
lockstep serving wraps it (``wrap_core=``, ``parallel/lockstep.py``): every
call that enters the device is mirrored to the follower processes first.
A mirror that lost a follower is fatal (``fatal``, ``on_fatal``): every
stream ends with an error, new requests are refused with "engine down",
and the run loop returns so that the server can exit nonzero. The vocoder
stays local to this process, and so does the fused admission vocode: the
admission launch returns the whole batch's token rows on every rank.

All threads launch on one CUDA stream, so their device work serializes.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from tts_inference_tpu_torch import protocol
from tts_inference_tpu_torch.config import Config, SamplingConfig, StreamConfig
from tts_inference_tpu_torch.utils.audio import pcm16_bytes
from tts_inference_tpu_torch.utils.tokenizer import TokenizerProtocol
from tts_inference_tpu_torch.engine.engine import EngineCore
from tts_inference_tpu_torch.models.snac import SnacDecoder
from tts_inference_tpu_torch.ops import sampling as S
from tts_inference_tpu_torch.streaming.lookahead import \
    LookaheadStreamingDecoder
from tts_inference_tpu_torch.streaming.pipeline import (AudioChunk,
                                                        StreamMetrics,
                                                        first_chunk_geometry,
                                                        first_chunk_launch,
                                                        warmup_first_chunks)
from tts_inference_tpu_torch.utils import copy_async, native, to_numpy

log = logging.getLogger("tts_inference_tpu_torch.scheduler")

_req_counter = itertools.count(1)


@dataclasses.dataclass
class TTSRequest:
    """A queued/streaming synthesis request. Consumers drain `events`:
    ("chunk", AudioChunk)* then ("done", StreamMetrics), or ("error", msg)."""

    text: str
    voice: str = "tara"
    sampling: SamplingConfig = dataclasses.field(default_factory=SamplingConfig)
    stream_cfg: StreamConfig = dataclasses.field(default_factory=StreamConfig)
    force_speech: bool = False
    noise_seed: int = 0
    # declared output budget for admission order and KV reservation (None =
    # sampling.max_tokens)
    budget_tokens: Optional[int] = None

    id: int = dataclasses.field(default_factory=lambda: next(_req_counter))
    events: "queue.Queue" = dataclasses.field(default_factory=queue.Queue)
    submitted_at: float = dataclasses.field(default_factory=time.perf_counter)
    cancelled: bool = False
    # set while the request waits to resume after a preemption
    _resume_state: Optional["_SlotState"] = dataclasses.field(
        default=None, init=False, repr=False)

    def cancel(self) -> None:
        self.cancelled = True

    def iter_chunks(self, timeout: Optional[float] = None):
        """Blocking iterator over the audio chunks; returns on done, raises
        RuntimeError on error (``queue.Empty`` after `timeout` seconds
        without an event)."""
        while True:
            kind, payload = self.events.get(timeout=timeout)
            if kind == "chunk":
                yield payload
            elif kind == "done":
                return
            else:
                raise RuntimeError(payload)


class _SlotState:
    """Host-side runtime of a request while it occupies a slot."""

    def __init__(self, req: TTSRequest, scheduler: "Scheduler"):
        self.req = req
        restart = req.stream_cfg.extraction == "last_sos"
        if scheduler.use_native:
            self.extractor = native.NativeExtractor(
                restart_on_sos=restart, started=req.force_speech)
        else:
            self.extractor = protocol.TokenExtractor(restart_on_sos=restart)
            if req.force_speech:
                self.extractor.started = True
        self.lookahead = LookaheadStreamingDecoder(
            scheduler.vocoder, req.stream_cfg, req.noise_seed,
            use_native=scheduler.use_native)
        self.metrics = StreamMetrics()
        self.produced = 0
        self.chunk_index = 0
        self._restarts_seen = 0
        self.t0 = time.perf_counter()
        # preemption resume: the raw token stream (the re-prefill input)
        # and the sampling-state snapshot taken at preemption
        self.prompt_ids: List[int] = []
        self.token_ids: List[int] = []
        self.resume_snapshot: Optional[dict] = None

    def _ms(self) -> float:
        return (time.perf_counter() - self.t0) * 1000.0

    def on_tokens(self, tokens: List[int], eos_id: int) -> bool:
        """Feed decoded tokens; True when the request is finished. Audio is
        decoded by the vocode worker, batched across streams."""
        if self.req.cancelled:
            return True
        if not self.metrics.ttft_ms:
            self.metrics.ttft_ms = self._ms()
        finished = False
        budget = self.req.sampling.max_tokens - self.produced
        row: List[int] = []
        for t in tokens[:budget]:
            row.append(t)
            if t == eos_id:
                finished = True
                break
        self.produced += len(row)
        self.token_ids.extend(int(t) for t in row)
        self.metrics.tokens = self.produced
        codes = self.extractor.feed_many(row)
        if self.extractor.restart_count != self._restarts_seen:
            self._restarts_seen = self.extractor.restart_count
            if self.metrics.chunks == 0:
                self.lookahead = LookaheadStreamingDecoder(
                    self.lookahead.decoder, self.req.stream_cfg,
                    self.req.noise_seed, use_native=self.lookahead.use_native)
        if codes:
            self.lookahead.feed(codes)
        if self.extractor.finished:
            finished = True
        if self.produced >= self.req.sampling.max_tokens:
            finished = True
        return finished

    def _emit(self, samples: np.ndarray) -> None:
        if not self.metrics.ttfa_ms:
            self.metrics.ttfa_ms = self._ms()
        self.chunk_index += 1
        self.metrics.chunks = self.chunk_index
        self.metrics.audio_duration_ms += \
            len(samples) / protocol.SAMPLE_RATE * 1000.0
        self.req.events.put(("chunk", AudioChunk(
            pcm16_bytes(samples), self.chunk_index, len(samples))))

    def finish(self) -> None:
        self.metrics.frames = self.lookahead.total_frames
        self.metrics.generation_time_ms = self._ms()
        self.metrics.ttfa_ms = self.metrics.ttfa_ms \
            or self.metrics.generation_time_ms
        self.req.events.put(("done", self.metrics.finalize()))


class Scheduler:
    """Fixed-slot continuous batching over one EngineCore."""

    def __init__(self, params, config: Config, vocoder: SnacDecoder,
                 tokenizer: TokenizerProtocol, *,
                 eos_id: int = protocol.TOKEN_EOS, seed: int = 0,
                 device=None, use_native: bool = False, mesh=None,
                 wrap_core=None, graphs: bool = True):
        ecfg = config.engine
        if use_native:
            native.load()   # raises when the library cannot be built
        self.use_native = use_native
        self.config = config
        self.vocoder = vocoder
        self.tokenizer = tokenizer
        self.eos_id = eos_id
        self.core = EngineCore(params, config.model, ecfg, eos_id=eos_id,
                               seed=seed, device=device, mesh=mesh,
                               graphs=graphs)
        if wrap_core is not None:
            # lockstep serving: every device-entering call is mirrored to
            # the follower processes (parallel/lockstep.py)
            self.core = wrap_core(self.core)
        b = self.core.batch
        self.slots: List[Optional[_SlotState]] = [None] * b
        self.pending: "queue.Queue[TTSRequest]" = queue.Queue()
        self._last_tok = np.zeros(b, np.int32)
        self._active = np.zeros(b, bool)
        self._sp = {
            "temperature": np.full(b, 0.6, np.float32),
            "top_p": np.full(b, 0.95, np.float32),
            "top_k": np.zeros(b, np.int32),
            "repetition_penalty": np.full(b, 1.1, np.float32),
            "allowed_min": np.zeros(b, np.int32),
            "allowed_max": np.zeros(b, np.int32),
            "frame_protocol": np.zeros(b, bool),
        }
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._wakeup = threading.Event()
        self._geo_warned: set = set()
        # two-stage vocode worker: stage 1 launches, stage 2 fetches and
        # emits; maxsize=2 on both bounds chunk bunching and keeps batches
        # aggregating frames (JAX package measurements)
        self._vocode_q: "queue.Queue" = queue.Queue(maxsize=2)
        self._emit_q: "queue.Queue" = queue.Queue(maxsize=2)
        self._vocode_thread: Optional[threading.Thread] = None
        self._emit_thread: Optional[threading.Thread] = None
        self._vocode_pending = 0
        self._vocode_plock = threading.Lock()
        # the admission launch decodes enough steps to cover the default
        # first chunk, so the fused admission vocode is live under `serve`
        first_codes, _, _ = first_chunk_geometry(
            config.stream, vocoder.cfg.samples_per_frame)
        self.admission_steps = max(2 * ecfg.decode_steps_per_call,
                                   first_codes - 1)
        self._inflight = collections.deque()
        # launches in flight: one fetched while the next runs
        self.pipeline_depth = 2
        # requests that fit a free slot but not the paged-KV pool wait here,
        # ahead of the backlog, until blocks free up
        self._held = collections.deque()
        # `pending` is only the cross-thread handoff; the scheduler thread
        # drains it here and the admission policy picks from this list
        self._backlog: List[TTSRequest] = []
        self.preemptions = 0    # kv_on_demand preempt-and-resume events
        self.watchdog_s: float = 120.0
        self._last_progress = time.perf_counter()
        # a fatal engine loss (a lockstep follower died: the mesh can never
        # complete another collective): set once, refuses all new work,
        # reported by /health; on_fatal(msg) lets the server exit nonzero
        self.fatal: Optional[str] = None
        self.on_fatal = None
        # tick-phase profile: wall seconds per step() phase, once enabled
        self._prof: Optional[dict] = None

    def enable_tick_profile(self) -> None:
        """Accumulate wall seconds per step() phase into ``tick_profile``:
        the fetch of a launch's tokens, the host token processing, the
        fused first chunks' emission, the vocode planning, and the
        admission and decode launches (``ticks``: launches fetched)."""
        self._prof = {"fetch_s": 0.0, "host_tokens_s": 0.0,
                      "fused_pcm_s": 0.0, "vocode_plan_s": 0.0,
                      "admit_launch_s": 0.0, "ticks": 0}

    @property
    def tick_profile(self) -> Optional[dict]:
        return dict(self._prof) if self._prof is not None else None

    def _lap(self, key: str, t: float) -> float:
        """Add the seconds since `t` to the profile's `key`; returns now."""
        now = time.perf_counter()
        if self._prof is not None:
            self._prof[key] += now - t
        return now

    # -- public API -----------------------------------------------------------

    def submit(self, req: TTSRequest) -> TTSRequest:
        if self.fatal is not None:
            req.events.put(("error", f"engine down: {self.fatal}"))
            return req
        self.pending.put(req)
        self._wakeup.set()
        return req

    def synthesize_request(self, req: TTSRequest):
        """Submit + the request's blocking chunk iterator (waits at most the
        server's request timeout for each event)."""
        self.submit(req)
        return req.iter_chunks(timeout=self.config.server.request_timeout_s)

    def warmup(self) -> dict:
        """Capture every engine launch this scheduler can make
        (``EngineCore.warmup_graphs`` over the fused admission's step counts
        and the decode launch's), and every vocoder call: the batched window
        decode of each (row bucket, frame bucket) the vocode worker can
        meet and the fused first-chunk decode at the core's batch (the CPU
        runs no vocoder call here). Returns the engine's graph census and
        the vocoder's."""
        info = self.core.warmup_graphs(
            admission_ns=[self.admission_steps,
                          self.config.engine.decode_steps_per_call])
        voc = self.vocoder
        with torch.no_grad():
            voc.warmup_graphs(self.core.batch)
            warmup_first_chunks(voc, self.core.batch,
                                self.first_chunk_geometries(),
                                self.core.device)
        return {**info, **voc.census()}

    def first_chunk_geometries(self) -> list:
        """The fused first chunk's geometries (n_codes, nf, emit) this
        scheduler decodes: the default stream's, where it fits the
        admission burst."""
        geo = first_chunk_geometry(self.config.stream,
                                   self.vocoder.cfg.samples_per_frame)
        return [geo] if geo[0] <= self.admission_steps + 1 else []

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._ensure_vocode_worker()
        self._thread = threading.Thread(target=self.run_forever,
                                        name="tts-scheduler", daemon=True)
        self._thread.start()

    def _ensure_vocode_worker(self) -> None:
        if self._vocode_thread is None or not self._vocode_thread.is_alive():
            self._vocode_thread = threading.Thread(
                target=self._vocode_worker, name="tts-vocoder", daemon=True)
            self._vocode_thread.start()
        if self._emit_thread is None or not self._emit_thread.is_alive():
            self._emit_thread = threading.Thread(
                target=self._emit_worker, name="tts-vocoder-emit",
                daemon=True)
            self._emit_thread.start()

    def _vq_put(self, item) -> None:
        with self._vocode_plock:
            self._vocode_pending += 1
        self._vocode_q.put(item)

    def _vq_done(self, n: int = 1) -> None:
        with self._vocode_plock:
            self._vocode_pending -= n

    def drain_vocoder(self, timeout: float = 60.0) -> None:
        """Block until every queued vocode/finish job has been emitted."""
        deadline = time.perf_counter() + timeout
        while self._vocode_pending > 0:
            if time.perf_counter() > deadline:
                raise TimeoutError("vocoder queue did not drain")
            time.sleep(0.002)

    def stop(self) -> None:
        self._stop.set()
        self._wakeup.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        if self._vocode_thread is not None:
            self._vocode_q.put(None)
            self._vocode_thread.join(timeout=30)
            self._vocode_thread = None
        if self._emit_thread is not None:
            self._emit_thread.join(timeout=30)  # sentinel forwarded by stage 1
            self._emit_thread = None

    @property
    def n_active(self) -> int:
        return int(self._active.sum())

    @property
    def n_queued(self) -> int:
        """Requests waiting for a slot: handoff queue, policy backlog and
        capacity-held."""
        return self.pending.qsize() + len(self._backlog) + len(self._held)

    def _drop_queued(self, req: TTSRequest) -> None:
        """Remove `req` from whichever wait container holds it."""
        for box in (self._held, self._backlog):
            if req in box:
                box.remove(req)
                return

    # -- scheduler loop ---------------------------------------------------------

    def _sampling_params(self) -> S.SamplingParams:
        dev = self.core.device
        return S.SamplingParams(**{
            k: torch.from_numpy(v.copy()).to(dev) for k, v in self._sp.items()
        })

    def _build_prompt(self, req: TTSRequest) -> List[int]:
        ids = self.tokenizer.encode(protocol.format_prompt_text(
            req.text[: protocol.MAX_TEXT_CHARS], req.voice))
        return protocol.format_prompt_ids(ids, force_speech=req.force_speech)

    def _warn_geo(self, geo, why: str) -> None:
        if geo in self._geo_warned:
            return
        self._geo_warned.add(geo)
        log.info("fused admission vocode disabled for geometry "
                 "(n_codes=%d, nf=%d, emit=%d): %s", *geo, why)

    def _launch_admit_pcm(self, toks_d, batch):
        """Chain the batched first-chunk decode onto a fresh admission
        launch. Returns (eligible_slots, pcm, ok, nf, emit) host copies, or
        None. Eligible = force_speech requests whose first-chunk geometry
        matches the first one admitted and fits the admission burst."""
        geo = None
        eligible = []
        spf = self.vocoder.cfg.samples_per_frame
        for slot, req, _ in batch:
            if not req.force_speech:
                continue
            g = first_chunk_geometry(req.stream_cfg, spf)
            if g[0] > toks_d.shape[1] or req.sampling.max_tokens < g[0]:
                self._warn_geo(g, "first chunk exceeds the admission burst")
                continue
            if geo is None:
                geo = g
            if g == geo:
                eligible.append(slot)
        if not eligible:
            return None
        n_codes, nf, emit = geo
        seeds = np.zeros(self.core.batch, np.int64)
        for slot, req, _ in batch:
            seeds[slot] = req.noise_seed & 0xFFFFFFFF
        pcm_h, ok_h = first_chunk_launch(
            self.vocoder, toks_d, n_codes, nf, emit, torch.from_numpy(seeds))
        return (eligible, pcm_h, ok_h, nf, emit)

    def _set_sp_row(self, slot: int, sp: SamplingConfig) -> None:
        self._sp["temperature"][slot] = 0.0 if sp.greedy else sp.temperature
        self._sp["top_p"][slot] = sp.top_p
        self._sp["top_k"][slot] = 1 if sp.greedy else sp.top_k
        self._sp["repetition_penalty"][slot] = sp.repetition_penalty
        lo, hi = sp.token_range or (0, 0)
        self._sp["allowed_min"][slot] = lo
        self._sp["allowed_max"][slot] = hi
        self._sp["frame_protocol"][slot] = sp.frame_protocol

    def _admit_resume(self, resumes) -> bool:
        """Re-admit preempted requests: re-prefill prompt + generated[:-1]
        at a resume bucket, restore the sampling-state snapshot and set
        last_tok, so the next decode launch continues the stream exactly.
        Runs only with an empty launch pipeline (step() admits then); the
        prefill's own sampled token and state are overwritten."""
        did = False
        for slot, req, prompt in resumes:
            state = req._resume_state
            req._resume_state = None
            if req.cancelled:
                req.events.put(("done", StreamMetrics()))
                continue
            bucket = self.core.resume_bucket_len(len(prompt))
            if bucket is None:
                req.events.put(("error",
                                "resume re-prefill exceeds resume_buckets"))
                continue
            self.slots[slot] = state
            self._set_sp_row(slot, req.sampling)
            self.core.prefill_slots([prompt], [slot], self._sampling_params(),
                                    seeds=[None], bucket=bucket)
            self.core.restore_slot(slot, state.resume_snapshot)
            state.resume_snapshot = None
            self._last_tok[slot] = state.token_ids[-1]
            self._active[slot] = True
            did = True
        return did

    def _capacity_gate(self, batch: List[tuple]) -> None:
        """Paged KV: drop the newest candidates from `batch` into the held
        queue until what the rest take fits the free blocks.

        With kv_on_demand, what they take includes the growth of the
        admission launch, which decodes every live slot and every admitted
        one for admission_steps: the live slots' deficit and, per fresh
        slot, its prefill window plus those steps. The JAX gate counted
        only the reservations, so an admission (or a resume followed by a
        decode launch) could take the blocks the live slots were about to
        grow into, and the launch then failed with the pool exhausted —
        under serving traffic, where requests arrive after the preemption
        dry run of the same step.

        With the prefix cache a fresh request's demand counts prefix_len on
        top of its bucket, as the JAX gate does, and a resume's the prefix
        its re-prefill will inject: the resume re-prefill goes through the
        prefix cache and reserves prefix + resume bucket + slack, which the
        JAX gate, counting the bucket alone, could not cover on a tight
        pool."""
        ecfg = self.config.engine
        bs_blk = ecfg.kv_block_size
        slack = ecfg.decode_steps_per_call + 1
        max_seq = self.core.max_seq
        pfx = ecfg.prefix_len if ecfg.prefix_cache else 0
        grow = 0
        if ecfg.kv_on_demand:
            grow = bs_blk * sum(
                self.core._blocks_deficit(self.admission_steps).values())

        def entry_demand(r, p, fresh_bucket):
            if r._resume_state is not None:
                b = self.core.resume_bucket_len(len(p)) or max_seq
                total = min(self.core.prefix_cut(len(p)) + b + slack + 1,
                            max_seq)
            elif ecfg.kv_on_demand:
                # prefill window, grown through the admission launch; later
                # growth is on demand, and preemption covers exhaustion
                total = min(fresh_bucket + pfx + self.admission_steps + 2,
                            max_seq)
            else:
                total = min(fresh_bucket + pfx + self._budget(r) + slack,
                            max_seq)
            return -(-total // bs_blk) * bs_blk

        while batch:
            fresh = [len(p) for _, r, p in batch if r._resume_state is None]
            fresh_bucket = self.core.bucket_len(max(fresh)) if fresh else 0
            demand = sum(entry_demand(r, p, fresh_bucket)
                         for _, r, p in batch)
            if demand + grow <= self.core.free_tokens():
                return
            _, req, _ = batch.pop()     # defer the newest candidate
            self._held.appendleft(req)

    @staticmethod
    def _budget(r: TTSRequest) -> int:
        return r.budget_tokens or r.sampling.max_tokens

    def _admit(self) -> bool:
        """Admit waiting requests into free slots with ONE fused prefill +
        decode launch (preempted requests resume first, by re-prefill); True
        if anything was admitted. Candidates: held requests first (already
        chosen, deferred only by the capacity gate), then the backlog in
        policy order."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        while True:
            try:
                self._backlog.append(self.pending.get_nowait())
            except queue.Empty:
                break
        ecfg = self.config.engine
        # slots >= long_cutoff admit only short requests, so a burst of
        # long jobs never takes every slot
        long_cutoff = len(self.slots) - ecfg.reserved_short_slots
        ordered = list(self._backlog)
        if ecfg.admission_policy == "sjf" and len(ordered) > 1:
            # shortest job first with aging: the effective length shrinks
            # by max_output_len per sjf_aging_ms waited; the sort is
            # stable, so equal scores keep arrival order
            now = time.perf_counter()
            rate = ecfg.max_output_len / max(ecfg.sjf_aging_ms, 1e-6)
            ordered.sort(key=lambda r: self._budget(r)
                         - rate * (now - r.submitted_at) * 1000.0)
        batch: List[tuple] = []
        for req in list(self._held) + ordered:
            if not free:
                break
            if req.cancelled:
                req.events.put(("done", StreamMetrics()))
                self._drop_queued(req)
                continue
            if self._budget(req) <= ecfg.short_request_tokens:
                # prefer a reserved slot, so general slots stay open
                slot = max(free) if max(free) >= long_cutoff else free[0]
            else:
                general = [sl for sl in free if sl < long_cutoff]
                if not general:
                    continue   # a long request waits for a general slot
                slot = general[0]
            free.remove(slot)
            self._drop_queued(req)
            rs = req._resume_state
            if rs is not None:
                # resume: re-prefill prompt + generated so far; the last
                # token re-enters as last_tok and the next decode step
                # writes its KV, as in a live stream
                batch.append((slot, req, rs.prompt_ids + rs.token_ids[:-1]))
            else:
                batch.append((slot, req, self._build_prompt(req)))
        if ecfg.paged_kv and batch:
            self._capacity_gate(batch)
        resumes = [e for e in batch if e[1]._resume_state is not None]
        batch = [e for e in batch if e[1]._resume_state is None]
        did = self._admit_resume(resumes) if resumes else False
        if not batch:
            return did
        prompts, slots_idx, seeds, extras = [], [], [], []
        for slot, req, prompt in batch:
            state = _SlotState(req, self)
            state.prompt_ids = list(prompt)
            c = max(1, req.stream_cfg.frames_per_chunk)
            if req.stream_cfg.stagger_chunks and len(self.slots) >= 4 * c:
                # de-phase this stream's chunk boundary by its slot index
                # (only past ~4 rows per de-phased tick, as in the JAX
                # package)
                state.lookahead.chunk_phase = slot % c
            self.slots[slot] = state
            prompts.append(prompt)
            slots_idx.append(slot)
            seeds.append(req.sampling.seed if req.sampling.seed is not None
                         else req.id)
            extras.append(self._budget(req))
            self._set_sp_row(slot, req.sampling)
        sp_arr = self._sampling_params()
        toks, tok, act = self.core.prefill_decode_launch(
            prompts, slots_idx, sp_arr, self._last_tok, self._active,
            n=self.admission_steps, reserve_extra=extras, seeds=seeds)
        with torch.no_grad():
            fused_pcm = self._launch_admit_pcm(toks, batch)
        admitted = set(slots_idx)
        # output column 0 repeats the last (already processed) token of
        # slots that were active before this admission
        skip_first = np.array([self._active[s] and s not in admitted
                               for s in range(len(self.slots))])
        for slot in slots_idx:
            self._active[slot] = True
        self._inflight.append(
            ((toks, tok, act), copy_async(toks, tok, act), sp_arr,
             self._launch_ids(), skip_first, fused_pcm))
        return True

    def _release(self, slot: int) -> None:
        self.slots[slot] = None
        self._active[slot] = False
        if self.config.engine.paged_kv and self.fatal is None:
            # release the blocks at once so held requests can admit; a
            # launch still in flight wrote them before anything enqueued
            # later can reuse them (one stream)
            self.core._free_slot_blocks([slot])

    def _vocode_tick(self, finishing: List[int]) -> None:
        """Plan every stream's pending window and hand the batch to the
        vocode worker; emission bookkeeping commits here."""
        jobs = []
        for slot, state in enumerate(self.slots):
            if state is None or state.req.cancelled:
                continue
            plan = state.lookahead.plan(flush=slot in finishing)
            if plan is not None:
                layers = state.lookahead.window_layers(plan)
                state.lookahead.commit(plan)
                jobs.append((state, plan, layers))
        if jobs:
            self._vq_put(("decode", jobs))

    def _vocode_worker(self) -> None:
        """Stage 1: launch each batched decode (and its device→host copy)."""
        while True:
            item = self._vocode_q.get()
            if item is None:
                self._emit_q.put(None)
                return
            kind, payload = item
            if kind == "decode":
                try:
                    t0 = time.perf_counter()
                    with torch.no_grad():
                        handle = self.vocoder.decode_frames_batch_launch(
                            [layers for _, _, layers in payload],
                            first_frames=[pl.w0 for _, pl, _ in payload],
                            noise_seeds=[st.lookahead.noise_seed
                                         for st, _, _ in payload])
                    self._emit_q.put(("decode", (payload, handle, t0)))
                except Exception as e:  # noqa: BLE001 — fail these streams
                    log.exception("vocoder launch failed")
                    for st, _, _ in payload:
                        st.req.events.put(("error", f"vocoder error: {e}"))
                    self._vq_done()
            else:  # "finish"
                self._emit_q.put(item)

    def _emit_worker(self) -> None:
        """Stage 2: blocking fetch + chunk emission + finish events."""
        while True:
            item = self._emit_q.get()
            if item is None:
                return
            kind, payload = item
            if kind == "decode":
                jobs, handle, t0 = payload
                try:
                    outs = self.vocoder.decode_frames_batch_fetch(handle)
                    decode_ms = (time.perf_counter() - t0) * 1000.0
                    for (state, plan, _), audio in zip(jobs, outs):
                        if state.req.cancelled:
                            continue
                        state.metrics.decode_times_ms.append(
                            decode_ms / len(jobs))
                        samples = audio[plan.lo: plan.hi]
                        if len(samples):
                            state._emit(samples)
                except Exception as e:  # noqa: BLE001 — fail these streams
                    log.exception("vocoder fetch failed")
                    for st, _, _ in jobs:
                        st.req.events.put(("error", f"vocoder error: {e}"))
                finally:
                    self._vq_done()
            else:  # "finish"
                try:
                    payload.finish()
                except Exception as e:  # noqa: BLE001
                    payload.req.events.put(("error", f"vocoder error: {e}"))
                finally:
                    self._vq_done()

    def _launch_ids(self):
        return [s.req.id if s is not None else None for s in self.slots]

    def _consume_one(self) -> bool:
        """Fetch + process the oldest in-flight launch."""
        if not self._inflight:
            return False
        (_, hosts, _, launch_ids, skip_first,
         fused_pcm) = self._inflight.popleft()
        t = time.perf_counter()
        toks = to_numpy(hosts[0])         # overlaps the in-flight launch
        self._last_tok = to_numpy(hosts[1]).copy()
        active = to_numpy(hosts[2])
        t = self._lap("fetch_s", t)
        if self._prof is not None:
            self._prof["ticks"] += 1
        finishing = []
        for slot, state in enumerate(self.slots):
            if state is None or launch_ids[slot] != state.req.id:
                continue
            if not self._active[slot]:
                continue
            row = toks[slot]
            if skip_first is not None and skip_first[slot]:
                row = row[1:]   # fused-admission repeat of the last token
            finished = state.on_tokens([int(t) for t in row], self.eos_id)
            if finished or not active[slot]:
                finishing.append(slot)
        t = self._lap("host_tokens_s", t)
        if fused_pcm is not None:
            # emit eligible slots' first chunks from the device decode; the
            # fused decode covered EXACTLY frames [0, nf)
            f_slots, pcm_h, ok_h, nf, emit = fused_pcm
            okv, pcm = to_numpy(ok_h), to_numpy(pcm_h)
            for sl in f_slots:
                state = self.slots[sl]
                if (state is None or launch_ids[sl] != state.req.id
                        or sl in finishing or not okv[sl]
                        or state.req.cancelled or state.metrics.chunks):
                    continue
                la = state.lookahead
                plan = la.plan()
                if (plan is None or plan.w0 != 0 or plan.lo != 0
                        or plan.w1 != nf or plan.hi != emit):
                    continue
                la.commit(plan)
                state.metrics.decode_times_ms.append(0.0)
                state._emit(pcm[sl])
        t = self._lap("fused_pcm_s", t)
        self._vocode_tick(finishing)
        self._lap("vocode_plan_s", t)
        for slot in finishing:
            state = self.slots[slot]
            if state is not None:
                # the done event rides the same FIFO as the decode jobs
                self._vq_put(("finish", state))
            self._release(slot)
        return True

    # -- preemption (EngineConfig.kv_on_demand) --------------------------------

    def _drain_inflight(self) -> None:
        """Fetch and process every in-flight launch: the device sampling
        state has advanced through every launched step, so a preemption
        snapshot is consistent only once the host has those tokens too."""
        while self._inflight:
            self._consume_one()

    def _pick_victim(self) -> Optional[int]:
        """The youngest resumable live stream: highest request id whose
        prompt + generated re-prefill fits a resume bucket."""
        best = None
        for slot, state in enumerate(self.slots):
            if state is None or state.req.cancelled or not state.token_ids:
                continue
            resume_len = len(state.prompt_ids) + len(state.token_ids) - 1
            if self.core.resume_bucket_len(resume_len) is None:
                continue
            if best is None or state.req.id > best[1]:
                best = (slot, state.req.id)
        return best[0] if best is not None else None

    def _preempt(self, slot: int) -> None:
        """Evict a stream from its slot, keeping what its bit-identical
        resume needs: the raw token stream and the sampling-state snapshot.
        The request rejoins the head of the held queue; its emitted audio
        stands, the stream just gaps."""
        state = self.slots[slot]
        state.resume_snapshot = self.core.snapshot_slot(slot)
        self.core.preempt_slot(slot)
        self.slots[slot] = None
        self._active[slot] = False
        state.req._resume_state = state
        self._held.appendleft(state.req)
        self.preemptions += 1

    def _maybe_preempt(self) -> bool:
        """When the pool cannot cover the next launch's on-demand block
        growth, preempt youngest-first until it can. Drains the launch
        pipeline first, so snapshots match the processed stream exactly."""
        ecfg = self.config.engine
        if not (ecfg.paged_kv and ecfg.kv_on_demand):
            return False
        n = ecfg.decode_steps_per_call
        if self._backlog or self._held or not self.pending.empty():
            # an admission launch decodes every live slot for
            # admission_steps: size the dry run to that
            n = max(n, self.admission_steps)
        if not self.core.starved_slots(n):
            return False
        self._drain_inflight()
        while True:
            starved = self.core.starved_slots(n)
            if not starved:
                return True
            victim = self._pick_victim()
            if victim is None:
                # nothing resumable: end the starved streams with a clean
                # error rather than wedge the engine
                for sl in starved:
                    st = self.slots[sl]
                    if st is not None:
                        st.req.events.put((
                            "error", "evicted: KV pool exhausted and stream "
                            "too long to preempt and resume (raise "
                            "kv_pool_tokens or resume_buckets)"))
                        self._release(sl)
                return True
            self._preempt(victim)

    def _push_decode(self, sp, tok, act) -> None:
        nxt = self.core.decode_steps_launch(sp, tok, act)
        self._inflight.append((nxt, copy_async(*nxt), sp, self._launch_ids(),
                               None, None))

    def step(self) -> bool:
        """One scheduler iteration; True if any work was done. While this
        step processes the oldest launch, the next one already runs on the
        device (launched with device-chained tok/active)."""
        self._ensure_vocode_worker()
        did = self._maybe_preempt()
        while (self._inflight and self.pending.empty() and not self._backlog
               and not self._held and self._active.any()
               and len(self._inflight) < self.pipeline_depth):
            (_, tok_d, act_d), _, sp_used, _, _, _ = self._inflight[-1]
            self._push_decode(sp_used, tok_d, act_d)
        did = self._consume_one() or did
        t = time.perf_counter()
        if not self._inflight:
            did = self._admit() or did
            if not self._inflight and self._active.any():
                self._push_decode(self._sampling_params(), self._last_tok,
                                  self._active)
                did = True
        self._lap("admit_launch_s", t)
        return did

    def fail_all(self, message: str) -> None:
        """Fail every live/pending request with an error event."""
        for slot, state in enumerate(self.slots):
            if state is not None:
                state.req.events.put(("error", message))
                self._release(slot)
        while self._held:
            self._held.popleft().events.put(("error", message))
        for req in self._backlog:
            req.events.put(("error", message))
        self._backlog.clear()
        while True:
            try:
                self.pending.get_nowait().events.put(("error", message))
            except queue.Empty:
                break
        self._inflight.clear()

    def run_forever(self) -> None:
        while not self._stop.is_set():
            try:
                did_work = self.step()
            except Exception as e:  # noqa: BLE001 — fail requests, keep serving
                log.exception("scheduler step failed")
                if not getattr(e, "lockstep_fatal", False):
                    # a dead follower can first surface as a collective's
                    # own error: probe the side channel to tell a transient
                    # error from a mesh missing a member
                    probe = getattr(self.core, "lockstep_check", None)
                    if probe is not None:
                        try:
                            probe()
                        except Exception as pe:  # noqa: BLE001
                            if getattr(pe, "lockstep_fatal", False):
                                e = pe
                if getattr(e, "lockstep_fatal", False):
                    # no later step can succeed: stop serving and tell the
                    # server to exit nonzero, so a supervisor restarts the
                    # whole group
                    self.fatal = str(e)
                    self.fail_all(f"engine down: {self.fatal}")
                    self._stop.set()
                    if self.on_fatal is not None:
                        self.on_fatal(self.fatal)
                    return
                self.fail_all(f"scheduler error: {type(e).__name__}: {e}")
                did_work = True
            now = time.perf_counter()
            if did_work:
                self._last_progress = now
            elif (self.n_active or self._held or self._backlog
                  or not self.pending.empty()) \
                    and now - self._last_progress > self.watchdog_s:
                self.fail_all(
                    f"watchdog: no progress for {self.watchdog_s:.0f}s")
                self._last_progress = now
            if not did_work:
                self._wakeup.wait(timeout=0.01)
                self._wakeup.clear()
