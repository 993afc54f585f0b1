"""Continuous-batching scheduler: multi-stream serving over one EngineCore.

Port of ``tts_inference_tpu/engine/scheduler.py`` (FIFO path):

- one EngineCore with B slots; per-slot sampling knobs are tensors, so one
  decode loop serves any mix of requests;
- admission batch-prefills pending requests into free slots in one fused
  launch (prefill + decode steps for every live slot); masked cache writes
  and restored sampling rows leave mid-generation neighbours untouched;
- the fused admission vocode decodes every admitted slot's first chunk on
  the device from the admission's token tensor;
- each tick fetches one launch's tokens (the next is already running —
  depth-2 pipelining), feeds per-request extractors and lookahead decoders,
  and hands every stream's pending window to a two-stage vocode worker
  (launch thread + fetch/emit thread);
- ``stagger_chunks``, cancel and the watchdog behave as in the JAX package.

All threads launch on one CUDA stream, so their device work serializes.
Not ported yet (ROADMAP.md): sjf admission, reserved slots, capacity-held
requests and preemption (they come with paged KV), the native extractor,
lockstep serving.
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

from tts_inference_tpu import protocol
from tts_inference_tpu.config import Config, SamplingConfig, StreamConfig
from tts_inference_tpu.utils.audio import pcm16_bytes
from tts_inference_tpu.utils.tokenizer import TokenizerProtocol
from tts_inference_tpu_torch.engine.engine import EngineCore
from tts_inference_tpu_torch.models.snac import SnacDecoder
from tts_inference_tpu_torch.ops import sampling as S
from tts_inference_tpu_torch.streaming.lookahead import \
    LookaheadStreamingDecoder
from tts_inference_tpu_torch.streaming.pipeline import (AudioChunk,
                                                        StreamMetrics,
                                                        first_chunk_pcm)
from tts_inference_tpu_torch.utils import copy_async, to_numpy

log = logging.getLogger("tts_inference_tpu_torch.scheduler")

_req_counter = itertools.count(1)

PIPELINE_DEPTH = 2   # launches in flight: one fetched while the next runs


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

    id: int = dataclasses.field(default_factory=lambda: next(_req_counter))
    events: "queue.Queue" = dataclasses.field(default_factory=queue.Queue)
    cancelled: bool = False

    def cancel(self) -> None:
        self.cancelled = True


class _SlotState:
    """Host-side runtime of a request while it occupies a slot."""

    def __init__(self, req: TTSRequest, scheduler: "Scheduler"):
        self.req = req
        self.extractor = protocol.TokenExtractor(
            restart_on_sos=(req.stream_cfg.extraction == "last_sos"))
        if req.force_speech:
            self.extractor.started = True
        self.lookahead = LookaheadStreamingDecoder(
            scheduler.vocoder, req.stream_cfg, req.noise_seed)
        self.metrics = StreamMetrics()
        self.produced = 0
        self.chunk_index = 0
        self._restarts_seen = 0
        self.t0 = time.perf_counter()

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
        self.metrics.tokens = self.produced
        codes = self.extractor.feed_many(row)
        if self.extractor.restart_count != self._restarts_seen:
            self._restarts_seen = self.extractor.restart_count
            if self.metrics.chunks == 0:
                self.lookahead = LookaheadStreamingDecoder(
                    self.lookahead.decoder, self.req.stream_cfg,
                    self.req.noise_seed)
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


def _first_chunk_geometry(scfg: StreamConfig, spf: int):
    la = (scfg.first_chunk_lookahead
          if scfg.first_chunk_lookahead is not None
          else scfg.lookahead_frames)
    nf = scfg.first_chunk_frames + la
    return nf * protocol.FRAME_SIZE, nf, scfg.first_chunk_frames * spf


class Scheduler:
    """Fixed-slot continuous batching over one EngineCore."""

    def __init__(self, params, config: Config, vocoder: SnacDecoder,
                 tokenizer: TokenizerProtocol, *,
                 eos_id: int = protocol.TOKEN_EOS, seed: int = 0,
                 device=None):
        ecfg = config.engine
        if ecfg.admission_policy != "fifo" or ecfg.reserved_short_slots:
            raise NotImplementedError(
                "not ported yet: sjf admission / reserved slots "
                "(ROADMAP.md Queue 1 item 11)")
        self.config = config
        self.vocoder = vocoder
        self.tokenizer = tokenizer
        self.eos_id = eos_id
        self.core = EngineCore(params, config.model, ecfg, eos_id=eos_id,
                               seed=seed, device=device)
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
        first_codes, _, _ = _first_chunk_geometry(
            config.stream, vocoder.cfg.samples_per_frame)
        self.admission_steps = max(2 * ecfg.decode_steps_per_call,
                                   first_codes - 1)
        self._inflight = collections.deque()
        self._backlog: List[TTSRequest] = []
        self.watchdog_s: float = 120.0
        self._last_progress = time.perf_counter()

    # -- public API -----------------------------------------------------------

    def submit(self, req: TTSRequest) -> TTSRequest:
        self.pending.put(req)
        self._wakeup.set()
        return req

    def warmup(self) -> dict:
        """Initialise the engine and run the batched vocode and the fused
        first-chunk decode once (kernel build, cuBLAS/cuDNN setup)."""
        info = self.core.warmup_graphs()
        voc = self.vocoder
        fb = voc.frame_buckets[0]
        voc.decode_frames_batch(
            [(np.zeros(fb, np.int32), np.zeros(2 * fb, np.int32),
              np.zeros(4 * fb, np.int32))] * self.core.batch,
            first_frames=[0] * self.core.batch,
            noise_seeds=[0] * self.core.batch)
        n_codes, nf, emit = _first_chunk_geometry(
            self.config.stream, voc.cfg.samples_per_frame)
        if n_codes <= self.admission_steps + 1:
            toks = torch.full((self.core.batch, self.admission_steps + 1),
                              protocol.TOKEN_AUDIO_BASE, dtype=torch.int32,
                              device=self.core.device)
            seeds = torch.zeros(self.core.batch, dtype=torch.int64,
                                device=self.core.device)
            with torch.no_grad():
                to_numpy(first_chunk_pcm(voc, toks, n_codes, nf, emit,
                                         seeds)[0])
        return info

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
        return self.pending.qsize() + len(self._backlog)

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
            g = _first_chunk_geometry(req.stream_cfg, spf)
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
        pcm_d, ok_d = first_chunk_pcm(
            self.vocoder, toks_d, n_codes, nf, emit,
            torch.from_numpy(seeds).to(self.core.device))
        pcm_h, ok_h = copy_async(pcm_d, ok_d)
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

    def _admit(self) -> bool:
        """Admit pending requests FIFO into free slots with ONE fused
        prefill + decode launch; True if a launch was pushed."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        while True:
            try:
                self._backlog.append(self.pending.get_nowait())
            except queue.Empty:
                break
        batch: List[tuple] = []
        for req in list(self._backlog):
            if not free:
                break
            self._backlog.remove(req)
            if req.cancelled:
                req.events.put(("done", StreamMetrics()))
                continue
            batch.append((free.pop(0), req, self._build_prompt(req)))
        if not batch:
            return False
        prompts, slots_idx, seeds = [], [], []
        for slot, req, prompt in batch:
            state = _SlotState(req, self)
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
            self._set_sp_row(slot, req.sampling)
        sp_arr = self._sampling_params()
        toks, tok, act = self.core.prefill_decode_launch(
            prompts, slots_idx, sp_arr, self._last_tok, self._active,
            n=self.admission_steps, seeds=seeds)
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
        toks = to_numpy(hosts[0])         # overlaps the in-flight launch
        self._last_tok = to_numpy(hosts[1]).copy()
        active = to_numpy(hosts[2])
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
        self._vocode_tick(finishing)
        for slot in finishing:
            state = self.slots[slot]
            if state is not None:
                # the done event rides the same FIFO as the decode jobs
                self._vq_put(("finish", state))
            self._release(slot)
        return True

    def _push_decode(self, sp, tok, act) -> None:
        nxt = self.core.decode_steps_launch(sp, tok, act)
        self._inflight.append((nxt, copy_async(*nxt), sp, self._launch_ids(),
                               None, None))

    def step(self) -> bool:
        """One scheduler iteration; True if any work was done. While this
        step processes the oldest launch, the next one already runs on the
        device (launched with device-chained tok/active)."""
        self._ensure_vocode_worker()
        did = False
        while (self._inflight and self.pending.empty() and not self._backlog
               and self._active.any()
               and len(self._inflight) < PIPELINE_DEPTH):
            (_, tok_d, act_d), _, sp_used, _, _, _ = self._inflight[-1]
            self._push_decode(sp_used, tok_d, act_d)
        did = self._consume_one() or did
        if not self._inflight:
            did = self._admit() or did
            if not self._inflight and self._active.any():
                self._push_decode(self._sampling_params(), self._last_tok,
                                  self._active)
                did = True
        return did

    def fail_all(self, message: str) -> None:
        """Fail every live/pending request with an error event."""
        for slot, state in enumerate(self.slots):
            if state is not None:
                state.req.events.put(("error", message))
                self._release(slot)
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
                self.fail_all(f"scheduler error: {type(e).__name__}: {e}")
                did_work = True
            now = time.perf_counter()
            if did_work:
                self._last_progress = now
            elif (self.n_active or self._backlog
                  or not self.pending.empty()) \
                    and now - self._last_progress > self.watchdog_s:
                self.fail_all(
                    f"watchdog: no progress for {self.watchdog_s:.0f}s")
                self._last_progress = now
            if not did_work:
                self._wakeup.wait(timeout=0.01)
                self._wakeup.clear()
