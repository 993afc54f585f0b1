"""Generation engine: prefill + multi-token decode over a fixed slot batch.

Port of the dense path of ``tts_inference_tpu/engine/engine.py``:

- prompts are right-padded to ``EngineConfig.prefill_buckets``; the decode
  attention window is the smallest ``kv_buckets`` entry covering every live
  slot (chosen on the host, no device sync);
- several tokens per host visit (``decode_steps_per_call``, default 7 — one
  audio frame): the JAX ``lax.scan`` becomes a Python loop whose tokens stay
  on the device;
- sampling and EOS handling on the device; finished slots freeze;
- the KV cache and the sampling state live on the core and are updated in
  place where JAX donated buffers;
- launches are asynchronous: ``*_launch`` returns device tensors and
  ``copy_async`` queues their device→host copies (pinned memory + a CUDA
  event), so the host fetches one launch while the next runs (depth-2
  pipelining);
- the KV cache is dense (bf16/f32 or int8) or paged (``paged_kv``; bf16/f32,
  int8, or int4 packed by head pair): a pool of blocks with a host-side
  block allocator, worst-case reservation at
  admission or on-demand growth per decode launch (``kv_on_demand``), and
  ``snapshot_slot``/``restore_slot``/``preempt_slot`` for the scheduler's
  preempt-and-resume.

The block table is device state written from the host. The JAX package
swapped in a fresh immutable array on every change; here every change is
one stream-ordered host→device copy into the same table tensor, so a
launch already enqueued reads the table it was launched with, and a later
prefill into reused blocks runs after every launch that still wrote them.

Not ported yet (ROADMAP.md): prefix cache, meshes, and CUDA-graph capture of
the decode burst.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from tts_inference_tpu_torch import protocol
from tts_inference_tpu_torch.config import (EngineConfig, ModelConfig,
                                            SamplingConfig)
from tts_inference_tpu_torch.utils.timing import PhaseTimer
from tts_inference_tpu_torch.models import llama
from tts_inference_tpu_torch.ops import sampling as S
from tts_inference_tpu_torch.utils import copy_async, to_numpy

__all__ = ["copy_async", "GenerationResult", "EngineCore",
           "GenerationEngine"]


@dataclasses.dataclass
class GenerationResult:
    token_ids: List[int]
    finished: bool
    timings: dict


def _unported(engine_cfg: EngineConfig) -> Optional[str]:
    """The ROADMAP item of the first engine option the port lacks."""
    if engine_cfg.prefix_cache:
        return "prefix cache (ROADMAP.md Queue 1 item 12)"
    return None


class EngineCore:
    """Compute core over a fixed slot batch. Device state lives in
    ``self.cache`` / ``self.sampling_state``."""

    def __init__(self, params, model_cfg: ModelConfig,
                 engine_cfg: EngineConfig, *, batch_size: Optional[int] = None,
                 eos_id: int = protocol.TOKEN_EOS, seed: int = 0,
                 device=None):
        missing = _unported(engine_cfg)
        if missing:
            raise NotImplementedError(f"not ported yet: {missing}")
        self.params = params
        self.model_cfg = model_cfg
        self.engine_cfg = engine_cfg
        self.eos_id = eos_id
        self.device = torch.device(device) if device is not None \
            else params["final_norm"].device
        self.batch = batch_size or engine_cfg.max_batch_size
        self.max_seq = engine_cfg.max_seq_len
        # sliced LM head: every emittable token has id >= HEAD_SLICE_BASE
        self.logits_base = (
            protocol.HEAD_SLICE_BASE
            if engine_cfg.sliced_head
            and model_cfg.vocab_size > protocol.TOKEN_AUDIO_BASE else 0)
        if engine_cfg.kv_cache_int4 and not engine_cfg.paged_kv:
            raise ValueError("kv_cache_int4 requires paged_kv (the dense "
                             "cache has no int4 layout)")
        if engine_cfg.paged_kv:
            bs_blk = engine_cfg.kv_block_size
            if self.max_seq % bs_blk:
                raise ValueError(f"max_seq {self.max_seq} not a multiple of "
                                 f"kv_block_size {bs_blk}")
            pool_tokens = engine_cfg.kv_pool_tokens or max(
                self.max_seq, self.batch * self.max_seq // 2)
            num_blocks = 1 + max(1, pool_tokens // bs_blk)  # +1 trash block
            self.cache = llama.init_paged_kv_cache(
                model_cfg, self.batch, self.max_seq, num_blocks=num_blocks,
                block_size=bs_blk, int8=engine_cfg.kv_cache_int8,
                int4=engine_cfg.kv_cache_int4, device=self.device)
            # host-side block allocator: block 0 is the trash block
            self._free_blocks = list(range(num_blocks - 1, 0, -1))
            self._slot_blocks: dict = {}
            self._table_host = np.zeros(
                (self.batch, self.max_seq // bs_blk), np.int32)
        else:
            self.cache = llama.init_kv_cache(
                model_cfg, self.batch, self.max_seq, device=self.device,
                int8=engine_cfg.kv_cache_int8)
        self.sampling_state = S.init_sampling_state(
            self.batch, model_cfg.vocab_size, seed, device=self.device)
        # host-side upper bounds on per-slot lengths: the KV window bucket
        # is picked without a device sync
        self._len_bounds = np.zeros(self.batch, np.int64)
        self.decode_steps = 0   # decode steps launched (all slots at once)
        self.prefills = 0       # prefill passes launched

    # -- device code --------------------------------------------------------

    def _t(self, x, dtype) -> torch.Tensor:
        """Host array or device tensor → tensor on this core's device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.from_numpy(np.asarray(x)).to(device=self.device,
                                                  dtype=dtype)

    @staticmethod
    def _restore_rows(old: S.SamplingState, new: S.SamplingState,
                      slot_mask: torch.Tensor) -> S.SamplingState:
        """Keep new rows only for slots in slot_mask: admission must not
        perturb mid-generation neighbours."""
        m = slot_mask
        return S.SamplingState(
            presence=torch.where(m[:, None], new.presence, old.presence),
            seed=torch.where(m, new.seed, old.seed),
            step=torch.where(m, new.step, old.step),
            in_speech=torch.where(m, new.in_speech, old.in_speech),
            frame_pos=torch.where(m, new.frame_pos, old.frame_pos),
        )

    def _reset_seed_impl(self, mask, seeds, reseed) -> None:
        """Slot reset + noise reseed: admitted slots (mask) get lengths,
        presence and speech state cleared; those with reseed restart their
        noise counter at the request's seed."""
        self.cache.lengths.masked_fill_(mask, 0)
        ss = self.sampling_state
        rs = mask & reseed
        self.sampling_state = ss._replace(
            presence=ss.presence.masked_fill(mask[:, None], False),
            seed=torch.where(rs, S.slot_seed(seeds), ss.seed),
            step=torch.where(rs, torch.zeros_like(ss.step), ss.step),
            in_speech=ss.in_speech & ~mask,
            frame_pos=ss.frame_pos.masked_fill(mask, 0),
        )

    def _prefill_impl(self, kv_window, tokens, lens, sparams, slot_mask):
        """Prefill `tokens` (B, S bucket) for slots in slot_mask and sample
        their first token; other slots are untouched."""
        seg = torch.where(slot_mask, lens, torch.zeros_like(lens))
        self.prefills += 1
        logits, _ = llama.prefill(self.params, self.model_cfg, tokens, seg,
                                  self.cache, kv_window=kv_window,
                                  logits_base=self.logits_base)
        old = self.sampling_state
        marked = S.mark_prompt(old, tokens, seg)
        tok, new = S.sample(logits, sparams, marked, base=self.logits_base)
        self.sampling_state = self._restore_rows(old, new, slot_mask)
        return tok

    def _decode_impl(self, n_steps, kv_window, sparams, last_tok, active):
        """n_steps decode steps; returns (toks (B, n), last tok, active)."""
        max_seq = self.cache.max_seq
        tok, act = last_tok, active
        out = []
        for _ in range(n_steps):
            logits, _ = llama.decode_one(
                self.params, self.model_cfg, tok, self.cache, act,
                kv_window=kv_window, logits_base=self.logits_base)
            new_tok, self.sampling_state = S.sample(
                logits, sparams, self.sampling_state, base=self.logits_base)
            new_tok = torch.where(act, new_tok,
                                  torch.full_like(new_tok, self.eos_id))
            act = act & (new_tok != self.eos_id) & (
                self.cache.lengths < max_seq - 1)
            tok = new_tok
            out.append(new_tok)
        self.decode_steps += n_steps
        return torch.stack(out, dim=1), tok, act

    def _prefill_decode_impl(self, n_steps, kv_window, tokens, lens, sparams,
                             slot_mask, last_tok, active, seeds, reseed):
        """Fused slot reset + prefill + n decode steps in one launch; column
        0 of the returned tokens is the prefill-sampled token (non-admitted
        slots repeat their last token there)."""
        self._reset_seed_impl(slot_mask, seeds, reseed)
        ptok = self._prefill_impl(tokens.shape[1], tokens, lens, sparams,
                                  slot_mask)
        tok0 = torch.where(slot_mask, ptok, last_tok)
        active0 = torch.where(slot_mask, ptok != self.eos_id, active)
        toks, tok, act = self._decode_impl(n_steps, kv_window, sparams, tok0,
                                           active0)
        return torch.cat([tok0[:, None], toks], dim=1), tok, act

    # -- host orchestration ---------------------------------------------------

    def bucket_len(self, n: int) -> int:
        for b in self.engine_cfg.prefill_buckets:
            if n <= b:
                return b
        return self.engine_cfg.max_input_len

    def kv_bucket(self, needed: int) -> int:
        for b in self.engine_cfg.kv_buckets:
            if needed <= b <= self.max_seq:
                return b
        return self.max_seq

    def resume_bucket_len(self, n: int) -> Optional[int]:
        """Smallest prefill bucket (regular or resume tier) covering an
        n-token resume re-prefill; None = too long to be preemptible."""
        for b in sorted(set(self.engine_cfg.prefill_buckets)
                        | set(self.engine_cfg.resume_buckets)):
            if n <= b <= self.max_seq:
                return int(b)
        return None

    # -- paged-KV block allocator (engine_cfg.paged_kv) ----------------------

    def free_tokens(self) -> int:
        """Unreserved KV pool capacity in tokens (all slots when dense)."""
        if not self.engine_cfg.paged_kv:
            return self.batch * self.max_seq
        return len(self._free_blocks) * self.engine_cfg.kv_block_size

    def kv_demand(self, prompt_len: int, max_tokens: int) -> int:
        """Tokens a request reserves at admission: padded prompt bucket + its
        token budget (none with kv_on_demand, which grows per decode launch)
        + decode-call slack, rounded up to whole blocks."""
        bs_blk = self.engine_cfg.kv_block_size
        budget = 0 if self.engine_cfg.kv_on_demand else max_tokens
        total = min(self.bucket_len(prompt_len) + budget
                    + self.engine_cfg.decode_steps_per_call + 2, self.max_seq)
        return -(-total // bs_blk) * bs_blk

    def _push_table(self) -> None:
        """Copy the host block table into the device table, in place and
        ordered on the stream: launches enqueued before read the old table,
        launches after it the new one. The source is pageable host memory,
        which the CUDA driver stages before the copy call returns, so the
        host table may change again at once."""
        self.cache.block_table.copy_(torch.from_numpy(self._table_host),
                                     non_blocking=True)

    def _reserve_blocks(self, slots: Sequence[int],
                        totals: Sequence[int]) -> None:
        """Reserve ceil(total / block) pool blocks per slot; one table
        push."""
        bs_blk = self.engine_cfg.kv_block_size
        for sl, total in zip(slots, totals):
            n_blk = min(-(-int(total) // bs_blk), self._table_host.shape[1])
            if n_blk > len(self._free_blocks):
                raise RuntimeError(
                    f"KV pool exhausted: need {n_blk} blocks, "
                    f"{len(self._free_blocks)} free (capacity-gate "
                    "admissions with free_tokens()/kv_demand())")
            blocks = [self._free_blocks.pop() for _ in range(n_blk)]
            self._slot_blocks[sl] = blocks
            self._table_host[sl] = 0
            self._table_host[sl, :n_blk] = blocks
        self._push_table()

    def _free_slot_blocks(self, slots: Sequence[int]) -> None:
        changed = False
        for sl in slots:
            blocks = self._slot_blocks.pop(sl, None)
            if blocks:
                self._free_blocks.extend(blocks)
                self._table_host[sl] = 0
                changed = True
        if changed:
            self._push_table()

    # -- on-demand growth + preemption (engine_cfg.kv_on_demand) -------------

    def _blocks_deficit(self, n: int) -> dict:
        """slot → additional blocks needed to cover the next n-step launch
        (host bookkeeping only)."""
        bs_blk = self.engine_cfg.kv_block_size
        cap = self._table_host.shape[1]
        out = {}
        for sl in sorted(self._slot_blocks):
            bound = int(self._len_bounds[sl])
            if bound <= 0:
                continue
            need = min(-(-min(bound + n + 1, self.max_seq) // bs_blk), cap)
            have = len(self._slot_blocks[sl])
            if need > have:
                out[sl] = need - have
        return out

    def starved_slots(self, n: Optional[int] = None) -> List[int]:
        """Dry-run the next decode launch's block growth: the slots the pool
        cannot cover. The scheduler preempts before launching when this is
        non-empty."""
        if not (self.engine_cfg.paged_kv and self.engine_cfg.kv_on_demand):
            return []
        n = n or self.engine_cfg.decode_steps_per_call
        free = len(self._free_blocks)
        starved = []
        for sl, want in self._blocks_deficit(n).items():
            if want <= free:
                free -= want
            else:
                starved.append(sl)
        return starved

    def _grow_blocks(self, n: int) -> None:
        """Extend each live slot's blocks to cover the next n decode steps
        (kv_on_demand). The scheduler gates launches with starved_slots()
        and preemption, so a shortage here is a hard error."""
        deficit = self._blocks_deficit(n)
        if not deficit:
            return
        for sl, want in deficit.items():
            if want > len(self._free_blocks):
                raise RuntimeError(
                    f"KV pool exhausted growing slot {sl}: need {want} "
                    f"blocks, {len(self._free_blocks)} free (gate launches "
                    "with starved_slots() and preempt)")
            blocks = [self._free_blocks.pop() for _ in range(want)]
            have = len(self._slot_blocks[sl])
            self._table_host[sl, have: have + want] = blocks
            self._slot_blocks[sl].extend(blocks)
        self._push_table()

    def snapshot_slot(self, slot: int) -> dict:
        """Host copy of a slot's sampling-chain state: the noise counter
        (seed AND step — the noise of step t is a hash of both), repetition
        presence and speech-protocol position. Taken at preemption after
        the scheduler drained its launches; ``restore_slot`` is the
        inverse, and together they make preempt → resume bit-identical."""
        ss = self.sampling_state
        return {"presence": to_numpy(ss.presence[slot]).copy(),
                "seed": int(ss.seed[slot]), "step": int(ss.step[slot]),
                "in_speech": bool(ss.in_speech[slot]),
                "frame_pos": int(ss.frame_pos[slot])}

    def restore_slot(self, slot: int, snap: dict) -> None:
        """Write a snapshot_slot dict back into the slot's sampling state
        (after the resume re-prefill, whose reset and first sample
        clobbered it), in place on the stream."""
        ss = self.sampling_state
        ss.presence[slot] = torch.from_numpy(snap["presence"]).to(self.device)
        ss.seed[slot] = snap["seed"]
        ss.step[slot] = snap["step"]
        ss.in_speech[slot] = snap["in_speech"]
        ss.frame_pos[slot] = snap["frame_pos"]

    def preempt_slot(self, slot: int) -> None:
        """Release a preempted slot's KV blocks and host bounds without
        touching device state: the resume admission's reset clears it, and
        launches still in flight that write this slot land in the trash
        block through the zeroed table row."""
        self._len_bounds[slot] = 0
        if self.engine_cfg.paged_kv:
            self._free_slot_blocks([slot])

    def _maybe_reserve(self, slots: Sequence[int], bucket: int,
                       reserve_extra: Optional[Sequence[int]]) -> None:
        """Paged: reserve each admitted slot's blocks — bucket + its token
        budget (default max_output_len) + slack, or with kv_on_demand only
        the prefill window and one decode-call window."""
        if not self.engine_cfg.paged_kv:
            return
        slack = self.engine_cfg.decode_steps_per_call + 1
        if self.engine_cfg.kv_on_demand:
            # the bound matches the bucket+1 _len_bounds, so the first
            # growth is a no-op
            extras = [1] * len(slots)
        else:
            extras = (list(reserve_extra) if reserve_extra is not None
                      else [self.engine_cfg.max_output_len] * len(slots))
        self._reserve_blocks(slots, [min(bucket + e + slack, self.max_seq)
                                     for e in extras])

    def _mask(self, slots: Sequence[int]) -> np.ndarray:
        mask = np.zeros(self.batch, bool)
        mask[list(slots)] = True
        return mask

    def _reset_host(self, slots: Sequence[int]) -> None:
        """Host half of a slot reset: length bounds and, paged, the slots'
        blocks."""
        for sl in slots:
            self._len_bounds[sl] = 0
        if self.engine_cfg.paged_kv:
            self._free_slot_blocks(slots)

    def _seed_arrays(self, slots: Sequence[int],
                     seeds: Optional[Sequence[Optional[int]]]):
        """(seed (B,), reseed (B,)) inputs for per-request reseeds."""
        seed_arr = np.zeros(self.batch, np.int64)
        reseed = np.zeros(self.batch, bool)
        for i, sl in enumerate(slots):
            sd = seeds[i] if seeds is not None and i < len(seeds) else None
            if sd is not None:
                seed_arr[sl] = np.int64(sd) & 0x7FFFFFFF
                reseed[sl] = True
        return seed_arr, reseed

    @torch.no_grad()
    def reset_and_seed(self, slots: Sequence[int],
                       seeds: Optional[Sequence[Optional[int]]] = None
                       ) -> None:
        self._reset_host(slots)
        seed_arr, reseed = self._seed_arrays(slots, seeds)
        self._reset_seed_impl(self._t(self._mask(slots), torch.bool),
                              self._t(seed_arr, torch.int64),
                              self._t(reseed, torch.bool))

    def _prompt_batch(self, prompts, slots, bucket):
        tokens = np.zeros((self.batch, bucket), np.int32)
        lens = np.zeros(self.batch, np.int32)
        for p, sl in zip(prompts, slots):
            p = list(p)[:bucket]
            tokens[sl, : len(p)] = p
            lens[sl] = len(p)
        return (self._t(tokens, torch.int32), self._t(lens, torch.int32),
                self._t(self._mask(slots), torch.bool))

    @torch.no_grad()
    def prefill_slots(self, prompts: Sequence[Sequence[int]],
                      slots: Sequence[int], sparams: S.SamplingParams,
                      reserve_extra: Optional[Sequence[int]] = None,
                      seeds: Optional[Sequence[Optional[int]]] = None,
                      bucket: Optional[int] = None) -> np.ndarray:
        """Prefill the given slots; returns their first tokens (B,) on the
        host. Runs over the whole slot batch; other slots are untouched.
        Paged, each slot reserves bucket + reserve_extra[i] tokens of blocks
        (default max_output_len). ``bucket`` overrides the prompt's bucket:
        the preemption resume re-prefills through the resume tier so."""
        assert len(prompts) == len(slots)
        bucket = bucket or self.bucket_len(
            max((len(p) for p in prompts), default=1))
        tokens, lens, mask = self._prompt_batch(prompts, slots, bucket)
        self.reset_and_seed(slots, seeds)
        self._maybe_reserve(slots, bucket, reserve_extra)
        tok = self._prefill_impl(bucket, tokens, lens, sparams, mask)
        for p, sl in zip(prompts, slots):
            self._len_bounds[sl] = min(len(p), bucket) + 1
        return to_numpy(tok)

    @torch.no_grad()
    def prefill_decode_launch(self, prompts: Sequence[Sequence[int]],
                              slots: Sequence[int],
                              sparams: S.SamplingParams, last_tok, active,
                              n: Optional[int] = None,
                              reserve_extra: Optional[Sequence[int]] = None,
                              kv_window: Optional[int] = None,
                              seeds: Optional[Sequence[Optional[int]]] = None):
        """Fused admission prefill + n decode steps, launched without
        waiting. Returns device tensors (toks (B, n+1), last_tok, active).
        kv_window None = smallest bucket covering every live slot;
        reserve_extra as in prefill_slots."""
        n = n or self.engine_cfg.decode_steps_per_call
        assert len(prompts) == len(slots)
        bucket = self.bucket_len(max((len(p) for p in prompts), default=1))
        tokens, lens, mask = self._prompt_batch(prompts, slots, bucket)
        self._reset_host(slots)
        seed_arr, reseed = self._seed_arrays(slots, seeds)
        self._maybe_reserve(slots, bucket, reserve_extra)
        for p, sl in zip(prompts, slots):
            self._len_bounds[sl] = min(len(p), bucket) + 1
        if self.engine_cfg.paged_kv and self.engine_cfg.kv_on_demand:
            self._grow_blocks(n)    # the slots already live decode too
        needed = int(self._len_bounds.max(initial=0)) + n + 1
        window = kv_window or self.kv_bucket(needed)
        out = self._prefill_decode_impl(
            n, window, tokens, lens, sparams, mask,
            self._t(last_tok, torch.int32), self._t(active, torch.bool),
            self._t(seed_arr, torch.int64), self._t(reseed, torch.bool))
        self._len_bounds[self._len_bounds > 0] += n
        return out

    @torch.no_grad()
    def decode_steps_launch(self, sparams: S.SamplingParams, last_tok,
                            active, n: Optional[int] = None):
        """Launch n decode steps without waiting; returns device tensors
        (tokens (B, n), last_tok, active). last_tok/active may be device
        tensors of a previous launch: launches chain on the device."""
        n = n or self.engine_cfg.decode_steps_per_call
        if self.engine_cfg.paged_kv and self.engine_cfg.kv_on_demand:
            self._grow_blocks(n)
        needed = int(self._len_bounds.max(initial=0)) + n + 1
        window = self.kv_bucket(needed)
        out = self._decode_impl(n, window, sparams,
                                self._t(last_tok, torch.int32),
                                self._t(active, torch.bool))
        # conservative host bound: every occupied slot may grow by n
        self._len_bounds[self._len_bounds > 0] += n
        return out

    def warmup_graphs(self, timer: Optional[PhaseTimer] = None) -> dict:
        """Run one admission and one decode launch, so the kernels, cuBLAS
        and cuDNN are initialised before the first request. Eager PyTorch
        compiles nothing per shape, so unlike the JAX package this does not
        enumerate (bucket, window, steps). Paged, the probe's blocks are
        released at the end: the whole pool is free afterwards."""
        t = timer or PhaseTimer()
        sp = S.SamplingParams.from_config(SamplingConfig(greedy=True),
                                          self.batch, device=self.device)
        n = self.engine_cfg.decode_steps_per_call
        zeros_tok = np.zeros(self.batch, np.int32)
        zeros_act = np.zeros(self.batch, bool)
        with t.phase("warmup_prefill_decode"):
            toks, tok, act = self.prefill_decode_launch(
                [[1] * 4], [0], sp, zeros_tok, zeros_act, n=n)
            to_numpy(toks)
        with t.phase("warmup_decode"):
            to_numpy(self.decode_steps_launch(sp, tok, act, n)[0])
        self.reset_and_seed(list(range(self.batch)))
        return {"warmup_ms": dict(t.phases)}


class GenerationEngine:
    """Single-stream host API over EngineCore (slot 0)."""

    def __init__(self, params, model_cfg: ModelConfig,
                 engine_cfg: Optional[EngineConfig] = None, *,
                 eos_id: int = protocol.TOKEN_EOS, seed: int = 0,
                 device=None, first_bursts: Sequence[int] = ()):
        self.engine_cfg = engine_cfg or EngineConfig()
        self.core = EngineCore(params, model_cfg, self.engine_cfg,
                               batch_size=1, eos_id=eos_id, seed=seed,
                               device=device)
        self.eos_id = eos_id
        # registered first-dispatch burst sizes (tokens): the first launch
        # covers the whole first audio chunk when the caller's need matches
        self.first_bursts = sorted({int(b) for b in first_bursts
                                    if b and int(b) > 1})

    def warmup(self) -> dict:
        t = PhaseTimer()
        info = self.core.warmup_graphs(t)
        return {**info, **t.as_dict()}

    def stream(self, prompt_ids: Sequence[int],
               sampling: Optional[SamplingConfig] = None, *,
               steps_per_yield: Optional[int] = None,
               first_burst: Optional[int] = None,
               on_first_tokens: Optional[Callable] = None
               ) -> Iterator[List[int]]:
        """Yield raw LM token chunks (including SOS/EOS) as they decode.

        Depth-2 pipelining: up to two launches stay in flight, chaining
        tok/active on the device, while the host fetches the older one.
        ``on_first_tokens`` gets the first launch's DEVICE token tensor
        (B, n+1) right after launch (the fused first-chunk vocode hook).
        """
        sampling = sampling or SamplingConfig()
        core = self.core
        sp = S.SamplingParams.from_config(sampling, core.batch,
                                          device=core.device)
        max_new = sampling.max_tokens
        n_default = steps_per_yield or self.engine_cfg.decode_steps_per_call
        if first_burst in self.first_bursts and max_new >= first_burst:
            n_first = first_burst - 1
        else:
            n_first = max(0, min(n_default - 1, max_new - 1))
        pending = collections.deque()
        first = core.prefill_decode_launch(
            [list(prompt_ids)], [0], sp,
            np.zeros(core.batch, np.int32), np.zeros(core.batch, bool),
            n=max(n_first, 1), reserve_extra=[max_new],
            seeds=[sampling.seed])
        if on_first_tokens is not None:
            on_first_tokens(first[0])
        pending.append((*first, copy_async(first[0])[0]))
        produced = 0
        scheduled = first[0].shape[1]
        while pending:
            while len(pending) < 2 and scheduled < max_new:
                _, tok_d, act_d, _ = pending[-1]
                nxt = core.decode_steps_launch(sp, tok_d, act_d, n_default)
                pending.append((*nxt, copy_async(nxt[0])[0]))
                scheduled += n_default
            host = pending.popleft()[3]
            row = to_numpy(host)[0].tolist()   # overlaps the in-flight call
            row = row[: max_new - produced]
            if self.eos_id in row:
                row = row[: row.index(self.eos_id) + 1]
                pending.clear()
            produced += len(row)
            yield [int(x) for x in row]
            if produced >= max_new:
                pending.clear()

    def generate(self, prompt_ids: Sequence[int],
                 sampling: Optional[SamplingConfig] = None,
                 on_chunk: Optional[Callable[[List[int]], None]] = None
                 ) -> GenerationResult:
        t = PhaseTimer()
        out: List[int] = []
        first_tok_ms = None
        for chunk in self.stream(prompt_ids, sampling):
            if first_tok_ms is None:
                first_tok_ms = t.mark("ttft_ms")
            out.extend(chunk)
            if on_chunk:
                on_chunk(chunk)
        total_ms = t.elapsed_ms()
        n = len(out)
        return GenerationResult(
            token_ids=out,
            finished=bool(out and out[-1] == self.eos_id),
            timings={
                "ttft_ms": first_tok_ms or 0.0,
                "token_gen_ms": total_ms,
                "tokens": n,
                "tokens_per_sec": n / (total_ms / 1000.0) if total_ms else 0.0,
            },
        )
