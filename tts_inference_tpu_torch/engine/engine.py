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
  pipelining).

Not ported yet (ROADMAP.md): paged KV, int8/int4 KV, prefix cache,
preemption, meshes, and CUDA-graph capture of the decode burst.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from tts_inference_tpu import protocol
from tts_inference_tpu.config import EngineConfig, ModelConfig, SamplingConfig
from tts_inference_tpu.utils.timing import PhaseTimer
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
    if engine_cfg.paged_kv:
        return "paged KV (ROADMAP.md Queue 1 item 11)"
    if engine_cfg.kv_cache_int8:
        return "int8 KV cache (ROADMAP.md Queue 1 item 11)"
    if engine_cfg.kv_cache_int4:
        return "int4 KV cache (ROADMAP.md Queue 1 item 13)"
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
            else params["embed"].device
        self.batch = batch_size or engine_cfg.max_batch_size
        self.max_seq = engine_cfg.max_seq_len
        # sliced LM head: every emittable token has id >= HEAD_SLICE_BASE
        self.logits_base = (
            protocol.HEAD_SLICE_BASE
            if engine_cfg.sliced_head
            and model_cfg.vocab_size > protocol.TOKEN_AUDIO_BASE else 0)
        self.cache = llama.init_kv_cache(model_cfg, self.batch, self.max_seq,
                                         device=self.device)
        self.sampling_state = S.init_sampling_state(
            self.batch, model_cfg.vocab_size, seed, device=self.device)
        # host-side upper bounds on per-slot lengths: the KV window bucket
        # is picked without a device sync
        self._len_bounds = np.zeros(self.batch, np.int64)
        self.decode_steps = 0   # decode steps launched (all slots at once)

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

    def _mask(self, slots: Sequence[int]) -> np.ndarray:
        mask = np.zeros(self.batch, bool)
        mask[list(slots)] = True
        return mask

    def _reset_host(self, slots: Sequence[int]) -> None:
        for sl in slots:
            self._len_bounds[sl] = 0

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
                      seeds: Optional[Sequence[Optional[int]]] = None,
                      bucket: Optional[int] = None) -> np.ndarray:
        """Prefill the given slots; returns their first tokens (B,) on the
        host. Runs over the whole slot batch; other slots are untouched."""
        assert len(prompts) == len(slots)
        bucket = bucket or self.bucket_len(
            max((len(p) for p in prompts), default=1))
        tokens, lens, mask = self._prompt_batch(prompts, slots, bucket)
        self.reset_and_seed(slots, seeds)
        tok = self._prefill_impl(bucket, tokens, lens, sparams, mask)
        for p, sl in zip(prompts, slots):
            self._len_bounds[sl] = min(len(p), bucket) + 1
        return to_numpy(tok)

    @torch.no_grad()
    def prefill_decode_launch(self, prompts: Sequence[Sequence[int]],
                              slots: Sequence[int],
                              sparams: S.SamplingParams, last_tok, active,
                              n: Optional[int] = None,
                              kv_window: Optional[int] = None,
                              seeds: Optional[Sequence[Optional[int]]] = None):
        """Fused admission prefill + n decode steps, launched without
        waiting. Returns device tensors (toks (B, n+1), last_tok, active).
        kv_window None = smallest bucket covering every live slot."""
        n = n or self.engine_cfg.decode_steps_per_call
        assert len(prompts) == len(slots)
        bucket = self.bucket_len(max((len(p) for p in prompts), default=1))
        tokens, lens, mask = self._prompt_batch(prompts, slots, bucket)
        self._reset_host(slots)
        seed_arr, reseed = self._seed_arrays(slots, seeds)
        for p, sl in zip(prompts, slots):
            self._len_bounds[sl] = min(len(p), bucket) + 1
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
        enumerate (bucket, window, steps)."""
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
            n=max(n_first, 1), seeds=[sampling.seed])
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
