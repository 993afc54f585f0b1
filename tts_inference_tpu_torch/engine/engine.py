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
- where JAX compiled each launch once per shape with ``jax.jit``, a CUDA
  device replays CUDA graphs: the admission graph of a prompt bucket (slot
  reset + prefill + first sample) and the decode graph of (steps, KV
  window), captured by ``warmup_graphs`` or, like a first ``jax.jit``
  call, on first use; the fused admission launch replays the two back to
  back. Inputs are copied into the graphs' fixed tensors, outputs are
  cloned out of them. The CPU, and a core built with ``graphs=False``, run
  the same launch bodies eagerly;
- launches are asynchronous: ``*_launch`` returns device tensors and
  ``copy_async`` queues their device→host copies (pinned memory + a CUDA
  event), so the host fetches one launch while the next runs (depth-2
  pipelining);
- the KV cache is dense (bf16/f32 or int8) or paged (``paged_kv``; bf16/f32,
  int8, or int4 packed by head pair): a pool of blocks with a host-side
  block allocator, worst-case reservation at
  admission or on-demand growth per decode launch (``kv_on_demand``), and
  ``snapshot_slot``/``restore_slot``/``preempt_slot`` for the scheduler's
  preempt-and-resume;
- the prefix cache (``prefix_cache``; the reference's analog of vLLM's
  ``enable_prefix_caching``): the KV of a prompt's first ``prefix_len``
  tokens lives in an LRU pool of per-layer entries on the device, in the
  serving cache's layout and precision. A miss builds the entry (the build
  launch: a prefill of the prefix into a one-slot scratch cache, then a
  copy into the pool row, in place); the admission launch of a prefix hit
  copies the entry into the slot's positions [0, plen) and prefills only
  the suffix, at its own (smaller) prompt bucket.

The block table is device state written from the host. The JAX package
swapped in a fresh immutable array on every change; here every change is
one stream-ordered host→device copy into the same table tensor, so a
launch already enqueued reads the table it was launched with, and a later
prefill into reused blocks runs after every launch that still wrote them.

The block table is read as a view inside the graphs, so one decode graph
per window serves every table state; block growth stays on the host before
the replay. The prefix pools are read the same way: the build writes the
pool rows in place, on the stream, so an admission graph replayed after it
reads the new entry and one replayed before it the old.

The preemption resume (``prefill_slots``, the scheduler's re-prefill of
prompt + generated) replays a graph too: the admission graph of its bucket
where that is a prompt bucket, else the graph of its resume-tier bucket
(``resume_buckets`` above the largest prompt bucket, captured by
``warmup_graphs`` on a paged on-demand core, as the JAX package compiles
them there). A resume re-prefills one slot, so a tier graph prefills that
one row, not the slot batch: over the batch, the prefill attention's f32
scores grow with B × bucket² (``tools/warmup_memory.py`` on an H100 80GB:
the 2048 graph held 14.5 GB at 8 slots and ran out of memory at 32; one
row, 1.6 GB). Its launches are counted as resumes, apart from
admissions.

Under a (dp, tp) mesh (``parallel/mesh.py``, one process per device) the
core holds this rank's shard: the parameters and the KV heads of its tp
rank, and of every slot tensor the rows [r·B/dp, (r+1)·B/dp) of its dp
rank r. The host API stays the whole slot batch's: every launch copies its
rank's rows of the inputs in, runs over them, and gathers each output over
dp inside the launch, so every rank returns what the unsharded core
returns (the JAX package's ``replicate_token_outs``, always on here). The
host state — the length bounds, the block allocator and its table, the
prefix map — is the whole batch's on every rank; each dp rank holds the
whole block pool (the JAX package replicates the pool over dp) and writes
only its own slots' blocks. On NCCL every launch is captured with its
collectives inside the graph, as on one card; gloo cannot be captured, so
on a gloo group a CUDA core needs ``graphs=False`` and raises without it.
All ranks must make the same calls in the same order
(``parallel/lockstep.py``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import threading
import time
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from tts_inference_tpu_torch import protocol
from tts_inference_tpu_torch.config import (EngineConfig, ModelConfig,
                                            SamplingConfig)
from tts_inference_tpu_torch.utils.timing import PhaseTimer
from tts_inference_tpu_torch.models import llama
from tts_inference_tpu_torch.ops import _build
from tts_inference_tpu_torch.ops import sampling as S
from tts_inference_tpu_torch.parallel import collectives
from tts_inference_tpu_torch.utils import copy_async, cuda_graphs, to_numpy

__all__ = ["copy_async", "GenerationResult", "EngineCore",
           "GenerationEngine"]

log = logging.getLogger("tts_inference_tpu_torch.engine")

_CAPTURE_LOCK = cuda_graphs.CAPTURE_LOCK
_Graph = cuda_graphs.Graph


def _census_name(key) -> str:
    if key[0] == "decode":
        return f"capture_decode_n{key[1]}_w{key[2]}"
    if key[0] == "admit_prefix":
        return f"capture_prefill_prefix_{key[1]}"
    if key[0] == "prefix_build":
        return "capture_prefix_build"
    if key[0] == "resume":
        return f"capture_prefill_resume_{key[1]}"
    return f"capture_prefill_{key[1]}"


def _launch_kind(key) -> str:
    return {"decode": "decode", "prefix_build": "prefix_build",
            "resume": "resume"}.get(key[0], "admission")


# launch inputs with a slot axis first: a dp rank copies its rows of them
_SLOT_INPUTS = frozenset(("last_tok", "active", "lens", "mask", "seeds",
                          "reseed", "tokens", "ptoks", "plens", "pidx", "sp"))


class _StepCount(int):
    """``EngineCore.decode_steps``: the decode steps the core launched (all
    slots at once), an int as the port's tools and tests read it, that is
    also the JAX package's blocking ``decode_steps(sparams, last_tok,
    active, n=None)`` when called."""

    def __new__(cls, n: int, core: "EngineCore"):
        return super().__new__(cls, n)

    def __init__(self, n: int, core: "EngineCore"):
        super().__init__()
        self._core = core

    def __call__(self, sparams, last_tok, active, n=None):
        return self._core._decode_steps_host(sparams, last_tok, active, n)


@dataclasses.dataclass
class GenerationResult:
    token_ids: List[int]
    finished: bool
    timings: dict


class EngineCore:
    """Compute core over a fixed slot batch. Device state lives in
    ``self.cache`` / ``self.sampling_state``."""

    def __init__(self, params, model_cfg: ModelConfig,
                 engine_cfg: EngineConfig, *, batch_size: Optional[int] = None,
                 eos_id: int = protocol.TOKEN_EOS, seed: int = 0,
                 device=None, graphs: bool = True, mesh=None):
        self.params = params
        self.model_cfg = model_cfg
        self.engine_cfg = engine_cfg
        self.eos_id = eos_id
        self.device = torch.device(device) if device is not None \
            else params["final_norm"].device
        self.batch = batch_size or engine_cfg.max_batch_size
        self.max_seq = engine_cfg.max_seq_len
        self.mesh = mesh
        # this rank's slot rows [row0, row0 + rows) of the slot batch
        self.rows, self.row0 = self.batch, 0
        local_cfg = model_cfg
        if mesh is not None:
            from tts_inference_tpu_torch.parallel import mesh as M

            M.validate_tp(model_cfg, mesh.tp)
            if self.batch % mesh.dp:
                raise ValueError(
                    f"batch {self.batch} not divisible by dp={mesh.dp}")
            if engine_cfg.kv_cache_int4:
                M.validate_kv_int4(model_cfg, mesh.tp)
            if graphs and self.device.type == "cuda" and mesh.gather_by_sum:
                raise ValueError(
                    f"CUDA graphs cannot capture {mesh.backend} collectives: "
                    "build the core with graphs=False on this group")
            local_cfg = M.local_model_config(model_cfg, mesh.tp)
            self.rows = self.batch // mesh.dp
            self.row0 = mesh.dp_rank * self.rows
        self._local_cfg = local_cfg
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
                local_cfg, self.rows, self.max_seq, num_blocks=num_blocks,
                block_size=bs_blk, int8=engine_cfg.kv_cache_int8,
                int4=engine_cfg.kv_cache_int4, device=self.device)
            # host-side block allocator: block 0 is the trash block
            self._free_blocks = list(range(num_blocks - 1, 0, -1))
            self._slot_blocks: dict = {}
            self._table_host = np.zeros(
                (self.batch, self.max_seq // bs_blk), np.int32)
        else:
            self.cache = llama.init_kv_cache(
                local_cfg, self.rows, self.max_seq, device=self.device,
                int8=engine_cfg.kv_cache_int8)
        # every slot's noise seed is its index's in the whole batch
        ss = S.init_sampling_state(self.batch, model_cfg.vocab_size, seed,
                                   device=self.device)
        self.sampling_state = ss if mesh is None else S.SamplingState(
            *(t[self.row0:self.row0 + self.rows].clone() for t in ss))
        # host-side upper bounds on per-slot lengths: the KV window bucket
        # is picked without a device sync
        self._len_bounds = np.zeros(self.batch, np.int64)
        self.steps_launched = 0   # decode steps (all slots at once)
        self.prefills = 0       # prefill passes launched
        self.prefix_hits = 0
        self.prefix_misses = 0
        if engine_cfg.prefix_cache:
            self._init_prefix_pool()
        # CUDA graphs on a CUDA device (graphs=False: the eager launches,
        # for comparisons on the card); key ("decode", steps, window),
        # ("admit", bucket), ("admit_prefix", suffix bucket), ("resume",
        # resume-tier bucket) or ("prefix_build",) → _Graph
        self.use_graphs = graphs and self.device.type == "cuda"
        self._graphs: dict = {}
        self._graph_pool = None      # one memory pool for the core's graphs
        self._static: Optional[dict] = None   # the launches' input tensors
        self._prepared: set = set()  # threads that ran the eager pass
        self._warming = False
        self.graph_census_ms: dict = {}   # census name → capture ms
        self.prepare_ms = 0.0
        self.late_captures = 0       # captured outside warmup_graphs
        # uses of each graph kind, and how many of them were replays (the
        # resume tier's warmup launches count as "warmup", not as resumes)
        self.launches = collections.Counter()
        self.replays = collections.Counter()

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

    def _reset_state(self, ss: S.SamplingState, mask, seeds,
                     reseed) -> S.SamplingState:
        """Slot reset + noise reseed: admitted slots (mask) get lengths,
        presence and speech state cleared; those with reseed restart their
        noise counter at the request's seed."""
        self.cache.lengths.masked_fill_(mask, 0)
        return self._reseed(ss._replace(
            presence=ss.presence.masked_fill(mask[:, None], False),
            in_speech=ss.in_speech & ~mask,
            frame_pos=ss.frame_pos.masked_fill(mask, 0),
        ), mask & reseed, seeds)

    @staticmethod
    def _reseed(ss: S.SamplingState, rs, seeds) -> S.SamplingState:
        """Restart the noise counter of the slots in rs at their seeds (the
        noise of step t is a hash of the seed and t)."""
        return ss._replace(
            seed=torch.where(rs, S.slot_seed(seeds), ss.seed),
            step=torch.where(rs, torch.zeros_like(ss.step), ss.step))

    def _prefill_state(self, ss: S.SamplingState, tokens, lens, sparams,
                       slot_mask, prefix=None, cache=None):
        """Prefill `tokens` (B, S bucket) for slots in slot_mask and sample
        their first token; other slots are untouched. Returns (tokens, the
        sampling state after). `prefix` (ptoks, plens, pidx): the prefix
        cache's admission, see _prefix_prefill_state. `cache`: the core's,
        or a view of some of its rows (_row_prefill_state)."""
        cache = self.cache if cache is None else cache
        if prefix is not None:
            return self._prefix_prefill_state(ss, tokens, lens, *prefix,
                                              sparams, slot_mask, cache)
        seg = torch.where(slot_mask, lens, torch.zeros_like(lens))
        logits, _ = llama.prefill(self.params, self.model_cfg, tokens, seg,
                                  cache, kv_window=tokens.shape[1],
                                  logits_base=self.logits_base,
                                  mesh=self.mesh)
        marked = S.mark_prompt(ss, tokens, seg)
        tok, new = S.sample(logits, sparams, marked, base=self.logits_base)
        return tok, self._restore_rows(ss, new, slot_mask)

    def _row_prefill_state(self, ss: S.SamplingState, tokens, rows, lens,
                           sparams, slot_mask, prefix=None):
        """_prefill_state for the slots `rows` (R,) alone, `tokens` (R, S
        bucket): the model runs over R rows of a paged cache view (the
        pools, the rows' block tables and lengths), the other inputs are the
        slot batch's. Returns (the rows' tokens (R,), the slot batch's
        sampling state after, the rows' lengths after)."""
        c = self.cache
        assert isinstance(c, llama.PagedKVCache)

        def sub(t):
            return t.index_select(0, rows)

        view = dataclasses.replace(c, block_table=sub(c.block_table),
                                   lengths=sub(c.lengths))
        tok, new = self._prefill_state(
            S.SamplingState(*map(sub, ss)), tokens, sub(lens),
            S.SamplingParams(*map(sub, sparams)), sub(slot_mask),
            None if prefix is None else tuple(map(sub, prefix)), view)
        ss = S.SamplingState(*(t.index_copy(0, rows, n)
                               for t, n in zip(ss, new)))
        return tok, ss, view.lengths

    # -- the prefix cache: pools, build, injection ---------------------------

    def _init_prefix_pool(self) -> None:
        """The LRU map (prefix tokens → pool row), the free rows and the
        per-layer pools (k, v, k_scale, v_scale) in the JAX package's
        layouts: (E, PB, Hkv, D) with (E, PB, Hkv) int8 scales, or for int4
        KV packed by head pair (E, Hkv/2, PB, D) with (E, 2, Hkv/2, PB)
        nibble-plane scales; and the build's one-slot scratch cache of PB
        positions in the serving cache's precision (for int4 one paged block
        of PB, block 1; 0 stays the trash block). Layer > 0 K/V depend on
        the quantized reads of the layers below, so only a build in the
        serving precision reproduces a plain prefill's cache bytes."""
        ecfg, cfg, dev = self.engine_cfg, self._local_cfg, self.device
        pb, n = ecfg.prefix_len, ecfg.prefix_entries
        hkv, hd = cfg.num_key_value_heads, cfg.head_dim
        self._prefix_map: collections.OrderedDict = collections.OrderedDict()
        self._prefix_free = list(range(n))
        if ecfg.kv_cache_int4:
            shape, sshape = (n, hkv // 2, pb, hd), (n, 2, hkv // 2, pb)
            self._build_cache = llama.init_paged_kv_cache(
                cfg, 1, pb, num_blocks=2, block_size=pb, int4=True,
                device=dev)
            self._build_cache.block_table.fill_(1)
        else:
            shape, sshape = (n, pb, hkv, hd), (n, pb, hkv)
            self._build_cache = llama.init_kv_cache(
                cfg, 1, pb, device=dev, int8=ecfg.kv_cache_int8)
        quant = ecfg.kv_cache_int8 or ecfg.kv_cache_int4
        dt = torch.int8 if quant else llama.param_dtype(cfg)

        def layers(shp, dtype):
            return [torch.zeros(shp, dtype=dtype, device=dev)
                    for _ in range(cfg.num_hidden_layers)]

        self._pool = (layers(shape, dt), layers(shape, dt),
                      layers(sshape, torch.float32) if quant else [],
                      layers(sshape, torch.float32) if quant else [])

    def _build_forward(self, ptoks, plen) -> None:
        """Prefill the prefix (1, PB) into the build's scratch cache."""
        c = self._build_cache
        c.lengths.zero_()
        llama.forward(self.params, self.model_cfg, ptoks, c,
                      torch.zeros_like(plen), plen, kv_window=ptoks.shape[1],
                      mesh=self.mesh)

    def _prefix_build_impl(self, ptoks, plen, idx) -> None:
        """The build launch: the prefix's KV into the scratch cache, then
        into pool row idx (1,), in place — the admission graphs read the
        pools where they were captured."""
        self._build_forward(ptoks, plen)
        c = self._build_cache
        row = slice(1, 2) if self.engine_cfg.kv_cache_int4 else slice(None)
        for pools, built in zip(self._pool, (c.k, c.v, c.k_scale,
                                             c.v_scale)):
            for p, x in zip(pools, built):
                p.index_copy_(0, idx, x[row])

    def _inject_prefix(self, pidx, inject, cache) -> None:
        """Copy pool rows pidx (B,) into cache positions [0, PB) of the
        slots in `inject`, in place. Dense: the other slots' rows are left
        as they are. Paged: through the block table, the other slots
        writing the trash block (row 0), like any masked paged write."""
        pb = self.engine_cfg.prefix_len
        caches = (cache.k, cache.v, cache.k_scale, cache.v_scale)
        if isinstance(cache, llama.PagedKVCache):
            bs, b = cache.block_size, cache.block_table.shape[0]
            pos = torch.arange(pb, device=self.device)
            rows = cache.block_table[:, pos // bs]
            rows = torch.where(inject[:, None], rows, torch.zeros_like(rows))
            offs = (pos % bs)[None, :].expand(b, pb)
            memo: dict = {}
            for i, (cs, pools) in enumerate(zip(caches, self._pool)):
                scale = i >= 2
                for c, p in zip(cs, pools):
                    sel = p.index_select(0, pidx)
                    if cache.int4:
                        # positions next to the batch axis: (B, PB, P2, D)
                        # values, (B, PB, 2, P2) scale planes
                        sel = sel.movedim(3, 1) if scale else sel.movedim(
                            1, 2)
                    llama.pool_scatter(c, rows, offs, sel,
                                       n_mid=2 if scale and cache.int4
                                       else 1, memo=memo)
            return
        for cs, pools in zip(caches, self._pool):
            for c, p in zip(cs, pools):
                sel = p.index_select(0, pidx).to(c.dtype)
                m = inject.view((-1,) + (1,) * (sel.dim() - 1))
                c[:, :pb].copy_(torch.where(m, sel, c[:, :pb]))

    def _prefix_prefill_state(self, ss, tokens, lens, ptoks, plens, pidx,
                              sparams, slot_mask, cache):
        """The prefix cache's prefill: inject each hit's pool row, prefill
        the suffix `tokens` (B, suffix bucket) at write_pos = plens, sample
        at the last suffix token. Slots with plens 0 (no cached prefix)
        prefill their whole prompt from position 0. The attention window is
        the suffix bucket + PB."""
        zeros = torch.zeros_like(plens)
        inject = slot_mask & (plens > 0)
        self._inject_prefix(pidx, inject, cache)
        wp = torch.where(inject, plens, zeros)
        seg = torch.where(slot_mask, lens, torch.zeros_like(lens))
        window = min(tokens.shape[1] + ptoks.shape[1], self.max_seq)
        hidden, _ = llama.forward(self.params, self.model_cfg, tokens,
                                  cache, wp, seg, kv_window=window,
                                  mesh=self.mesh)
        last = (seg - 1).clamp(min=0).long()
        logits = llama.compute_logits(
            self.params, self.model_cfg,
            hidden[torch.arange(tokens.shape[0], device=self.device), last],
            self.logits_base, self.mesh)
        marked = S.mark_prompt(S.mark_prompt(ss, ptoks, wp), tokens, seg)
        tok, new = S.sample(logits, sparams, marked, base=self.logits_base)
        return tok, self._restore_rows(ss, new, slot_mask)

    def _admit_impl(self, tokens, lens, sparams, mask, last_tok, active,
                    seeds, reseed, prefix=None):
        """The admission launch: slot reset + prefill within the bucket +
        the first sample; returns (tok0, active0), the decode inputs where
        admitted slots take their first token and the others keep theirs.
        `prefix` (ptoks, plens, pidx): the prefix cache's admission."""
        ss = self._reset_state(self.sampling_state, mask, seeds, reseed)
        ptok, ss = self._prefill_state(ss, tokens, lens, sparams, mask,
                                       prefix)
        S.copy_state(self.sampling_state, ss)
        return (torch.where(mask, ptok, last_tok),
                torch.where(mask, ptok != self.eos_id, active))

    def _resume_impl(self, tokens, rows, lens, sparams, mask, last_tok,
                     active, seeds, reseed, prefix=None):
        """The resume tier's launch: _admit_impl for the one slot `rows`
        (1,), `tokens` (1, tier bucket), its prefill over that row alone."""
        ss = self._reset_state(self.sampling_state, mask, seeds, reseed)
        rtok, ss, lengths = self._row_prefill_state(ss, tokens, rows, lens,
                                                    sparams, mask, prefix)
        self.cache.lengths.index_copy_(0, rows, lengths)
        S.copy_state(self.sampling_state, ss)
        ptok = last_tok.index_copy(0, rows, rtok)
        return (torch.where(mask, ptok, last_tok),
                torch.where(mask, ptok != self.eos_id, active))

    def _decode_impl(self, n_steps, kv_window, sparams, last_tok, active):
        """n_steps decode steps; returns (toks (B, n), last tok, active)."""
        max_seq = self.cache.max_seq
        ss = self.sampling_state
        tok, act = last_tok, active
        out = []
        for _ in range(n_steps):
            logits, _ = llama.decode_one(
                self.params, self.model_cfg, tok, self.cache, act,
                kv_window=kv_window, logits_base=self.logits_base,
                mesh=self.mesh)
            new_tok, ss = S.sample(logits, sparams, ss,
                                   base=self.logits_base)
            new_tok = torch.where(act, new_tok,
                                  torch.full_like(new_tok, self.eos_id))
            act = act & (new_tok != self.eos_id) & (
                self.cache.lengths < max_seq - 1)
            tok = new_tok
            out.append(new_tok)
        S.copy_state(self.sampling_state, ss)
        return torch.stack(out, dim=1), tok, act

    # -- launches: CUDA-graph replay or eager ----------------------------------

    def _static_inputs(self) -> dict:
        """The launches' input tensors, written before every launch (the
        graphs read them where they were captured)."""
        if self._static is None:
            b, dev = self.rows, self.device

            def zeros(dtype):
                return torch.zeros(b, dtype=dtype, device=dev)

            self._static = {
                "sp": S.SamplingParams.from_config(SamplingConfig(), b,
                                                   device=dev),
                "last_tok": zeros(torch.int32), "active": zeros(torch.bool),
                "lens": zeros(torch.int32), "mask": zeros(torch.bool),
                "seeds": zeros(torch.int64), "reseed": zeros(torch.bool),
                "tokens": {},        # prompt bucket → (B, bucket) int32
                # the resume tier's one row: bucket → (1, bucket), its slot
                "row_tokens": {},
                "rows": torch.zeros(1, dtype=torch.int64, device=dev),
            }
            if self.engine_cfg.prefix_cache:
                pb = self.engine_cfg.prefix_len
                self._static.update(
                    ptoks=torch.zeros((b, pb), dtype=torch.int32, device=dev),
                    plens=zeros(torch.int32), pidx=zeros(torch.int64),
                    build_toks=torch.zeros((1, pb), dtype=torch.int32,
                                           device=dev),
                    build_len=torch.zeros(1, dtype=torch.int32, device=dev),
                    build_idx=torch.zeros(1, dtype=torch.int64, device=dev))
        return self._static

    def _local(self, x):
        """This rank's slot rows of a whole-batch host array or tensor."""
        if self.mesh is None:
            return x
        return x[self.row0:self.row0 + self.rows]

    def _put(self, **inputs) -> None:
        """Copy a launch's inputs (host arrays or device tensors) into the
        input tensors, in stream order — under a mesh, this rank's slot rows
        of them; the resume row as this rank's index of the slot (0 where
        another dp rank holds it: the sliced mask masks it). A host array is
        pageable memory, which the CUDA driver stages before the copy call
        returns."""
        st = self._static_inputs()
        for name, x in inputs.items():
            if name in _SLOT_INPUTS:
                x = (type(x)(*map(self._local, x)) if name == "sp"
                     else self._local(x))
            elif name == "rows" and self.mesh is not None:
                x = [r - self.row0 if 0 <= r - self.row0 < self.rows else 0
                     for r in np.asarray(x).tolist()]
            if name == "sp":
                for dst, src in zip(st["sp"], x):
                    dst.copy_(src, non_blocking=True)
                continue
            if name in ("tokens", "row_tokens"):
                dst = st[name].get(x.shape[1])
                if dst is None:
                    dst = st[name][x.shape[1]] = torch.zeros(
                        x.shape, dtype=torch.int32, device=self.device)
            else:
                dst = st[name]
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.asarray(x)).to(dst.dtype)
            dst.copy_(x, non_blocking=True)

    def _gather_rows(self, out):
        """A launch's outputs, each with this rank's slot rows first, gathered
        over dp into whole-batch tensors: packed into one int32 tensor, one
        collective (inside the launch, so a graph captures it)."""
        cols = [t.to(torch.int32).reshape(self.rows, -1) for t in out]
        whole = collectives.all_gather_dp(torch.cat(cols, dim=1), self.mesh)
        res, at = [], 0
        for t, c in zip(out, cols):
            part = whole[:, at:at + c.shape[1]].reshape(
                (self.batch,) + tuple(t.shape[1:]))
            res.append(part != 0 if t.dtype == torch.bool else part)
            at += c.shape[1]
        return tuple(res)

    def _body(self, key) -> Callable:
        """The launch of `key` over the input tensors; under a mesh its
        outputs gathered over dp."""
        fn = self._body_local(key)
        if self.mesh is None or key[0] == "prefix_build":
            return fn
        return lambda: self._gather_rows(fn())

    def _body_local(self, key) -> Callable:
        st = self._static_inputs()
        if key[0] == "decode":
            return lambda: self._decode_impl(key[1], key[2], st["sp"],
                                             st["last_tok"], st["active"])
        if key[0] == "prefix_build":
            return lambda: self._prefix_build_impl(
                st["build_toks"], st["build_len"], st["build_idx"])
        if key[0] == "resume":
            # a resume-tier bucket admits as the core admits: through the
            # prefix cache when it is on
            prefix = ((st["ptoks"], st["plens"], st["pidx"])
                      if self.engine_cfg.prefix_cache else None)
            return lambda: self._resume_impl(
                st["row_tokens"][key[1]], st["rows"], st["lens"], st["sp"],
                st["mask"], st["last_tok"], st["active"], st["seeds"],
                st["reseed"], prefix)
        prefix = ((st["ptoks"], st["plens"], st["pidx"])
                  if key[0] == "admit_prefix" else None)
        return lambda: self._admit_impl(
            st["tokens"][key[1]], st["lens"], st["sp"], st["mask"],
            st["last_tok"], st["active"], st["seeds"], st["reseed"], prefix)

    def _launch(self, key, kind: Optional[str] = None, **inputs):
        """Write the inputs, then replay the graph of `key` (captured on
        first use) or, without graphs, run its body eagerly; the launch
        counts under `kind` (default: the key's). The outputs are the
        graph's own tensors, good until the next replay of any of the
        core's graphs: they share one memory pool, so a graph captured
        later may keep its intermediates where an earlier one keeps its
        outputs. The caller clones or copies them before that."""
        self._put(**inputs)
        kind = kind or _launch_kind(key)
        self.launches[kind] += 1
        if self.use_graphs:
            graph = self._graphs.get(key) or self._capture(key)
            self.replays[kind] += 1
            return graph.replay()
        t0 = time.perf_counter()
        out = self._body(key)()
        name = _census_name(key)
        if name not in self.graph_census_ms:
            # the eager census: the keys the card would capture
            self.graph_census_ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    def _warmed(self, *keys) -> bool:
        """Whether every key's graph is captured (its launch has run, on the
        eager path)."""
        return all(_census_name(k) in self.graph_census_ms for k in keys)

    def _graph_windows(self) -> List[int]:
        """Every KV window a decode launch can take."""
        return sorted({self.kv_bucket(w) for w in
                       list(self.engine_cfg.kv_buckets) + [self.max_seq]
                       if w <= self.max_seq} | {self.kv_bucket(1)})

    def resume_tier(self) -> List[int]:
        """The resume-tier buckets that get graphs of their own: each
        ``resume_buckets`` entry above the largest prompt bucket and within
        max_seq, on a paged on-demand core (the JAX package's condition for
        compiling them); a resume at a smaller bucket replays that prompt
        bucket's admission graph."""
        ecfg = self.engine_cfg
        if not (ecfg.paged_kv and ecfg.kv_on_demand):
            return []
        top = max(ecfg.prefill_buckets)
        return sorted({int(b) for b in ecfg.resume_buckets
                       if top < b <= self.max_seq})

    def _prepare(self) -> None:
        """Before this thread's first capture: one eager pass over every
        shape the graphs take — a decode step at each KV window, a prefill
        at each prompt bucket, a one-row prefill at each resume-tier bucket,
        the prefix build's prefill — with every slot masked, so that it
        changes no state (writes land in the trash row or block or the
        build's scratch cache, lengths stay, the sampled state is dropped)
        and counts no launch. It does what a capture must not: the kernel
        build, this thread's cuBLAS handles, the rope table, the kernels'
        one-time attributes, the K4 / K2 plans, and the growth of the
        attention / K4 workspace to every shape. Under a mesh the first pass
        also sets up the groups' communicators (a dp gather included), and a
        later thread's pass runs its collectives locally
        (``collectives.local_only``): only this rank takes it, where the
        other ranks take none."""
        tid = threading.get_ident()
        if tid in self._prepared:
            return
        t0 = time.perf_counter()
        b, dev = self.rows, self.device
        none = torch.zeros(b, dtype=torch.bool, device=dev)
        zeros = torch.zeros(b, dtype=torch.int32, device=dev)
        st = self._static_inputs()
        sp = st["sp"]
        buckets = sorted(set(self.engine_cfg.prefill_buckets)
                         | {self.engine_cfg.max_input_len})
        prefix = None
        alone = (collectives.local_only() if self.mesh is not None
                 and self._prepared else contextlib.nullcontext())
        with _build.record_launches(), alone:
            if self.mesh is not None:
                self._gather_rows((zeros, none))
            if self.engine_cfg.prefix_cache:
                # the build's prefill into its scratch cache (no pool write)
                self._build_forward(torch.zeros_like(st["build_toks"]),
                                    torch.zeros_like(st["build_len"]))
                prefix = (torch.zeros_like(st["ptoks"]), zeros,
                          torch.zeros_like(st["pidx"]))
            for w in self._graph_windows():
                logits, _ = llama.decode_one(
                    self.params, self.model_cfg, zeros, self.cache, none,
                    kv_window=w, logits_base=self.logits_base,
                    mesh=self.mesh)
                S.sample(logits, sp, self.sampling_state,
                         base=self.logits_base)
            for bucket in buckets:
                tokens = torch.zeros((b, bucket), dtype=torch.int32,
                                     device=dev)
                self._prefill_state(self.sampling_state, tokens, zeros, sp,
                                    none, prefix)
            for bucket in self.resume_tier():
                tokens = torch.zeros((1, bucket), dtype=torch.int32,
                                     device=dev)
                self._row_prefill_state(self.sampling_state, tokens,
                                        st["rows"], zeros, sp, none, prefix)
        torch.cuda.synchronize(dev)
        self._prepared.add(tid)
        self.prepare_ms += (time.perf_counter() - t0) * 1e3

    def _capture(self, key) -> _Graph:
        """Capture the launch of `key` into a CUDA graph (on torch's side
        stream, into the core's memory pool), recording the kernel launches
        one replay stands for; a capture that fails raises."""
        with _CAPTURE_LOCK:
            self._prepare()
            t0 = time.perf_counter()
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            # thread_local: the vocode threads keep launching meanwhile
            with _build.record_launches() as launches, torch.cuda.graph(
                    graph, pool=self._graph_pool,
                    capture_error_mode="thread_local"):
                outputs = self._body(key)()
            ms = (time.perf_counter() - t0) * 1e3
        self._graphs[key] = g = _Graph(graph, outputs, launches)
        name = _census_name(key)
        self.graph_census_ms[name] = ms
        if not self._warming:
            self.late_captures += 1
            log.warning("captured %s on first use (%.0f ms): warmup_graphs "
                        "did not reach it", name, ms)
        return g

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
        + decode-call slack, rounded up to whole blocks. With the prefix
        cache the injected prefix takes block positions on top of the
        suffix bucket: counted as prefix_len, as the JAX package does."""
        bs_blk = self.engine_cfg.kv_block_size
        pfx = self.engine_cfg.prefix_len if self.engine_cfg.prefix_cache \
            else 0
        budget = 0 if self.engine_cfg.kv_on_demand else max_tokens
        total = min(self.bucket_len(prompt_len) + pfx + budget
                    + self.engine_cfg.decode_steps_per_call + 2, self.max_seq)
        return -(-total // bs_blk) * bs_blk

    def _push_table(self) -> None:
        """Copy the host block table into the device table, in place and
        ordered on the stream: launches enqueued before read the old table,
        launches after it the new one. The source is pageable host memory,
        which the CUDA driver stages before the copy call returns, so the
        host table may change again at once."""
        self.cache.block_table.copy_(
            torch.from_numpy(self._local(self._table_host)),
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
        inverse, and together they make preempt → resume bit-identical.
        Under a mesh the row is gathered over dp from the rank that holds
        it: every rank must make the call."""
        ss = self.sampling_state
        if self.mesh is not None:
            li = self._local_row(slot)
            ss = S.SamplingState(*(collectives.all_gather_dp(
                t[li:li + 1] if li is not None else t[:1], self.mesh)
                for t in ss))
            slot = slot // self.rows
        return {"presence": to_numpy(ss.presence[slot]).copy(),
                "seed": int(ss.seed[slot]), "step": int(ss.step[slot]),
                "in_speech": bool(ss.in_speech[slot]),
                "frame_pos": int(ss.frame_pos[slot])}

    def _local_row(self, slot: int) -> Optional[int]:
        """This rank's row of `slot`, None where another dp rank holds it."""
        li = slot - self.row0
        return li if 0 <= li < self.rows else None

    def restore_slot(self, slot: int, snap: dict) -> None:
        """Write a snapshot_slot dict back into the slot's sampling state
        (after the resume re-prefill, whose reset and first sample
        clobbered it), in place on the stream; under a mesh only by the rank
        that holds the slot."""
        ss = self.sampling_state
        slot = self._local_row(slot)
        if slot is None:
            return
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
                       reserve_extra: Optional[Sequence[int]],
                       plens=None) -> None:
        """Paged: reserve each admitted slot's blocks — its injected prefix
        (plens[slot], prefix cache) + bucket + its token budget (default
        max_output_len) + slack, or with kv_on_demand only the prefill
        window and one decode-call window."""
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
        self._reserve_blocks(slots, [
            min((int(plens[sl]) if plens is not None else 0) + bucket + e
                + slack, self.max_seq) for sl, e in zip(slots, extras)])

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
        S.copy_state(self.sampling_state, self._reset_state(
            self.sampling_state,
            self._t(self._local(self._mask(slots)), torch.bool),
            self._t(self._local(seed_arr), torch.int64),
            self._t(self._local(reseed), torch.bool)))

    @torch.no_grad()
    def reset_slots(self, slots: Sequence[int]) -> None:
        """Clear the slots' lengths, presence and speech state for reuse
        (paged: release their blocks); their noise seeds stay."""
        self.reset_and_seed(slots)

    @torch.no_grad()
    def seed_slots(self, slots: Sequence[int], seeds: Sequence[int]) -> None:
        """Restart the slots' noise counters at the requests' seeds (the
        per-request ``seed`` sampling knob), as an admission's reseed does;
        nothing else of the slots changes."""
        seed_arr, reseed = self._seed_arrays(slots, seeds)
        S.copy_state(self.sampling_state, self._reseed(
            self.sampling_state,
            self._t(self._local(reseed), torch.bool),
            self._t(self._local(seed_arr), torch.int64)))

    def _prompt_batch(self, prompts, slots, bucket):
        """Host arrays (tokens (B, bucket), lens (B,), mask (B,))."""
        tokens = np.zeros((self.batch, bucket), np.int32)
        lens = np.zeros(self.batch, np.int32)
        for p, sl in zip(prompts, slots):
            p = list(p)[:bucket]
            tokens[sl, : len(p)] = p
            lens[sl] = len(p)
        return tokens, lens, self._mask(slots)

    # -- prefix-cache host side ------------------------------------------------

    MIN_PREFIX = 4   # prefixes shorter than this are not cached

    def prefix_cut(self, n: int) -> int:
        """Tokens of an n-token prompt that the prefix cache serves (0 when
        it is off or the prompt is too short): the suffix is never empty."""
        if not self.engine_cfg.prefix_cache:
            return 0
        cut = min(n - 1, self.engine_cfg.prefix_len)
        return cut if cut >= self.MIN_PREFIX else 0

    def _acquire_prefixes(self, prompts: Sequence[Sequence[int]]):
        """Split prompts into (cached prefix, suffix), building the pool
        entries of missing prefixes (a miss takes a free row or evicts the
        least recently used entry; each build is one launch, enqueued
        before the admission that reads it). Returns (suffixes, pool rows,
        prefix lengths, prefix rows padded to PB)."""
        pb = self.engine_cfg.prefix_len
        suffixes, pidxs, plens, rows = [], [], [], []
        for p in prompts:
            p = list(p)
            cut = self.prefix_cut(len(p))
            if not cut:
                suffixes.append(p)
                pidxs.append(0)
                plens.append(0)
                rows.append([0] * pb)
                continue
            key = tuple(p[:cut])
            idx = self._prefix_map.get(key)
            if idx is None:
                if self._prefix_free:
                    idx = self._prefix_free.pop()
                else:   # LRU eviction
                    _, idx = self._prefix_map.popitem(last=False)
                ptok = np.zeros((1, pb), np.int32)
                ptok[0, :cut] = p[:cut]
                self._launch(("prefix_build",), build_toks=ptok,
                             build_len=[cut], build_idx=[idx])
                self._prefix_map[key] = idx
                self.prefix_misses += 1
            else:
                self._prefix_map.move_to_end(key)
                self.prefix_hits += 1
            suffixes.append(p[cut:])
            pidxs.append(idx)
            plens.append(cut)
            rows.append(p[:cut] + [0] * (pb - cut))
        return suffixes, pidxs, plens, rows

    def _prefix_batch_arrays(self, prompts, slots, bucket=None):
        """Host arrays of a prefix-cache admission over the slot batch;
        `bucket` overrides the SUFFIX bucket."""
        suffixes, pidxs, plens_l, rows = self._acquire_prefixes(prompts)
        pb = self.engine_cfg.prefix_len
        bucket = bucket or self.bucket_len(
            max((len(s) for s in suffixes), default=1))
        tokens, lens, mask = self._prompt_batch(suffixes, slots, bucket)
        ptoks = np.zeros((self.batch, pb), np.int32)
        plens = np.zeros(self.batch, np.int32)
        pidx = np.zeros(self.batch, np.int32)
        for pi, pl, row, sl in zip(pidxs, plens_l, rows, slots):
            ptoks[sl] = row
            plens[sl] = pl
            pidx[sl] = pi
        bounds = {sl: pl + min(len(suf), bucket) + 1
                  for suf, pl, sl in zip(suffixes, plens_l, slots)}
        return tokens, lens, ptoks, plens, pidx, mask, bounds

    def _admission(self, prompts, slots, bucket=None):
        """(launch key, host inputs, the admitted slots' length bounds) of
        admitting `prompts` into `slots`: the plain admission of the prompt
        bucket, or with the prefix cache the prefix admission of the suffix
        bucket (missing prefixes built first). `bucket` overrides the
        (suffix) bucket."""
        if self.engine_cfg.prefix_cache:
            tokens, lens, ptoks, plens, pidx, mask, bounds = \
                self._prefix_batch_arrays(prompts, slots, bucket)
            return (("admit_prefix", tokens.shape[1]),
                    dict(tokens=tokens, lens=lens, mask=mask, ptoks=ptoks,
                         plens=plens, pidx=pidx), bounds)
        bucket = bucket or self.bucket_len(
            max((len(p) for p in prompts), default=1))
        tokens, lens, mask = self._prompt_batch(prompts, slots, bucket)
        bounds = {sl: min(len(p), bucket) + 1
                  for p, sl in zip(prompts, slots)}
        return ("admit", bucket), dict(tokens=tokens, lens=lens,
                                       mask=mask), bounds

    @torch.no_grad()
    def prefill_slots(self, prompts: Sequence[Sequence[int]],
                      slots: Sequence[int], sparams: S.SamplingParams,
                      reserve_extra: Optional[Sequence[int]] = None,
                      seeds: Optional[Sequence[Optional[int]]] = None,
                      bucket: Optional[int] = None) -> np.ndarray:
        """Prefill the given slots; returns their first tokens (B,) on the
        host (other slots: 0). Runs over the whole slot batch; other slots
        are untouched. Paged, each slot reserves its injected prefix +
        bucket + reserve_extra[i] tokens of blocks (default
        max_output_len). ``bucket`` overrides the prompt's (with the prefix
        cache: the suffix's) bucket: the preemption resume re-prefills
        through the resume tier so. One launch — the slot reset with the
        reseeds of ``reset_and_seed``, the prefill and the first sample —
        counted as a resume: on the card a replay of the bucket's admission
        graph or of its resume-tier graph, which takes one slot (one launch
        a slot)."""
        assert len(prompts) == len(slots)
        if len(slots) > 1 and bucket in self.resume_tier():
            toks = np.zeros(self.batch, np.int32)
            for i, (p, sl) in enumerate(zip(prompts, slots)):
                toks[sl] = self.prefill_slots(
                    [p], [sl], sparams,
                    None if reserve_extra is None else [reserve_extra[i]],
                    None if seeds is None else [seeds[i]], bucket)[sl]
            return toks
        key, inp, bounds = self._admission(prompts, slots, bucket)
        if key[1] in self.resume_tier() and len(slots) == 1:
            # else the bucket's admission graph
            key = ("resume", key[1])
            inp["row_tokens"] = inp.pop("tokens")[list(slots)]
            inp["rows"] = np.asarray(slots, np.int64)
        self._reset_host(slots)
        seed_arr, reseed = self._seed_arrays(slots, seeds)
        self._maybe_reserve(slots, key[1], reserve_extra, inp.get("plens"))
        tok0, _ = self._launch(
            key, kind="resume", sp=sparams,
            last_tok=np.zeros(self.batch, np.int32),
            active=np.zeros(self.batch, bool), seeds=seed_arr,
            reseed=reseed, **inp)
        tok = to_numpy(tok0)    # on the host before the next replay
        self.prefills += 1
        for sl, b in bounds.items():
            self._len_bounds[sl] = b
        return tok

    @torch.no_grad()
    def prefill_decode_launch(self, prompts: Sequence[Sequence[int]],
                              slots: Sequence[int],
                              sparams: S.SamplingParams, last_tok, active,
                              n: Optional[int] = None,
                              reserve_extra: Optional[Sequence[int]] = None,
                              kv_window: Optional[int] = None,
                              seeds: Optional[Sequence[Optional[int]]] = None):
        """Fused admission prefill + n decode steps, launched without
        waiting: the admission launch of the prompt bucket, then the decode
        launch of (n, window), in one host visit. Returns device tensors
        (toks (B, n+1), last_tok, active); column 0 of toks is the
        prefill-sampled token (non-admitted slots repeat their last token
        there). kv_window None = smallest bucket covering every live slot;
        reserve_extra as in prefill_slots."""
        n = n or self.engine_cfg.decode_steps_per_call
        assert len(prompts) == len(slots)
        key, inp, bounds = self._admission(prompts, slots)
        self._reset_host(slots)
        seed_arr, reseed = self._seed_arrays(slots, seeds)
        self._maybe_reserve(slots, key[1], reserve_extra, inp.get("plens"))
        for sl, b in bounds.items():
            self._len_bounds[sl] = b
        if self.engine_cfg.paged_kv and self.engine_cfg.kv_on_demand:
            # the slots already live decode too; on the prefix cache's
            # branch as well, which the JAX package's lacks (ROADMAP.md
            # Queue 3)
            self._grow_blocks(n)
        needed = int(self._len_bounds.max(initial=0)) + n + 1
        window = kv_window or self.kv_bucket(needed)
        tok0, act0 = self._launch(
            key, sp=sparams, last_tok=last_tok, active=active, seeds=seed_arr,
            reseed=reseed, **inp)
        tok0 = tok0.clone()     # before the next replay can overwrite it
        toks, tok, act = self._launch(("decode", n, window), last_tok=tok0,
                                      active=act0)
        self.prefills += 1
        self.steps_launched += n
        self._len_bounds[self._len_bounds > 0] += n
        return torch.cat([tok0[:, None], toks], dim=1), tok.clone(), \
            act.clone()

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
        toks, tok, act = self._launch(("decode", n, window), sp=sparams,
                                      last_tok=last_tok, active=active)
        self.steps_launched += n
        # conservative host bound: every occupied slot may grow by n
        self._len_bounds[self._len_bounds > 0] += n
        return toks.clone(), tok.clone(), act.clone()

    @property
    def decode_steps(self) -> _StepCount:
        """The decode steps launched so far; called, n decode steps that
        return host arrays (tokens (B, n), last_tok (B,), active (B,)), as
        the JAX package's ``decode_steps``: a blocking
        ``decode_steps_launch``."""
        return _StepCount(self.steps_launched, self)

    def _decode_steps_host(self, sparams: S.SamplingParams, last_tok,
                           active, n: Optional[int] = None):
        toks, tok, act = self.decode_steps_launch(sparams, last_tok, active,
                                                  n)
        return to_numpy(toks), to_numpy(tok), to_numpy(act)

    def _masked_resume(self, bucket: int, sp: S.SamplingParams) -> None:
        """Launch (capture) the resume tier's graph of `bucket` with every
        slot masked out, as the eager pass of _prepare runs: the writes land
        in the trash block, no length and no sampled state changes, and no
        block is reserved. The block table is read inside the graph, so the
        one graph serves every table state. Counted as a warmup launch, not
        as a resume."""
        b, pb = self.batch, self.engine_cfg.prefix_len
        inp = dict(row_tokens=np.zeros((1, bucket), np.int32),
                   rows=np.zeros(1, np.int64),
                   lens=np.zeros(b, np.int32), mask=np.zeros(b, bool),
                   last_tok=np.zeros(b, np.int32), active=np.zeros(b, bool),
                   seeds=np.zeros(b, np.int64), reseed=np.zeros(b, bool))
        if self.engine_cfg.prefix_cache:
            inp.update(ptoks=np.zeros((b, pb), np.int32),
                       plens=np.zeros(b, np.int32), pidx=np.zeros(b, np.int64))
        to_numpy(self._launch(("resume", bucket), kind="warmup", sp=sp,
                              **inp)[0])

    def warmup_graphs(self, timer: Optional[PhaseTimer] = None,
                      first_bursts: Sequence[int] = (),
                      admission_ns: Optional[Sequence[int]] = None) -> dict:
        """Capture the admission graph of every prompt bucket and the decode
        graph of every (steps, KV window) the engine can reach — the JAX
        package's enumeration (``EngineCore.warmup_graphs`` there), whose
        fused (bucket, steps, window) graphs map here onto an admission
        graph and a decode graph each (the prefix cache's admission graph
        of the suffix bucket, and its build graph, with ``prefix_cache``).
        A paged on-demand core also captures the resume tier
        (``capture_prefill_resume_{b}``, the JAX package's
        ``compile_prefill_resume_{b}``), every slot masked, so that no
        block is reserved. On the CPU the same launches run eagerly, so the
        census names what the card would capture.

        `first_bursts`: extra fused-launch step counts (the single-stream
        first dispatch covers the whole first audio chunk); `admission_ns`:
        the scheduler's fused-admission step counts (default {n, 2n}). A
        bucket-b prompt may be shorter than b, so a bucket-b admission can
        need any window from kv_bucket(shortest prompt + steps + 2) up: each
        window is reached by a probe whose length needs it exactly, or, when
        the probe alone cannot, by a live neighbour's length bound. Paged,
        the probes' blocks are released at the end."""
        t = timer or PhaseTimer()
        windows = self._graph_windows()
        if self.device.type == "cuda" and not self.use_graphs:
            # an eager core on the card (graphs=False) captures nothing:
            # one eager pass initialises the kernels and the libraries
            with t.phase("warmup_eager"):
                self._prepare()
            return {"warmed_windows": windows,
                    "warmed_buckets": list(self.engine_cfg.prefill_buckets),
                    "graphs_compiled": 0, "graph_census_ms": {}}
        sp = S.SamplingParams.from_config(SamplingConfig(greedy=True),
                                          self.batch, device=self.device)
        n = self.engine_cfg.decode_steps_per_call
        zeros_tok = np.zeros(self.batch, np.int32)
        zeros_act = np.zeros(self.batch, bool)
        fused_ns = sorted({max(n - 1, 1)} | {
            max(int(b) - 1, 1) for b in first_bursts if b})
        adm_ns = sorted({int(a) for a in admission_ns if a}
                        if admission_ns else {n, 2 * n})
        all_ns = sorted(set(fused_ns) | set(adm_ns))
        adm_windows = sorted({self.kv_bucket(w) for w in
                              list(self.engine_cfg.kv_buckets)
                              + [self.max_seq] if w <= self.max_seq})
        # with the prefix cache the first prefix_len tokens are cached and
        # the SUFFIX picks the bucket: every probe is padded by plen (they
        # share one prefix: the first probe misses and captures the build)
        plen = self.engine_cfg.prefix_len if self.engine_cfg.prefix_cache \
            else 0
        admit = "admit_prefix" if plen else "admit"
        self._warming = True
        try:
            prev_b = 0
            for b in self.engine_cfg.prefill_buckets:
                min_len = prev_b + 1  # shortest prompt that lands in bucket b
                for nn in all_ns:
                    for w in adm_windows:
                        # smallest window any bucket-b prompt can need at nn
                        if w < self.kv_bucket(min_len + plen + nn + 2):
                            continue
                        # probe length that needs window w exactly
                        length = min(b, max(min_len, w - plen - nn - 2))
                        direct = self.kv_bucket(length + plen + nn + 2) == w
                        if not direct and self.batch == 1:
                            continue  # one slot cannot reach w here
                        if self._warmed((admit, b), ("decode", nn, w)):
                            continue    # both graphs captured already
                        probe = [1] * ((length if direct else min_len) + plen)
                        saved = self._len_bounds.copy()
                        with t.phase(f"warmup_prefill_decode_{b}_n{nn}_w{w}"):
                            if not direct:
                                # a live neighbour at w-nn-1 forces window w
                                self._len_bounds[1] = max(w - nn - 1, 1)
                            try:
                                toks, _, _ = self.prefill_decode_launch(
                                    [probe], [0], sp, zeros_tok, zeros_act,
                                    n=nn)
                                to_numpy(toks)
                            finally:
                                self._len_bounds[:] = saved
                prev_b = b
            # release the last probe's blocks first: the decode probes' length
            # bounds would grow them to the whole window, which an on-demand
            # pool smaller than that cannot give (the JAX package's fault)
            self._reset_host(list(range(self.batch)))
            for b in self.resume_tier():
                if self._warmed(("resume", b)):
                    continue
                with t.phase(f"warmup_prefill_resume_{b}"):
                    self._masked_resume(b, sp)
            for w in windows:
                if self._warmed(("decode", n, w)):
                    continue
                with t.phase(f"warmup_decode_w{w}"):
                    saved = self._len_bounds.copy()
                    self._len_bounds[:] = max(w - n - 1, 1)
                    try:
                        to_numpy(self.decode_steps_launch(
                            sp, zeros_tok, zeros_act, n)[0])
                    finally:
                        self._len_bounds[:] = saved
        finally:
            self._warming = False
        self.reset_and_seed(list(range(self.batch)))
        census = dict(self.graph_census_ms)
        return {"warmed_windows": windows,
                "warmed_buckets": list(self.engine_cfg.prefill_buckets),
                "graphs_compiled": len(census),
                "graph_census_ms": census}


class GenerationEngine:
    """Single-stream host API over EngineCore (slot 0)."""

    def __init__(self, params, model_cfg: ModelConfig,
                 engine_cfg: Optional[EngineConfig] = None, *,
                 eos_id: int = protocol.TOKEN_EOS, seed: int = 0,
                 device=None, first_bursts: Sequence[int] = (), mesh=None,
                 graphs: bool = True):
        self.engine_cfg = engine_cfg or EngineConfig()
        # slot 0 serves; under a dp > 1 mesh the batch is padded to dp so
        # that the slot axis shards evenly (the other rows are dummies, as
        # in the JAX package)
        self.core = EngineCore(params, model_cfg, self.engine_cfg,
                               batch_size=1 if mesh is None else mesh.dp,
                               eos_id=eos_id, seed=seed, device=device,
                               mesh=mesh, graphs=graphs)
        self.eos_id = eos_id
        # registered first-dispatch burst sizes (tokens): the first launch
        # covers the whole first audio chunk when the caller's need matches
        self.first_bursts = sorted({int(b) for b in first_bursts
                                    if b and int(b) > 1})

    def warmup(self) -> dict:
        t = PhaseTimer()
        info = self.core.warmup_graphs(t, first_bursts=self.first_bursts)
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
