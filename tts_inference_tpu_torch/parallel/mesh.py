"""Device mesh + sharding rules: tensor parallelism (tp) and data
parallelism (dp) over torch.distributed.

Port of ``tts_inference_tpu/parallel/mesh.py``. There a
``jax.sharding.Mesh`` of axes (dp, tp) and PartitionSpecs are handed to
XLA, which inserts the collectives. In PyTorch one process drives one
device and nothing inserts collectives, so a mesh here is this process's
place in a group of processes — its (dp, tp) coordinates and the process
groups of its tp row and its dp column — and the model calls its
collectives itself (``collectives.py``). The rank layout is tp-inner: a tp
group is ``tp`` consecutive ranks, which ``multihost.make_global_mesh``
keeps on one host, as the JAX package keeps tp inside a host.

The spec trees have the JAX package's tree shapes, with a tuple of axis
names (or None) where JAX has a PartitionSpec: Megatron-style, q/k/v/gate/
up are column-parallel over tp and o/down row-parallel; KV caches shard
slots over dp and kv heads over tp; the sampling state and parameters
shard slots over dp. ``shard_tree`` cuts each full tensor to this rank's
block where it lies — on the host, as the loaders leave it — and moves only
the block to the mesh's device, so a rank never holds the whole checkpoint
on its card.

The vocabulary is partitioned differently from JAX's even split
``P("tp", None)`` (axis name ``"tp_vocab"`` here): the text rows [0,
HEAD_SLICE_BASE) and the rows [HEAD_SLICE_BASE, V) — specials and audio,
all the sliced decode head reads — are each split evenly over tp, and a
rank holds its text block then its audio block, each padded with zero rows
to the largest block. JAX's even split would leave the whole 28,940-row
sliced head on the last tp rank while the others idle through one of the
largest products of a decode step; here every rank computes 28,940 / tp
of it. The lookup masks the rows a rank does not own and sums over tp, and
the logits are gathered and put back in vocabulary order, so the tokens
are the same as JAX's.

int4 weights (``QuantLinearI4``) are cut as the logical (K, N) matrix
they encode: a column shard takes its columns of the packed rows and pads
them to 128 again; a row shard is unpacked, cut and packed anew in the
split-half format of its own K. Its group g′ is the largest that divides
both the checkpoint's group g and each packed half of the shard's K
(``shard_group``), and each of its scale rows is the scale of the g-group
its rows lie in, so the dequantized shard is bit-equal to the rows of the
whole matrix it holds. ``gather_tree`` is the inverse of ``shard_tree``:
the whole tensors back on every rank, an int4 row shard's scales back at
the checkpoint's group.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from tts_inference_tpu_torch import protocol
from tts_inference_tpu_torch.config import MeshConfig, ModelConfig
from tts_inference_tpu_torch.models.quant import (QuantEmbed, QuantLinear,
                                                  QuantLinearI4)
from tts_inference_tpu_torch.ops.int4_matmul import pack_int4, unpack_int4

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass
class Mesh:
    """This process's place in a (dp, tp) mesh of processes, one device
    each: `rank` is its index in the mesh, dp-major (rank = dp_rank * tp +
    tp_rank); `tp_group` / `dp_group` are the process groups of its tp row
    and dp column; `backend` is the default group's ("nccl" or "gloo")."""

    dp: int
    tp: int
    rank: int
    world: int
    tp_group: Any
    dp_group: Any
    device: torch.device
    backend: str = "gloo"

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def gather_by_sum(self) -> bool:
        """Gathers are written as a sum over a zeroed buffer: gloo supports
        only all_reduce and broadcast on CUDA tensors (torch.distributed's
        backend table), so every gloo gather takes this form; NCCL gathers
        directly. Chosen once, from the backend, when the mesh is built."""
        return self.backend != "nccl"


_GROUPS: Dict[tuple, Any] = {}


def _group(ranks: Tuple[int, ...]):
    """The process group of `ranks`, created once per default group (every
    process of the default group must take part in creating it)."""
    import torch.distributed as dist

    key = (id(dist.group.WORLD), ranks)
    g = _GROUPS.get(key)
    if g is None:
        g = _GROUPS[key] = dist.new_group(list(ranks))
    return g


def make_mesh(cfg: MeshConfig, device=None,
              ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """The (dp, tp) mesh over `ranks` (default: the first dp·tp ranks) of
    the initialised default process group. Every process of the default
    group must call it with the same arguments; one outside `ranks` gets
    None. `device`: this rank's device (default: the current CUDA device
    under NCCL, else the CPU)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process "
                           "group (parallel.multihost.init_multihost)")
    n = cfg.num_devices
    world = dist.get_world_size()
    ranks = tuple(range(n)) if ranks is None else tuple(int(r) for r in ranks)
    if len(ranks) != n or n > world:
        raise ValueError(f"need {n} devices, have {min(len(ranks), world)}")
    tp_groups = [_group(ranks[d * cfg.tp:(d + 1) * cfg.tp])
                 for d in range(cfg.dp)]
    dp_groups = [_group(ranks[t::cfg.tp]) for t in range(cfg.tp)]
    me = dist.get_rank()
    if me not in ranks:
        return None
    r = ranks.index(me)
    backend = str(dist.get_backend())
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    return Mesh(dp=cfg.dp, tp=cfg.tp, rank=r, world=n,
                tp_group=tp_groups[r // cfg.tp],
                dp_group=dp_groups[r % cfg.tp], device=torch.device(device),
                backend=backend)


def shard_group(k: int, g: int, tp: int) -> int:
    """The group g′ of a row shard of an int4 (K, N) matrix of group g cut
    over tp: the largest group that divides both g and each packed half of
    the shard's K/tp rows."""
    return math.gcd(g, k // tp // 2)


def validate_tp(model_cfg: ModelConfig, tp: int, params=None) -> None:
    """The JAX package's three checks, with its messages; with `params`,
    also that every int4 row-parallel shard (o, down) has a group g′
    (``shard_group``) that is a multiple of 8, as K4's tensor-core path
    needs."""
    if model_cfg.num_key_value_heads % tp:
        raise ValueError(
            f"num_key_value_heads={model_cfg.num_key_value_heads} not "
            f"divisible by tp={tp}"
        )
    if model_cfg.num_attention_heads % tp:
        raise ValueError("num_attention_heads not divisible by tp")
    if model_cfg.intermediate_size % tp:
        raise ValueError("intermediate_size not divisible by tp")
    if params is None or tp == 1:
        return
    for li, lp in enumerate(params["layers"]):
        for name in ("wo", "w_down"):
            w = lp[name]
            if not isinstance(w, QuantLinearI4):
                continue
            k = w.w_p.shape[0] * 2
            g = k // w.scale.shape[0]
            if (k // tp) % 2 or shard_group(k, g, tp) % 8:
                raise ValueError(
                    f"int4 {name} of layer {li}: no group that divides both "
                    f"the checkpoint's group {g} and each packed half of "
                    f"K/tp = {k}/{tp} rows is a multiple of 8 (K4's "
                    "tensor-core path); quantize with another group "
                    "(TTS_INT4_GROUP)")


def validate_kv_int4(model_cfg: ModelConfig, tp: int) -> None:
    """Head-pair packing: a tp shard must own whole pairs."""
    pairs = model_cfg.num_key_value_heads // 2
    if pairs % tp:
        raise ValueError(f"int4 KV under TP needs tp | kv_heads/2 "
                         f"(pairs={pairs}, tp={tp})")


def local_model_config(model_cfg: ModelConfig, tp: int) -> ModelConfig:
    """The per-rank head and FFN counts under tp (the KV cache's and the
    prefix pool's geometry)."""
    if tp == 1:
        return model_cfg
    return dataclasses.replace(
        model_cfg,
        num_attention_heads=model_cfg.num_attention_heads // tp,
        num_key_value_heads=model_cfg.num_key_value_heads // tp,
        intermediate_size=model_cfg.intermediate_size // tp)


# -- the vocabulary partition ----------------------------------------------


def _even(n: int, parts: int) -> List[Tuple[int, int]]:
    """(start, size) of each of `parts` near-equal blocks of n."""
    base, extra = divmod(n, parts)
    out, start = [], 0
    for i in range(parts):
        size = base + (1 if i < extra else 0)
        out.append((start, size))
        start += size
    return out


@dataclasses.dataclass(frozen=True)
class VocabShards:
    """The head-slice partition of `vocab` rows over `tp` ranks: rank r
    holds text rows text[r] (start, size) of [0, split) padded to `tc`
    rows, then audio rows split + audio[r].start, … padded to `ac`."""

    vocab: int
    tp: int
    split: int
    text: Tuple[Tuple[int, int], ...]
    audio: Tuple[Tuple[int, int], ...]

    @property
    def tc(self) -> int:
        return max(s for _, s in self.text)

    @property
    def ac(self) -> int:
        return max((s for _, s in self.audio), default=0)

    @property
    def rows(self) -> int:
        return self.tc + self.ac

    def local_index(self, tokens: torch.Tensor, r: int):
        """(local row, owned) of token ids on rank r."""
        t = tokens.long()
        (ts, tn), (as_, an) = self.text[r], self.audio[r]
        a0 = self.split + as_
        in_text = (t >= ts) & (t < ts + tn)
        in_audio = (t >= a0) & (t < a0 + an)
        local = torch.where(in_text, t - ts, t - a0 + self.tc)
        own = in_text | in_audio
        return torch.where(own, local, torch.zeros_like(local)), own

    def own_rows(self, r: int, device=None) -> torch.Tensor:
        """(rows,) bool: the local rows of rank r that hold a token (the
        others are padding)."""
        i = torch.arange(self.rows, device=device)
        return (i < self.text[r][1]) | (
            (i >= self.tc) & (i < self.tc + self.audio[r][1]))

    def cut(self, t: torch.Tensor, dim: int, r: int) -> torch.Tensor:
        """Rank r's rows of a full (…, vocab, …) tensor along `dim`, padded
        with zeros."""
        parts = []
        for (start, size), width, off in ((self.text[r], self.tc, 0),
                                          (self.audio[r], self.ac,
                                           self.split)):
            if width == 0:
                continue
            blk = t.narrow(dim, off + start, size)
            if size < width:
                pad = list(blk.shape)
                pad[dim] = width - size
                blk = torch.cat([blk, blk.new_zeros(pad)], dim=dim)
            parts.append(blk)
        return torch.cat(parts, dim=dim).contiguous()

    def assemble(self, g: torch.Tensor, base: int) -> torch.Tensor:
        """Gathered logits g (tp, …, width) → (…, vocab - base) in
        vocabulary order. base 0: width is the whole local block; base
        `split`: only the audio blocks were computed."""
        if base == self.split:
            if all(s == self.ac for _, s in self.audio):
                return g.movedim(0, -2).reshape(*g.shape[1:-1], -1)
            return torch.cat([g[r, ..., :s] for r, (_, s)
                              in enumerate(self.audio)], dim=-1)
        return self.uncut(g, -1)

    def uncut(self, g: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor of the gathered blocks g (tp, …): each rank's
        rows back in vocabulary order along `dim` of a block (the inverse
        of ``cut``)."""
        parts = [g[r].narrow(dim, 0, s) for r, (_, s) in enumerate(self.text)]
        if self.ac:
            parts += [g[r].narrow(dim, self.tc, s)
                      for r, (_, s) in enumerate(self.audio)]
        return torch.cat(parts, dim=dim)


@functools.lru_cache(maxsize=32)
def vocab_shards(vocab: int, tp: int,
                 base: int = protocol.HEAD_SLICE_BASE) -> VocabShards:
    """The partition of `vocab` rows over tp (split at HEAD_SLICE_BASE when
    the vocabulary reaches past it, else one even split)."""
    split = base if vocab > base else vocab
    return VocabShards(vocab, tp, split, tuple(_even(split, tp)),
                       tuple(_even(vocab - split, tp)))


# -- spec trees -------------------------------------------------------------


def llama_param_pspecs(model_cfg: ModelConfig) -> Dict[str, Any]:
    """Spec tree matching models/llama.py params (the JAX package's, with
    the head-slice vocabulary partition for the embedding and the head)."""
    layer = {
        "input_norm": (),
        "post_attn_norm": (),
        "wq": (None, "tp"),
        "wk": (None, "tp"),
        "wv": (None, "tp"),
        "wo": ("tp", None),
        "w_gate": (None, "tp"),
        "w_up": (None, "tp"),
        "w_down": ("tp", None),
    }
    specs: Dict[str, Any] = {
        "embed": ("tp_vocab", None),
        "final_norm": (),
        "layers": [dict(layer) for _ in range(model_cfg.num_hidden_layers)],
    }
    if not model_cfg.tie_word_embeddings:
        specs["lm_head"] = (None, "tp_vocab")
    return specs


def _is_spec(s) -> bool:
    return (isinstance(s, tuple) and not hasattr(s, "_fields")
            and all(a is None or isinstance(a, str) for a in s))


def adapt_pspecs(pspecs, params):
    """Adapt a dense spec tree to quantized leaves: the integer tensor keeps
    the dense spec and the scale shards along its own axis (out channels of
    a linear, rows of an embedding; an int4 linear's group axis is never
    sharded)."""
    def fix(spec, leaf):
        if isinstance(leaf, QuantLinearI4):
            return QuantLinearI4(w_p=spec, scale=(None, spec[1]))
        if isinstance(leaf, QuantLinear):
            return QuantLinear(w_i8=spec, scale=(spec[1],))
        if isinstance(leaf, QuantEmbed):
            return QuantEmbed(w_i8=spec, scale=(spec[0],))
        if _is_spec(spec) or spec is None:
            return spec
        if isinstance(spec, dict):
            return {k: fix(v, leaf[k]) for k, v in spec.items()}
        return [fix(s, p) for s, p in zip(spec, leaf)]

    return fix(pspecs, params)


def kv_cache_pspecs(model_cfg: ModelConfig, int8: bool = False):
    """KVCache(k, v, lengths[, scales]): slots over dp, kv heads over tp."""
    from tts_inference_tpu_torch.models.llama import KVCache

    n = model_cfg.num_hidden_layers
    spec, sspec = ("dp", None, "tp", None), ("dp", None, "tp")
    return KVCache(k=[spec] * n, v=[spec] * n, lengths=("dp",),
                   k_scale=[sspec] * n if int8 else [],
                   v_scale=[sspec] * n if int8 else [])


def paged_kv_cache_pspecs(model_cfg: ModelConfig, int8: bool = False,
                          int4: bool = False):
    """PagedKVCache(k, v, block_table, lengths[, scales]): the block pool is
    shared by all slots (replicated over dp), kv heads (int4: head pairs)
    over tp; tables and lengths follow the slots."""
    from tts_inference_tpu_torch.models.llama import PagedKVCache

    n = model_cfg.num_hidden_layers
    spec = (None, "tp", None, None)
    sspec = (None, None, "tp", None) if int4 else (None, "tp", None)
    quant = int8 or int4
    return PagedKVCache(k=[spec] * n, v=[spec] * n,
                        block_table=("dp", None), lengths=("dp",),
                        k_scale=[sspec] * n if quant else [],
                        v_scale=[sspec] * n if quant else [])


def sampling_state_pspecs():
    """SamplingState(presence, seed, step, in_speech, frame_pos): rows over
    dp (the port's noise state is a seed and a step where JAX keeps a
    key)."""
    from tts_inference_tpu_torch.ops.sampling import SamplingState

    return SamplingState(presence=("dp", None), seed=("dp",), step=("dp",),
                         in_speech=("dp",), frame_pos=("dp",))


def sampling_params_pspecs():
    """SamplingParams: every field is a per-slot (B,) tensor → dp rows."""
    from tts_inference_tpu_torch.ops.sampling import SamplingParams

    return SamplingParams(*[("dp",)] * len(SamplingParams._fields))


def batch_pspec() -> Spec:
    return ("dp", None)


# -- cutting ----------------------------------------------------------------


def _cut(t: torch.Tensor, spec: Spec, mesh: Mesh,
         vocab: Optional[VocabShards]) -> torch.Tensor:
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        if ax == "tp_vocab":
            vs = vocab or vocab_shards(t.shape[dim], mesh.tp)
            t = vs.cut(t, dim, mesh.tp_rank)
            continue
        n, i = (mesh.tp, mesh.tp_rank) if ax == "tp" else (mesh.dp,
                                                           mesh.dp_rank)
        size = t.shape[dim]
        if size % n:
            raise ValueError(f"shard_tree: dim {dim} of {tuple(t.shape)} "
                             f"not divisible by {ax}={n}")
        t = t.narrow(dim, i * (size // n), size // n)
    return t.contiguous()


def _cut_i4(w: QuantLinearI4, spec: Spec, mesh: Mesh) -> QuantLinearI4:
    """A tp shard of the logical (K, N) int4 matrix: columns keep the
    packing (their packed width padded to 128 again); rows are unpacked,
    cut and packed anew over the shard's own K, at the group
    ``shard_group`` gives, each scale row the scale of its rows' group."""
    n = w.scale.shape[1]
    k = w.w_p.shape[0] * 2
    g = k // w.scale.shape[0]
    i, tp = mesh.tp_rank, mesh.tp
    if spec[1] == "tp":
        c = n // tp
        cols = w.w_p[:, i * c:(i + 1) * c]
        pad = -(-c // 128) * 128 - c
        if pad:
            cols = torch.cat([cols, cols.new_zeros((cols.shape[0], pad))], 1)
        return QuantLinearI4(cols.contiguous(),
                             w.scale[:, i * c:(i + 1) * c].contiguous())
    if spec[0] == "tp":
        kl = k // tp
        if kl % 2:
            raise ValueError(f"int4 row shard: K/tp = {kl} is odd")
        gs = shard_group(k, g, tp)
        q = unpack_int4(w.w_p)[i * kl:(i + 1) * kl]
        rows = torch.arange(i * kl, (i + 1) * kl, gs,
                            device=w.scale.device) // g
        return QuantLinearI4(pack_int4(q), w.scale[rows].contiguous())
    return w


def shard_tree(tree, pspec_tree, mesh: Mesh, vocab: Optional[VocabShards]
               = None):
    """This rank's shard of `tree`: each tensor is cut to its block along
    its spec's axes where it lies, and the block moved to ``mesh.device``.
    Leaves whose spec is None pass through unchanged; a spec of () keeps
    the whole tensor (replicated). `vocab`: the partition of "tp_vocab"
    axes (default: that of the axis's own length)."""
    def walk(x, s):
        if s is None or x is None:
            return x
        if isinstance(x, QuantLinearI4) and isinstance(s, QuantLinearI4):
            w = _cut_i4(x, s.w_p, mesh)
            return QuantLinearI4(w.w_p.to(mesh.device),
                                 w.scale.to(mesh.device))
        if isinstance(x, torch.Tensor):
            return _cut(x, s, mesh, vocab).to(mesh.device)
        if hasattr(x, "_fields"):
            return type(x)(*[walk(a, b) for a, b in zip(x, s)])
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{
                f.name: walk(getattr(x, f.name), getattr(s, f.name))
                for f in dataclasses.fields(x)})
        if isinstance(x, dict):
            return {k: walk(v, s[k]) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(a, b) for a, b in zip(x, s))
        return x

    return walk(tree, pspec_tree)


# -- gathering --------------------------------------------------------------


def _uncut(t: torch.Tensor, spec: Spec, mesh: Mesh,
           vocab: Optional[VocabShards]) -> torch.Tensor:
    from tts_inference_tpu_torch.parallel import collectives as C

    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        g = C.all_gather_tp(t, mesh)
        if ax == "tp_vocab":
            if vocab is None:
                raise ValueError("gather_tree: a tp_vocab axis needs the "
                                 "partition (vocab=)")
            t = vocab.uncut(g, dim)
        else:
            t = torch.cat(list(g.unbind(0)), dim=dim)
    return t.contiguous()


def _uncut_i4(w: QuantLinearI4, spec: Spec, mesh: Mesh,
              group: Optional[int]) -> QuantLinearI4:
    """The whole int4 matrix of a tp shard; a row shard's scales at
    pick_group(K, group) (default: the shard's own group)."""
    from tts_inference_tpu_torch.ops.int4_matmul import pick_group
    from tts_inference_tpu_torch.parallel import collectives as C

    n = w.scale.shape[1]
    if spec[1] == "tp":
        # the padding columns as quantize_linear_i4 packs them (zeros)
        q = C.all_gather_tp(unpack_int4(w.w_p)[:, :n].contiguous(), mesh)
        q = torch.cat(list(q.unbind(0)), dim=1)
        q = torch.nn.functional.pad(q, (0, -(-q.shape[1] // 128) * 128
                                        - q.shape[1]))
        scale = torch.cat(list(C.all_gather_tp(w.scale, mesh).unbind(0)), 1)
        return QuantLinearI4(pack_int4(q), scale.contiguous())
    if spec[0] == "tp":
        q = C.all_gather_tp(unpack_int4(w.w_p), mesh)
        q = torch.cat(list(q.unbind(0)), dim=0)
        k = q.shape[0]
        scale = torch.cat(list(C.all_gather_tp(w.scale, mesh).unbind(0)), 0)
        gs = k // scale.shape[0]
        g = pick_group(k, group) if group else gs
        if g % gs:
            raise ValueError(f"gather_tree: group {g} is no multiple of the "
                             f"shards' group {gs}")
        return QuantLinearI4(pack_int4(q), scale[::g // gs].contiguous())
    return w


def gather_tree(tree, pspec_tree, mesh: Mesh,
                vocab: Optional[VocabShards] = None,
                i4_group: Optional[int] = None):
    """The inverse of ``shard_tree`` over tp axes (the weights' and the
    adapters'): every leaf whole again, on every rank (every rank of the
    mesh must call it). `vocab`: the partition of
    "tp_vocab" axes (needed when the tree has one); `i4_group`: an int4 row
    shard's scales go back at ``pick_group(K, i4_group)`` — the group its
    checkpoint was quantized with — instead of the shard's own."""
    def walk(x, s):
        if s is None or x is None:
            return x
        if isinstance(x, QuantLinearI4) and isinstance(s, QuantLinearI4):
            return _uncut_i4(x, s.w_p, mesh, i4_group)
        if isinstance(x, torch.Tensor):
            return _uncut(x, s, mesh, vocab)
        if hasattr(x, "_fields"):
            return type(x)(*[walk(a, b) for a, b in zip(x, s)])
        if isinstance(x, dict):
            return {k: walk(v, s[k]) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(a, b) for a, b in zip(x, s))
        return x

    return walk(tree, pspec_tree)
