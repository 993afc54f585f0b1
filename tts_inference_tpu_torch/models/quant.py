"""Weight-only quantization for the decode path: int8, and int4 per group.

Port of ``tts_inference_tpu/models/quant.py``, with its checkpoint codec
(``to_plain`` / ``from_plain``, for ``cli quantize``). A decode step reads every weight once, so fewer bits per weight
are fewer bytes per step. Leaves become ``QuantLinear`` / ``QuantEmbed`` /
``QuantLinearI4`` tuples of tensors with the JAX package's field names and
layouts; ``mm`` / ``embed_rows`` / ``tied_logits`` / ``head_logits`` dispatch
on the leaf type, so quantized and full-precision parameters flow through
the same model code. The quantized products are the hand-written kernels of
``ops/int4_matmul.py`` (K4 for int4, K2 for int8): no dequantized copy of a
weight is ever written.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional

import torch

from tts_inference_tpu_torch.ops.int4_matmul import (GROUP as I4_GROUP,
                                                     int4_mm, pack_int4,
                                                     pick_group, w8_mm)


class QuantLinear(NamedTuple):
    """(in, out) weight as int8 + per-out-channel f32 scale."""

    w_i8: torch.Tensor     # (in, out) int8
    scale: torch.Tensor    # (out,) float32


class QuantEmbed(NamedTuple):
    """(V, H) embedding as int8 + per-row f32 scale (also the tied head)."""

    w_i8: torch.Tensor     # (V, H) int8
    scale: torch.Tensor    # (V,) float32


class QuantLinearI4(NamedTuple):
    """(in, out) weight as packed int4 + per-(group, out-channel) scales.

    Two int4 values per int8 byte, global split-half packed along `in`
    (``ops/int4_matmul.py`` has the layout). The out dimension of ``w_p`` is
    padded to a multiple of 128, as the JAX package stores it;
    ``scale.shape[1]`` is the true out width and ``in // scale.shape[0]``
    the group size — both recoverable from the shapes alone.
    """

    w_p: torch.Tensor      # (in//2, out_padded) int8
    scale: torch.Tensor    # (in//group, out) float32


def quantize_linear(w: torch.Tensor) -> QuantLinear:
    """Per-out-channel symmetric int8: scale = absmax / 127, round half to
    even (as jnp.round)."""
    wf = w.float()
    scale = (wf.abs().amax(dim=0) / 127.0).clamp(min=1e-8)
    q = torch.round(wf / scale[None, :]).clamp(-127, 127).to(torch.int8)
    return QuantLinear(q, scale)


def quantize_embed(w: torch.Tensor) -> QuantEmbed:
    """Per-row symmetric int8."""
    wf = w.float()
    scale = (wf.abs().amax(dim=1) / 127.0).clamp(min=1e-8)
    q = torch.round(wf / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return QuantEmbed(q, scale)


def _i4_group() -> int:
    """The int4 group size: ``TTS_INT4_GROUP`` read at call time, as the JAX
    package reads it, else 512."""
    return int(os.environ.get("TTS_INT4_GROUP", str(I4_GROUP)))


def quantize_linear_i4(w: torch.Tensor,
                       group: int = I4_GROUP) -> QuantLinearI4:
    """Per-group symmetric int4: scale = group absmax / 7, q in [-7, 7].

    The group shrinks so that it tiles each packed half of K (small `in`
    dimensions — the tiny test config); out dimensions are zero-padded to a
    multiple of 128 in the packed array only.
    """
    k, n = w.shape
    group = pick_group(k, group)
    wf = w.float().reshape(k // group, group, n)
    scale = (wf.abs().amax(dim=1) / 7.0).clamp(min=1e-8)       # (K/G, N)
    q = torch.round(wf / scale[:, None, :]).clamp(-7, 7)
    q = q.reshape(k, n).to(torch.int32)
    n_pad = -(-n // 128) * 128
    if n_pad != n:
        q = torch.nn.functional.pad(q, (0, n_pad - n))
    return QuantLinearI4(pack_int4(q), scale)


_LINEAR_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_llama_params(params: Dict, *, quantize_embed_table: bool = True,
                          bits: int = 8, group: Optional[int] = None,
                          free_source: bool = False) -> Dict:
    """Full params tree → quantized tree (norms stay in full precision).

    bits=8: per-out-channel int8 everywhere. bits=4: per-group int4 for the
    per-layer linears — the bulk of a decode step's weight bytes — while the
    embedding and the tied head stay int8: logit quality gates token
    selection directly, and the sliced-head decode already reads only the
    audio-vocab rows.

    Done layer by layer. With ``free_source`` each full-precision weight is
    removed from `params` as soon as it is quantized, so the peak holds one
    extra weight, not two models; `params` is unusable afterwards.
    """
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")

    def take(d, k):
        return d.pop(k) if free_source else d[k]

    def qlin(w):
        if bits == 4:
            return quantize_linear_i4(w, group or _i4_group())
        return quantize_linear(w)

    layers = []
    for lp in params["layers"]:
        nlp = dict(lp)
        for k in _LINEAR_KEYS:
            nlp[k] = qlin(take(lp, k))
        layers.append(nlp)
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = layers
    if quantize_embed_table:
        out["embed"] = quantize_embed(take(params, "embed"))
    if "lm_head" in params:
        out["lm_head"] = quantize_linear(take(params, "lm_head"))
    return out


def i4_group_of(params: Dict) -> Optional[int]:
    """The group an int4 tree was quantized with: the largest of its
    leaves' (each leaf's is ``pick_group(K, group)``); None without int4
    leaves."""
    groups = [w.w_p.shape[0] * 2 // w.scale.shape[0]
              for lp in params["layers"] for w in lp.values()
              if isinstance(w, QuantLinearI4)]
    return max(groups, default=None)


def out_features(w) -> int:
    """The out width of a plain, QuantLinear or QuantLinearI4 weight (an
    int4 weight's packed width may be padded)."""
    if isinstance(w, QuantLinearI4):
        return w.scale.shape[1]
    if isinstance(w, QuantLinear):
        return w.w_i8.shape[1]
    return w.shape[1]


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for plain, QuantLinear (K2) or QuantLinearI4 (K4) weights, w in
    the JAX package's (in, out) layout."""
    if isinstance(w, QuantLinearI4):
        return int4_mm(x, w.w_p, w.scale)
    if isinstance(w, QuantLinear):
        return w8_mm(x, w.w_i8, w.scale)
    return x @ w


def embed_rows(emb, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Embedding gather for plain or QuantEmbed tables."""
    idx = tokens.long()
    if isinstance(emb, QuantEmbed):
        return (emb.w_i8[idx].float() * emb.scale[idx][..., None]).to(dtype)
    return emb[idx].to(dtype)


class _MmF32(torch.autograd.Function):
    """``torch.mm(a, b, out_dtype=float32)`` with a derivative, which
    ``aten::mm.dtype`` lacks: the backward's two products run in f32 and
    round to each input's dtype, as the CPU branch's ``a.float() @
    b.float()`` differentiates. The train step reaches it through the tied
    head."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = (g @ b.float().t()).to(a.dtype) if ctx.needs_input_grad[0] \
            else None
        gb = (a.float().t() @ g).to(b.dtype) if ctx.needs_input_grad[1] \
            else None
        return ga, gb


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (…, K) @ b (K, N) with f32 accumulation AND an f32 result, like
    JAX's ``preferred_element_type=float32`` (a bf16 result would round the
    logits the sampler sees)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    if a.is_cuda and torch.is_grad_enabled() and (a2.requires_grad
                                                  or b.requires_grad):
        out = _MmF32.apply(a2, b)
    elif a.is_cuda:
        out = torch.mm(a2, b, out_dtype=torch.float32)
    else:
        out = a2.float() @ b.float()
    return out.reshape(*lead, b.shape[-1])


def tied_logits(hidden: torch.Tensor, emb, base: int = 0) -> torch.Tensor:
    """hidden (…, H) × embedding (V, H)ᵀ → f32 logits (…, V - base).

    ``base`` drops the head's first rows (the sliced-head decode path,
    protocol.HEAD_SLICE_BASE): the slice is a view, the skipped rows are
    never read — K2 reads the int8 rows in place too."""
    if isinstance(emb, QuantEmbed):
        return w8_mm(hidden, emb.w_i8[base:], emb.scale[base:], rows=True,
                     out_dtype=torch.float32)
    return _dot_f32(hidden, emb[base:].t())


def head_logits(hidden: torch.Tensor, w, base: int = 0) -> torch.Tensor:
    if isinstance(w, QuantLinear):
        return w8_mm(hidden, w.w_i8[:, base:], w.scale[base:],
                     out_dtype=torch.float32)
    return _dot_f32(hidden, w[:, base:])


# -- offline-quantized checkpoint codec ---------------------------------------
# The quantized leaves are NamedTuples; to_plain / from_plain round-trip them
# through marker-keyed dicts (every leaf stays a tensor), so `cli quantize`
# can save a pre-quantized checkpoint once and a boot from it skips the
# quantization (the JAX package's marker keys).

_QKINDS = {
    "__q_linear_i8__": QuantLinear,
    "__q_embed_i8__": QuantEmbed,
    "__q_linear_i4__": QuantLinearI4,
}
_QMARKERS = {v: k for k, v in _QKINDS.items()}


def to_plain(tree):
    """Quantized params tree → plain dict/list tree."""
    t = type(tree)
    if t in _QMARKERS:
        return {_QMARKERS[t]: dict(tree._asdict())}
    if isinstance(tree, dict):
        return {k: to_plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_plain(v) for v in tree]
    return tree


def from_plain(tree):
    """Inverse of to_plain: rebuild the quantized NamedTuples."""
    if isinstance(tree, dict):
        if len(tree) == 1:
            key = next(iter(tree))
            if key in _QKINDS:
                fields = tree[key]
                cls = _QKINDS[key]
                return cls(**{f: fields[f] for f in cls._fields})
        return {k: from_plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_plain(v) for v in tree]
    return tree
