"""Weight access for the decode path: plain (unquantized) weights only.

Port of the plain-weight half of ``tts_inference_tpu/models/quant.py``
(``mm``, ``embed_rows``, ``tied_logits``, ``head_logits``). The int8
``QuantLinear``/``QuantEmbed`` leaves and their hand-written W8A16 kernel
are the next item of the port (ROADMAP.md); the port's CLI rejects
``--quantize`` until then.
"""

from __future__ import annotations

import torch


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with w in the JAX package's (in, out) layout."""
    return x @ w


def embed_rows(emb: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Embedding gather."""
    return emb[tokens.long()].to(dtype)


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (…, K) @ b (K, N) with f32 accumulation AND an f32 result, like
    JAX's ``preferred_element_type=float32`` (a bf16 result would round the
    logits the sampler sees)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    if a.is_cuda:
        out = torch.mm(a2, b, out_dtype=torch.float32)
    else:
        out = a2.float() @ b.float()
    return out.reshape(*lead, b.shape[-1])


def tied_logits(hidden: torch.Tensor, emb: torch.Tensor,
                base: int = 0) -> torch.Tensor:
    """hidden (…, H) × embedding (V, H)ᵀ → f32 logits (…, V - base).

    ``base`` drops the head's first rows (the sliced-head decode path,
    protocol.HEAD_SLICE_BASE): the slice is a view, the skipped rows are
    never read."""
    return _dot_f32(hidden, emb[base:].t())


def head_logits(hidden: torch.Tensor, w: torch.Tensor,
                base: int = 0) -> torch.Tensor:
    return _dot_f32(hidden, w[:, base:])
