"""Parameters of the port: import from the JAX package's pytrees, and seeded
random init in torch.

Both produce the JAX package's tree structure (``init_llama_params`` /
``init_snac_params``), with torch tensors as leaves:

- linear weights keep JAX's (in, out) layout (``x @ w``);
- ``conv1d`` weights go from JAX's (K, Cin/g, Cout) to torch's
  (Cout, Cin/g, K);
- ``conv_transpose1d`` weights (the ``up`` convolutions) go from JAX's
  (K, Cin, Cout), stored unflipped, to torch's (Cin, Cout, K) — torch's
  ConvTranspose1d semantics are the ones the JAX weight already follows
  (tts_inference_tpu/models/snac.py:79-110).

The random init runs directly on the target device with a
``torch.Generator``: it draws torch's numbers, not jax.random's, so a test
that needs the same weights on both sides builds them once (numpy) and
imports them on each side.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from tts_inference_tpu_torch.config import ModelConfig, SnacConfig
from tts_inference_tpu_torch.models.quant import (QuantEmbed, QuantLinear,
                                                  QuantLinearI4)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def tensor_from_numpy(a, device="cpu", dtype=None) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16) → torch tensor on `device`."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


# -- llama ------------------------------------------------------------------


def _leaf_from_jax(leaf, device):
    """A plain array, or one of the JAX package's quantized leaves
    (QuantLinear / QuantEmbed / QuantLinearI4, recognised by their field
    names) carried across byte for byte."""
    fields = getattr(leaf, "_fields", None)
    if fields == ("w_p", "scale"):
        return QuantLinearI4(tensor_from_numpy(leaf.w_p, device),
                             tensor_from_numpy(leaf.scale, device))
    if fields == ("w_i8", "scale"):
        # the embedding's scale is per row, a linear's per column
        cls = QuantEmbed if type(leaf).__name__ == "QuantEmbed" \
            else QuantLinear
        return cls(tensor_from_numpy(leaf.w_i8, device),
                   tensor_from_numpy(leaf.scale, device))
    return tensor_from_numpy(leaf, device)


def llama_params_from_jax(tree: Dict, device="cpu") -> Dict:
    """JAX llama pytree (numpy leaves, quantized leaves included) → the
    port's tensor tree."""
    t = lambda a: _leaf_from_jax(a, device)  # noqa: E731
    out = {
        "embed": t(tree["embed"]),
        "final_norm": t(tree["final_norm"]),
        "layers": [{k: t(v) for k, v in lp.items()} for lp in tree["layers"]],
    }
    if "lm_head" in tree:
        out["lm_head"] = t(tree["lm_head"])
    return out


def lora_from_jax(tree: Dict, device="cpu") -> Dict:
    """The JAX package's LoRA adapter tree (``init_lora``'s structure,
    numpy leaves) → the port's, the same (in, r) / (r, out) layout."""
    return {"layers": [
        {t: {k: tensor_from_numpy(v, device) for k, v in ab.items()}
         for t, ab in le.items()}
        for le in tree["layers"]]}


def init_llama_params(cfg: ModelConfig, seed: int = 0,
                      device="cpu") -> Dict:
    """Seeded random weights with the structure of init_llama_params."""
    dt = _DTYPES[cfg.dtype]
    gen = torch.Generator(device=device).manual_seed(seed)
    h, ffn = cfg.hidden_size, cfg.intermediate_size
    hd, nq, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads

    def normal(shape, scale):
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (x * scale).to(dt)

    def dense(shape):
        return normal(shape, 1.0 / math.sqrt(shape[0]))

    layers = []
    for _ in range(cfg.num_hidden_layers):
        layers.append({
            "input_norm": torch.ones(h, dtype=dt, device=device),
            "post_attn_norm": torch.ones(h, dtype=dt, device=device),
            "wq": dense((h, nq * hd)),
            "wk": dense((h, nkv * hd)),
            "wv": dense((h, nkv * hd)),
            "wo": dense((nq * hd, h)),
            "w_gate": dense((h, ffn)),
            "w_up": dense((h, ffn)),
            "w_down": dense((ffn, h)),
        })
    p = {
        "embed": normal((cfg.vocab_size, h), 0.02),
        "final_norm": torch.ones(h, dtype=dt, device=device),
        "layers": layers,
    }
    if not cfg.tie_word_embeddings:
        p["lm_head"] = dense((h, cfg.vocab_size))
    return p


# -- snac -------------------------------------------------------------------


def _conv_to_torch(w: torch.Tensor) -> torch.Tensor:
    """conv1d (K, Cin/g, Cout) → (Cout, Cin/g, K)."""
    return w.permute(2, 1, 0).contiguous()


def _convt_to_torch(w: torch.Tensor) -> torch.Tensor:
    """conv_transpose1d (K, Cin, Cout), unflipped → (Cin, Cout, K)."""
    return w.permute(1, 2, 0).contiguous()


def _snac_layouts(tree: Any, key: str = "") -> Any:
    """Map a JAX-layout SNAC tree (tensor leaves) to torch conv layouts."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "w" and isinstance(v, torch.Tensor) and v.dim() == 3:
                out[k] = _convt_to_torch(v) if key == "up" \
                    else _conv_to_torch(v)
            else:
                out[k] = _snac_layouts(v, k)
        return out
    if isinstance(tree, (list, tuple)):
        return [_snac_layouts(v, key) for v in tree]
    return tree


def snac_params_from_jax(tree: Dict, device="cpu") -> Dict:
    """JAX SNAC pytree (numpy leaves) → the port's tensor tree (f32)."""

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        if x is None:
            return None
        return tensor_from_numpy(x, device, torch.float32)

    return _snac_layouts(conv(tree))


def init_snac_params(cfg: SnacConfig, seed: int = 0, device="cpu") -> Dict:
    """Seeded random weights with the structure of init_snac_params."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=device)

    def winit(shape):   # JAX layout; fan_in over all but the last axis
        scale = 1.0 / math.sqrt(max(int(np.prod(shape[:-1])), 1))
        return (torch.rand(shape, generator=gen, **f32) * 2 - 1) * scale

    quant = [{
        "codebook": torch.randn((cfg.codebook_size, cfg.codebook_dim),
                                generator=gen, **f32),
        "out_proj": {"w": winit((1, cfg.codebook_dim, cfg.latent_dim)),
                     "b": torch.zeros(cfg.latent_dim, **f32)},
    } for _ in cfg.vq_strides]

    ch = cfg.decoder_dim
    blocks = []
    dim = ch
    for i, rate in enumerate(cfg.decoder_rates):
        in_dim, out_dim = ch // (2 ** i), ch // (2 ** (i + 1))
        groups = out_dim if cfg.depthwise else 1
        res = [{
            "alpha1": torch.ones(out_dim, **f32),
            "conv1": {"w": winit((7, out_dim // groups, out_dim)),
                      "b": torch.zeros(out_dim, **f32)},
            "alpha2": torch.ones(out_dim, **f32),
            "conv2": {"w": winit((1, out_dim, out_dim)),
                      "b": torch.zeros(out_dim, **f32)},
        } for _ in (1, 3, 9)]
        blocks.append({
            "alpha": torch.ones(in_dim, **f32),
            "up": {"w": winit((2 * rate, in_dim, out_dim)),
                   "b": torch.zeros(out_dim, **f32)},
            "noise_lin": ({"w": winit((1, out_dim, out_dim))}
                          if cfg.noise else None),
            "res": res,
        })
        dim = out_dim
    if cfg.depthwise:
        in_conv = {
            "dw": {"w": winit((7, 1, cfg.latent_dim)),
                   "b": torch.zeros(cfg.latent_dim, **f32)},
            "pw": {"w": winit((1, cfg.latent_dim, ch)),
                   "b": torch.zeros(ch, **f32)},
        }
    else:
        in_conv = {"conv": {"w": winit((7, cfg.latent_dim, ch)),
                            "b": torch.zeros(ch, **f32)}}
    tree = {
        "quantizer": quant,
        "decoder": {
            "in": in_conv,
            "blocks": blocks,
            "out_alpha": torch.ones(dim, **f32),
            "out_conv": {"w": winit((7, dim, 1)),
                         "b": torch.zeros(1, **f32)},
        },
    }
    return _snac_layouts(tree)
