"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Weights are made with numpy from a seed, in the JAX package's pytree
structure (``init_llama_params`` / ``init_snac_params``); the JAX side gets
them as jnp arrays and the port imports the same numpy arrays through
``tts_inference_tpu_torch.weights``.
"""

from __future__ import annotations

import math

import numpy as np

from tts_inference_tpu import protocol as P
from tts_inference_tpu.config import ModelConfig, SnacConfig

AUDIO_RANGE = (P.TOKEN_AUDIO_BASE, P.TOKEN_AUDIO_BASE + P.AUDIO_VOCAB)


def numpy_llama_tree(cfg: ModelConfig, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    h, ffn = cfg.hidden_size, cfg.intermediate_size
    hd, nq, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads

    def dense(shape):
        return (rng.standard_normal(shape) / math.sqrt(shape[0])).astype(
            np.float32)

    def norm():
        return (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)

    layers = [{
        "input_norm": norm(), "post_attn_norm": norm(),
        "wq": dense((h, nq * hd)), "wk": dense((h, nkv * hd)),
        "wv": dense((h, nkv * hd)), "wo": dense((nq * hd, h)),
        "w_gate": dense((h, ffn)), "w_up": dense((h, ffn)),
        "w_down": dense((ffn, h)),
    } for _ in range(cfg.num_hidden_layers)]
    return {
        "embed": (0.02 * rng.standard_normal((cfg.vocab_size, h))).astype(
            np.float32),
        "final_norm": norm(),
        "layers": layers,
    }


def numpy_snac_tree(cfg: SnacConfig, seed: int = 1) -> dict:
    """JAX-layout SNAC tree: conv (K, Cin/g, Cout), transposed conv
    (K, Cin, Cout); alphas around 1 so snake is exercised."""
    rng = np.random.default_rng(seed)

    def w(shape):
        s = 1.0 / math.sqrt(max(int(np.prod(shape[:-1])), 1))
        return rng.uniform(-s, s, shape).astype(np.float32)

    def b(n):
        return (0.05 * rng.standard_normal(n)).astype(np.float32)

    def alpha(n):
        return rng.uniform(0.5, 1.5, n).astype(np.float32)

    quant = [{
        "codebook": rng.standard_normal(
            (cfg.codebook_size, cfg.codebook_dim)).astype(np.float32),
        "out_proj": {"w": w((1, cfg.codebook_dim, cfg.latent_dim)),
                     "b": b(cfg.latent_dim)},
    } for _ in cfg.vq_strides]
    ch = cfg.decoder_dim
    blocks = []
    dim = ch
    for i, rate in enumerate(cfg.decoder_rates):
        cin, cout = ch // 2 ** i, ch // 2 ** (i + 1)
        blocks.append({
            "alpha": alpha(cin),
            "up": {"w": w((2 * rate, cin, cout)), "b": b(cout)},
            "noise_lin": {"w": w((1, cout, cout))},
            "res": [{
                "alpha1": alpha(cout),
                "conv1": {"w": w((7, 1, cout)), "b": b(cout)},
                "alpha2": alpha(cout),
                "conv2": {"w": w((1, cout, cout)), "b": b(cout)},
            } for _ in (1, 3, 9)],
        })
        dim = cout
    return {
        "quantizer": quant,
        "decoder": {
            "in": {"dw": {"w": w((7, 1, cfg.latent_dim)),
                          "b": b(cfg.latent_dim)},
                   "pw": {"w": w((1, cfg.latent_dim, ch)), "b": b(ch)}},
            "blocks": blocks,
            "out_alpha": alpha(dim),
            "out_conv": {"w": w((7, dim, 1)), "b": b(1)},
        },
    }


def to_jax(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(jnp.asarray, tree)


def random_codes(rng, cfg: SnacConfig, n_frames: int, batch: int = 1):
    """Three code layers (B, n), (B, 2n), (B, 4n) for a tiny codebook."""
    return [rng.integers(0, cfg.codebook_size, (batch, m * n_frames)).astype(
        np.int32) for m in (1, 2, 4)]


def interleaved_codes(rng, cfg: SnacConfig, n_frames: int):
    """Flat 7-per-frame codes with the per-position offsets applied."""
    return [int(rng.integers(0, cfg.codebook_size)) + P.POSITION_OFFSETS[p]
            for _ in range(n_frames) for p in range(P.FRAME_SIZE)]


def port_config(jax_cfg):
    """The port's copy of a JAX-package config dataclass (Config or one of
    its sections), built field by field, so the port never receives an
    object of the JAX package."""
    import dataclasses

    from tts_inference_tpu_torch import config as tcfg

    cls = getattr(tcfg, type(jax_cfg).__name__)
    fields = {}
    for f in dataclasses.fields(jax_cfg):
        v = getattr(jax_cfg, f.name)
        fields[f.name] = port_config(v) if dataclasses.is_dataclass(v) else v
    return cls(**fields)


def for_side(mod, cfg):
    """`cfg` as the package that module `mod` belongs to takes it: a module
    of the port gets the port's own copy, the JAX package its original."""
    if mod.__name__.startswith("tts_inference_tpu_torch"):
        return port_config(cfg)
    return cfg
