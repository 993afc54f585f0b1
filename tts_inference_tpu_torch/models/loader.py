"""Checkpoint import: released PyTorch/HF weights → the port's tensor trees.

Port of ``tts_inference_tpu/models/loader.py`` with torch, numpy and the
standard library only: HF safetensors are read by ``utils/safetensors_io``
(views of a file mapping), SNAC state dicts by ``torch.load(...,
weights_only=True)``. The leaves take the port's own layouts
(``weights.py``): linears (in, out), contiguous, as ``init_llama_params``
lays them out; SNAC convolutions in torch's layout, so the state dict's own
tensors are used with no transpose.

Weight norm is folded, and LoRA adapters merged, in numpy float32 with the
JAX package's own expressions, so that both packages load the same bits.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from tts_inference_tpu_torch.config import ModelConfig, SnacConfig
from tts_inference_tpu_torch.models.llama import param_dtype
from tts_inference_tpu_torch.utils import safetensors_io


def _np(x) -> np.ndarray:
    """A state-dict tensor → float32 numpy, as the JAX package's ``_np``
    treats torch tensors."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x)


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# ---------------------------------------------------------------------------
# Weight norm folding
# ---------------------------------------------------------------------------


def fold_weight_norm(sd: Mapping[str, Any], prefix: str) -> np.ndarray:
    """Fold torch weight_norm params into a plain weight (float32 numpy).

    Handles old-style (`weight_g`/`weight_v`) and parametrize-style
    (`parametrizations.weight.original0/1`) checkpoints, plus an already
    plain `weight`. The norm is over all dims but 0 (torch's default)."""
    if f"{prefix}.weight" in sd:
        return _np(sd[f"{prefix}.weight"])
    if f"{prefix}.weight_v" in sd:
        g = _np(sd[f"{prefix}.weight_g"])
        v = _np(sd[f"{prefix}.weight_v"])
    elif f"{prefix}.parametrizations.weight.original0" in sd:
        g = _np(sd[f"{prefix}.parametrizations.weight.original0"])
        v = _np(sd[f"{prefix}.parametrizations.weight.original1"])
    else:
        raise KeyError(f"no weight found under {prefix}")
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt((v * v).sum(axis=axes, keepdims=True))
    return (g / np.maximum(norm, 1e-12)) * v


def _has_weight(sd: Mapping[str, Any], prefix: str) -> bool:
    return any(f"{prefix}.{k}" in sd for k in (
        "weight", "weight_v", "parametrizations.weight.original0"))


# ---------------------------------------------------------------------------
# SNAC decoder import
# ---------------------------------------------------------------------------


def load_snac_torch_state(sd: Mapping[str, Any], cfg: SnacConfig,
                          device="cpu") -> Dict:
    """Official snac-package state dict → the port's vocoder tree (f32).

    Decoder Sequential layout (snac/layers.py, depthwise variant):
      model.0 dw-conv7, model.1 pw-conv1, model.2..  DecoderBlock × len(rates),
      then Snake, out conv7, Tanh. DecoderBlock.block: 0 Snake, 1 ConvT,
      2 NoiseBlock(linear)/Identity, 3..5 ResidualUnit(block: Snake, conv7,
      Snake, conv1).
    Convolution weights keep torch's layout: (out, in/g, k), and (in, out, k)
    for the transposed ones.
    """

    def w(prefix):
        return _t(fold_weight_norm(sd, prefix), device)

    def b(prefix):
        key = f"{prefix}.bias"
        return _t(_np(sd[key]), device) if key in sd else None

    def alpha(prefix):  # Snake1d alpha (1, dim, 1) → (dim,)
        return _t(_np(sd[f"{prefix}.alpha"]).reshape(-1), device)

    def conv(prefix):
        return {"w": w(prefix), "b": b(prefix)}

    quant = []
    for i in range(len(cfg.vq_strides)):
        q = f"quantizer.quantizers.{i}"
        quant.append({"codebook": _t(_np(sd[f"{q}.codebook.weight"]), device),
                      "out_proj": conv(f"{q}.out_proj")})

    base = "decoder.model"
    if cfg.depthwise:
        in_conv = {"dw": conv(f"{base}.0"), "pw": conv(f"{base}.1")}
        block0 = 2
    else:
        in_conv = {"conv": conv(f"{base}.0")}
        block0 = 1

    blocks = []
    for i in range(len(cfg.decoder_rates)):
        blk = f"{base}.{block0 + i}.block"
        noise_lin = ({"w": w(f"{blk}.2.linear")}
                     if _has_weight(sd, f"{blk}.2.linear") else None)
        res = []
        for j in (3, 4, 5):
            r = f"{blk}.{j}.block"
            res.append({"alpha1": alpha(f"{r}.0"), "conv1": conv(f"{r}.1"),
                        "alpha2": alpha(f"{r}.2"), "conv2": conv(f"{r}.3")})
        blocks.append({"alpha": alpha(f"{blk}.0"), "up": conv(f"{blk}.1"),
                       "noise_lin": noise_lin, "res": res})

    n_out = block0 + len(cfg.decoder_rates)
    return {
        "quantizer": quant,
        "decoder": {
            "in": in_conv,
            "blocks": blocks,
            "out_alpha": alpha(f"{base}.{n_out}"),
            "out_conv": conv(f"{base}.{n_out + 1}"),
        },
    }


def load_snac_checkpoint(path: str, cfg: Optional[SnacConfig] = None,
                         device="cpu") -> Tuple[Dict, SnacConfig]:
    """Load a SNAC dir (config.json + pytorch_model.bin / model.pt /
    snac.pt). Without `cfg`, its config.json decides."""
    cfg_path = os.path.join(path, "config.json")
    if cfg is None and os.path.exists(cfg_path):
        with open(cfg_path) as f:
            d = json.load(f)
        enc_dim = d.get("encoder_dim", 48)
        enc_rates = d.get("encoder_rates", [2, 4, 8, 8])
        cfg = SnacConfig(
            sampling_rate=d.get("sampling_rate", 24000),
            latent_dim=d.get("latent_dim") or enc_dim * (2 ** len(enc_rates)),
            decoder_dim=d.get("decoder_dim", 1024),
            decoder_rates=tuple(d.get("decoder_rates", [8, 8, 4, 2])),
            codebook_size=d.get("codebook_size", 4096),
            codebook_dim=d.get("codebook_dim", 8),
            vq_strides=tuple(d.get("vq_strides", [4, 2, 1])),
            noise=d.get("noise", True),
            depthwise=d.get("depthwise", True),
        )
    cfg = cfg or SnacConfig()
    for name in ("pytorch_model.bin", "model.pt", "snac.pt"):
        p = os.path.join(path, name)
        if os.path.exists(p):
            sd = torch.load(p, map_location="cpu", weights_only=True)
            break
    else:
        raise FileNotFoundError(f"no SNAC weights found under {path}")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return load_snac_torch_state(sd, cfg, device), cfg


# ---------------------------------------------------------------------------
# Llama / Orpheus import (HF safetensors) + LoRA weight-space merge
# ---------------------------------------------------------------------------


def llama_params_from_hf_state(sd: Mapping[str, torch.Tensor],
                               cfg: ModelConfig,
                               dtype: Optional[torch.dtype] = None,
                               device="cpu") -> Dict:
    """HF LlamaForCausalLM state dict → the port's decoder tree.

    HF stores linears (out, in); the port keeps (in, out), contiguous, so
    the matmuls are plain ``x @ w`` with the strides ``init_llama_params``
    gives. Each tensor goes to `device` and is cast and transposed there,
    one at a time. When `dtype` is None the config's own dtype decides (HF
    convention: config.json ``torch_dtype`` / ``dtype`` describes the stored
    weights). ``lm_head`` only for an untied config that has one; without
    it the logits use the embedding, as in the JAX package."""
    if dtype is None:
        dtype = param_dtype(cfg)

    def V(key):  # vector / embedding kept as is
        return sd[key].to(device).to(dtype).contiguous()

    def W(key):  # linear weight (out, in) → (in, out)
        return V(key).t().contiguous()

    p = {
        "embed": V("model.embed_tokens.weight"),
        "final_norm": V("model.norm.weight"),
        "layers": [],
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        p["lm_head"] = W("lm_head.weight")
    for i in range(cfg.num_hidden_layers):
        b = f"model.layers.{i}"
        p["layers"].append({
            "input_norm": V(f"{b}.input_layernorm.weight"),
            "post_attn_norm": V(f"{b}.post_attention_layernorm.weight"),
            "wq": W(f"{b}.self_attn.q_proj.weight"),
            "wk": W(f"{b}.self_attn.k_proj.weight"),
            "wv": W(f"{b}.self_attn.v_proj.weight"),
            "wo": W(f"{b}.self_attn.o_proj.weight"),
            "w_gate": W(f"{b}.mlp.gate_proj.weight"),
            "w_up": W(f"{b}.mlp.up_proj.weight"),
            "w_down": W(f"{b}.mlp.down_proj.weight"),
        })
    return p


_LORA_RE = re.compile(
    r"base_model\.model\.(.+)\.lora_(A|B)\.(?:default\.)?weight"
)


def _merge_np(x) -> np.ndarray:
    """A weight as the JAX package's merge sees it: numpy of its own dtype,
    bf16 as float32 (numpy promotes bf16 to float32 in every operation of
    the merge, so converting first gives the same bits)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def merge_lora_state(sd: Mapping[str, Any], lora_sd: Mapping[str, Any], *,
                     scale: Optional[float] = None, alpha: float = 32.0,
                     r: Optional[int] = None) -> Dict[str, Any]:
    """Weight-space LoRA merge: W' = W + (alpha/r)·B@A, in numpy.

    The analog of the reference's merge_and_unload() flow. Returns a new
    dict; a merged weight is a torch tensor of the merge's numpy result
    (float32 for bf16 or float32 weights), every other entry is `sd`'s own.
    A target with only A or only B, or absent from `sd`, is left alone."""
    pairs: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in lora_sd.items():
        m = _LORA_RE.match(k)
        if not m:
            continue
        pairs.setdefault(m.group(1), {})[m.group(2)] = _merge_np(v)
    merged = dict(sd)
    for target, ab in pairs.items():
        if "A" not in ab or "B" not in ab:
            continue
        key = f"{target}.weight"
        if key not in merged:
            continue
        A, B = ab["A"], ab["B"]
        rank = r or A.shape[0]
        s = scale if scale is not None else alpha / rank
        merged[key] = torch.from_numpy(_merge_np(merged[key]) + s * (B @ A))
    return merged


def read_adapter_config(lora_path: str) -> dict:
    """PEFT's adapter_config.json if present (lora_alpha, r, use_rslora);
    {} when absent."""
    f = os.path.join(lora_path, "adapter_config.json")
    if not os.path.exists(f):
        return {}
    with open(f) as fh:
        return json.load(fh)


def load_llama_checkpoint(path: str, cfg: Optional[ModelConfig] = None, *,
                          lora_path: Optional[str] = None,
                          dtype: Optional[torch.dtype] = None,
                          device="cpu") -> Tuple[Dict, ModelConfig]:
    """Load an HF Llama/Orpheus dir (optionally merging a LoRA adapter)
    onto `device`. Without `cfg`, its config.json decides."""
    if cfg is None:
        with open(os.path.join(path, "config.json")) as f:
            cfg = ModelConfig.from_hf_dict(json.load(f))
    sd = safetensors_io.read_dir(path)
    if lora_path is not None:
        acfg = read_adapter_config(lora_path)
        alpha = float(acfg.get("lora_alpha", 32.0))
        r = acfg.get("r")
        # rsLoRA scales by alpha / sqrt(r) in place of alpha / r
        scale = None
        if acfg.get("use_rslora") and r:
            scale = alpha / float(r) ** 0.5
        sd = merge_lora_state(sd, safetensors_io.read_dir(lora_path),
                              scale=scale, alpha=alpha, r=r)
    return llama_params_from_hf_state(sd, cfg, dtype=dtype,
                                      device=device), cfg
