"""LoRA adapters: init and weight-space merge.

Port of ``tts_inference_tpu/training/lora.py``. The reference's training
loop (`pretrained_base/modal_finetune_base.py`: 4-bit base + LoRA r=16 α=32
on 7 projection modules; merge via `merge_and_unload()` in
`modal_merge_base.py:28-65`) as plain functions: adapters are a parallel
tree of tensors in the JAX package's (in, out) layout; training
differentiates only the adapter leaves, through ``merge_params``; serving
merges in weight space (``models/loader.merge_lora_state`` for HF
checkpoints, ``merge_params`` here for in-framework trees).

``lora_pspecs`` (the adapters' sharding specs) belongs to sharded
training and is not ported yet (ROADMAP.md Queue 1 item 7).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from tts_inference_tpu_torch.config import ModelConfig

# the reference's 7 target modules (modal_finetune_base.py:108-116)
DEFAULT_TARGETS = (
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
)


def init_lora(
    gen: torch.Generator,
    model_cfg: ModelConfig,
    params: Dict,
    *,
    r: int = 16,
    alpha: float = 32.0,
    targets: Sequence[str] = DEFAULT_TARGETS,
) -> Dict:
    """A/B pairs per target per layer, on each weight's device and in its
    dtype: A ~ N(0, 1)/√r drawn in f32 from `gen` (a generator on the
    weights' device), B = 0 (the merged delta starts at zero). The scale
    α/r is ``lora_scale``'s: the tree holds only tensors."""
    layers: List[Dict] = []
    for lp in params["layers"]:
        entry = {}
        for t in targets:
            w = lp[t]
            fan_in, fan_out = w.shape
            a = torch.randn((fan_in, r), generator=gen, device=w.device,
                            dtype=torch.float32) / math.sqrt(r)
            entry[t] = {
                "A": a.to(w.dtype),
                "B": torch.zeros((r, fan_out), dtype=w.dtype,
                                 device=w.device),
            }
        layers.append(entry)
    return {"layers": layers}


def lora_scale(r: int, alpha: float) -> float:
    return float(alpha) / float(r)


def merge_params(params: Dict, lora: Dict, scale: float) -> Dict:
    """Weight-space merge: W' = (W + (α/r)·A@B) in f32, rounded to W's
    dtype (the merge_and_unload analog). Differentiable in A and B: the
    train step runs its forward on this tree. Returns a new params tree;
    the base is untouched."""
    merged_layers = []
    for lp, le in zip(params["layers"], lora["layers"]):
        nlp = dict(lp)
        for t, ab in le.items():
            delta = ab["A"].float() @ ab["B"].float()
            nlp[t] = (lp[t].float() + scale * delta).to(lp[t].dtype)
        merged_layers.append(nlp)
    out = dict(params)
    out["layers"] = merged_layers
    return out
