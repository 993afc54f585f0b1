"""LoRA adapters: init and weight-space merge.

Port of ``tts_inference_tpu/training/lora.py``. The reference's training
loop (`pretrained_base/modal_finetune_base.py`: 4-bit base + LoRA r=16 α=32
on 7 projection modules; merge via `merge_and_unload()` in
`modal_merge_base.py:28-65`) as plain functions: adapters are a parallel
tree of tensors in the JAX package's (in, out) layout; training
differentiates only the adapter leaves, through ``merge_params``; serving
merges in weight space (``models/loader.merge_lora_state`` for HF
checkpoints, ``merge_params`` here for in-framework trees).

Under a (dp, tp) mesh the adapters follow their base weight
(``lora_pspecs``): a column-parallel target's A is replicated and its B cut
on out, a row-parallel target's A cut on in and its B replicated, so
``merge_params`` stays local to each shard. ``init_lora(mesh=)`` draws the
adapters at the whole shapes, in the unsharded order, then cuts them: a
seed gives the same adapters as on one device.
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


def _whole_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """(in, out) of each target at the model's whole width."""
    h, hd = cfg.hidden_size, cfg.head_dim
    q, kv = cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd
    i = cfg.intermediate_size
    return {"wq": (h, q), "wk": (h, kv), "wv": (h, kv), "wo": (q, h),
            "w_gate": (h, i), "w_up": (h, i), "w_down": (i, h)}


def init_lora(
    gen: torch.Generator,
    model_cfg: ModelConfig,
    params: Dict,
    *,
    r: int = 16,
    alpha: float = 32.0,
    targets: Sequence[str] = DEFAULT_TARGETS,
    mesh=None,
) -> Dict:
    """A/B pairs per target per layer, on each weight's device and in its
    dtype: A ~ N(0, 1)/√r drawn in f32 from `gen` (a generator on the
    weights' device), B = 0 (the merged delta starts at zero). The scale
    α/r is ``lora_scale``'s: the tree holds only tensors. With `mesh`,
    `params` is a shard: the adapters are drawn at the model's whole
    shapes and cut to this rank's (``lora_pspecs``)."""
    shapes = _whole_shapes(model_cfg) if mesh is not None else None
    layers: List[Dict] = []
    for lp in params["layers"]:
        entry = {}
        for t in targets:
            w = lp[t]
            fan_in, fan_out = shapes[t] if shapes else w.shape
            a = torch.randn((fan_in, r), generator=gen, device=w.device,
                            dtype=torch.float32) / math.sqrt(r)
            entry[t] = {
                "A": a.to(w.dtype),
                "B": torch.zeros((r, fan_out), dtype=w.dtype,
                                 device=w.device),
            }
        layers.append(entry)
    lora = {"layers": layers}
    if mesh is None:
        return lora
    from tts_inference_tpu_torch.parallel.mesh import shard_tree

    return shard_tree(lora, lora_pspecs(model_cfg, lora), mesh)


def lora_pspecs(model_cfg: ModelConfig, lora: Dict) -> Dict:
    """The adapters' spec tree (``parallel/mesh.py``'s tuples): A
    replicated on its r axis and cut like the base weight's in dim, B like
    its out dim."""
    col = {"A": (None, None), "B": (None, "tp")}   # column-parallel targets
    row = {"A": ("tp", None), "B": (None, None)}   # row-parallel targets
    kind = {"wq": col, "wk": col, "wv": col, "w_gate": col, "w_up": col,
            "wo": row, "w_down": row}
    return {"layers": [{t: dict(kind[t]) for t in le}
                       for le in lora["layers"]]}


def replicated_leaves(model_cfg: ModelConfig, lora: Dict
                      ) -> List[torch.Tensor]:
    """The adapter leaves that ``lora_pspecs`` replicates over tp (A of the
    column-parallel targets, B of the row-parallel ones): each feeds a
    tp-local product, so each tp rank holds a partial sum of its
    gradient."""
    specs = lora_pspecs(model_cfg, lora)
    return [x for le, sle in zip(lora["layers"], specs["layers"])
            for t, ab in le.items() for k, x in ab.items()
            if "tp" not in sle[t][k]]


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
