"""Checkpoint save/restore of a parameter tree: ``save_params`` /
``restore_params`` of ``tts_inference_tpu/training/checkpoint.py``.

The JAX package writes orbax; the port writes one ``params.safetensors``
holding every tensor leaf under its path in the tree (``layers.0.wq``), the
tree's skeleton as JSON in the file's ``__metadata__``, and the same
``metadata.json`` sidecar (``vocab_size``, ``quantized``, ``model_config``).
The two packages therefore cannot read each other's checkpoints.
``CheckpointManager`` (step retention) waits for the training slice.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from tts_inference_tpu_torch.utils import safetensors_io

PARAMS_FILE = "params.safetensors"
_TREE_KEY = "tree"


def _flatten(tree: Any, prefix: str, leaves: Dict[str, torch.Tensor]) -> Any:
    """The tree's skeleton (dicts, lists, None; each tensor replaced by its
    name) while filling `leaves`."""
    if isinstance(tree, dict):
        return {k: _flatten(v, f"{prefix}{k}.", leaves)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_flatten(v, f"{prefix}{i}.", leaves)
                for i, v in enumerate(tree)]
    if tree is None:
        return None
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"{prefix[:-1]}: {type(tree).__name__} is not a "
                        "tensor (pass a to_plain tree)")
    name = prefix[:-1]
    leaves[name] = tree
    return {"__tensor__": name}


def _unflatten(skel: Any, leaves: Dict[str, torch.Tensor], device) -> Any:
    if isinstance(skel, list):
        return [_unflatten(v, leaves, device) for v in skel]
    if isinstance(skel, dict):
        if set(skel) == {"__tensor__"}:
            return leaves[skel["__tensor__"]].to(device)
        return {k: _unflatten(v, leaves, device) for k, v in skel.items()}
    return skel


def save_params(path: str, params: Dict,
                metadata: Optional[dict] = None) -> int:
    """Save a params tree (tensor leaves on any device; quantized trees via
    ``models.quant.to_plain``) and the JSON metadata sidecar. Returns the
    bytes of tensor data written."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    leaves: Dict[str, torch.Tensor] = {}
    skel = _flatten(params, "", leaves)
    n = safetensors_io.write_file(os.path.join(path, PARAMS_FILE), leaves,
                                  metadata={_TREE_KEY: json.dumps(skel)})
    if metadata is not None:
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(metadata, f, indent=2, default=str)
    return n


def restore_params(path: str, device="cpu") -> Tuple[Dict, dict]:
    """(params tree on `device`, metadata) of a ``save_params`` dir."""
    path = os.path.abspath(path)
    fname = os.path.join(path, PARAMS_FILE)
    skel = json.loads(safetensors_io.read_metadata(fname)[_TREE_KEY])
    params = _unflatten(skel, safetensors_io.read_file(fname), device)
    meta: dict = {}
    meta_path = os.path.join(path, "metadata.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return params, meta


def is_checkpoint(path: str) -> bool:
    return os.path.exists(os.path.join(path, PARAMS_FILE))
