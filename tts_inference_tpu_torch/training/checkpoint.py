"""Checkpoint save/restore of a parameter tree: ``save_params`` /
``restore_params`` of ``tts_inference_tpu/training/checkpoint.py``.

The JAX package writes orbax; the port writes one ``params.safetensors``
holding every tensor leaf under its path in the tree (``layers.0.wq``), the
tree's skeleton as JSON in the file's ``__metadata__``, and the same
``metadata.json`` sidecar (``vocab_size``, ``quantized``, ``model_config``).
The two packages therefore cannot read each other's checkpoints.
``CheckpointManager`` keeps one such directory per training step, as the
JAX package's orbax manager keeps step directories, with the same
retention.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

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


def _like(tree: Any, like: Any, path: str = "") -> Any:
    """`tree` with each leaf moved to the device and dtype of `like`'s leaf
    at the same place; a different structure raises."""
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            raise ValueError(f"checkpoint{path}: keys differ from the "
                             "template's")
        return {k: _like(tree[k], v, f"{path}.{k}") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if not isinstance(tree, list) or len(tree) != len(like):
            raise ValueError(f"checkpoint{path}: not a list of {len(like)}")
        return [_like(t, v, f"{path}.{i}")
                for i, (t, v) in enumerate(zip(tree, like))]
    if like is None or tree is None:
        if like is not tree:
            raise ValueError(f"checkpoint{path}: None against a tensor")
        return None
    return tree.to(device=like.device, dtype=like.dtype)


class CheckpointManager:
    """Step-indexed checkpoints with retention (HF save_steps analog): each
    ``save(step, tree)`` writes ``<directory>/<step>/`` with
    ``save_params`` and then removes the oldest step directories beyond
    `max_to_keep`."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and is_checkpoint(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any) -> None:
        save_params(os.path.join(self.directory, str(step)), tree)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore_latest(self, like: Optional[Any] = None) -> Tuple[int, Any]:
        """(step, tree) of the latest step: on the CPU, or with `like` (a
        tree of the same structure) on its leaves' devices and dtypes."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        tree, _ = restore_params(os.path.join(self.directory, str(step)))
        if like is not None:
            tree = _like(tree, like)
        return step, tree

    def close(self) -> None:
        """Nothing to wait for: ``save`` returns once the files are
        written."""
