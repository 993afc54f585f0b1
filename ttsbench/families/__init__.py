"""Block families: one module a family of model blocks, found by the
configuration's `model_type`.

A family module declares `MODEL_TYPES`, the `model_type` values it serves,
and provides:

- `port_config(model, mix)`: the port's `Config` for a configuration file
  and a traffic mix; it refuses every key of the block it cannot run;
- `make_weights(model, seed, device)`: the parameter tree on the device,
  made from the seed;
- `logits(params, model, ids, first, lo, hi, weight_fn=None)`: the float32
  reference logits of rows [lo, hi) at positions first ... len(ids) - 1
  (the reference itself is `reference/<family>.py`, which imports nothing
  of the port);
- `control_params(params)`: the port's int8 weights (`--control`);
- `decode_launch(model, rec)`: a decode launch's model `flops` and the
  bound of its K1 calls, `k1_bound_s`, from its recorded lengths and
  active rows (`roofline.py` keeps the peaks and the per-call bounds).

`of(model)` searches every `*.py` of the package's path, `__path__`; a new
architecture is a new file here.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType
from typing import Dict, List


def files() -> List[Path]:
    """The family modules on the search path, the first of each name."""
    found: Dict[str, Path] = {}
    for d in __path__:
        for p in sorted(Path(d).glob("*.py")):
            if p.stem != "__init__":
                found.setdefault(p.stem, p)
    return list(found.values())


def of(model: Dict) -> ModuleType:
    """The family whose `MODEL_TYPES` holds the configuration's
    `model_type`; a configuration without one, or with one that no family
    or more than one serves, is refused (LookupError)."""
    mt = model.get("model_type")
    paths = files()
    hits = [m for m in (importlib.import_module(f"{__name__}.{p.stem}")
                        for p in paths) if mt in m.MODEL_TYPES]
    if len(hits) != 1:
        served = "no family serves it" if not hits else \
            f"{len(hits)} families serve it"
        raise LookupError(f"model_type {mt!r}: {served}; searched "
                          f"{[str(p) for p in paths]}")
    return hits[0]
