"""Training step: causal-LM fine-tune (full or LoRA) on ``torch.optim``.

Port of ``tts_inference_tpu/training/train_step.py``. The reference trains
with HF Trainer on one GPU (fp16, paged_adamw_8bit,
`modal_finetune_base.py:130-156`); the JAX package jits a pure step over a
mesh with optax. Here the step runs eagerly on one device: autograd through
the serve path's own ``forward`` (a fresh zero cache doubles as the
attention buffer, written in place), ``torch.optim.AdamW`` with the
learning rate set from the cosine schedule before each update. LoRA mode
differentiates only the adapter tree, merged into the frozen base every
step (``lora.merge_params``).

``make_optimizer`` stands for ``optax.adamw(optax.cosine_decay_schedule(lr,
max(steps, 1)), weight_decay=0.01)``, the JAX fine-tune's optimizer: b1
0.9, b2 0.999, eps 1e-8, decoupled decay on every leaf scaled by the
learning rate, and lr(count) = lr·½(1 + cos(π·min(count, steps)/steps))
with count 0 at the first update.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from tts_inference_tpu_torch.config import ModelConfig
from tts_inference_tpu_torch.models import llama
from tts_inference_tpu_torch.training import lora as lora_lib

# The full-width LoRA step the card is measured at (``chip_smoke.py``'s
# train phase, ``tools/step_profile --train``): batch 2 of 512 tokens, r 16,
# alpha 32 on the 7 targets.
CARD_BATCH, CARD_LEN, CARD_LORA_R, CARD_LORA_ALPHA = 2, 512, 16, 32.0


def lm_loss(
    params: Dict,
    model_cfg: ModelConfig,
    tokens: torch.Tensor,     # (B, S) int
    lens: torch.Tensor,       # (B,) int
) -> torch.Tensor:
    """Next-token cross entropy with length masking (f32 scalar).

    Uses the same forward as inference: a fresh zero cache doubles as the
    training attention buffer (one code path, no train/serve divergence)."""
    b, s = tokens.shape
    dev = tokens.device
    cache = llama.init_kv_cache(model_cfg, b, s, device=dev)
    hidden, _ = llama.forward(params, model_cfg, tokens, cache,
                              torch.zeros(b, dtype=torch.int32, device=dev),
                              lens)
    logits = llama.compute_logits(params, model_cfg, hidden[:, :-1])
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:].long()[..., None])[..., 0]
    mask = (torch.arange(s - 1, device=dev)[None, :] + 1) < lens[:, None]
    return (nll * mask).sum() / mask.sum().clamp(min=1)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensor leaves of a params / adapter tree, in tree order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


@dataclasses.dataclass(frozen=True)
class AdamWCosine:
    """AdamW with a cosine-decayed learning rate (``make_optimizer``); b1,
    b2 and eps are optax.adamw's defaults."""

    lr: float
    steps: int
    weight_decay: float = 0.01

    def lr_at(self, count: int) -> float:
        """optax.cosine_decay_schedule(lr, steps) at update `count`."""
        frac = min(count, self.steps) / self.steps
        return self.lr * 0.5 * (1.0 + math.cos(math.pi * frac))

    def init(self, leaves: List[torch.Tensor]) -> torch.optim.AdamW:
        return torch.optim.AdamW(leaves, lr=self.lr_at(0),
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=self.weight_decay)


def make_optimizer(lr: float, steps: int,
                   weight_decay: float = 0.01) -> AdamWCosine:
    return AdamWCosine(lr=lr, steps=max(steps, 1), weight_decay=weight_decay)


@dataclasses.dataclass
class TrainState:
    params: Dict                       # trainable tree (full params, or LoRA)
    optimizer: torch.optim.AdamW       # over tree_leaves(params)
    step: int


def make_train_step(
    model_cfg: ModelConfig,
    optimizer: AdamWCosine,
    *,
    base_params: Optional[Dict] = None,
    lora_scale: float = 2.0,
):
    """Returns train_step(state, tokens, lens) -> (state, loss).

    With base_params set, `state.params` is a LoRA tree merged into the
    frozen base each step (grads flow only into A/B). The step updates
    `state` in place (parameters, optimizer moments, step) and returns it;
    `tokens` / `lens` may be numpy arrays (``data.batches``) or tensors."""

    def train_step(state: TrainState, tokens, lens):
        dev = tree_leaves(state.params)[0].device
        tokens = torch.as_tensor(tokens, device=dev)
        lens = torch.as_tensor(lens, device=dev)
        state.optimizer.zero_grad(set_to_none=True)
        params = (state.params if base_params is None else
                  lora_lib.merge_params(base_params, state.params,
                                        lora_scale))
        loss = lm_loss(params, model_cfg, tokens, lens)
        del params      # the merged weights go with the graph in backward
        loss.backward()
        for group in state.optimizer.param_groups:
            group["lr"] = optimizer.lr_at(state.step)
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return train_step


def init_train_state(trainable: Dict, optimizer: AdamWCosine) -> TrainState:
    """Marks the trainable leaves as requiring grad and builds the AdamW
    over them."""
    leaves = tree_leaves(trainable)
    for x in leaves:
        x.requires_grad_(True)
    return TrainState(params=trainable, optimizer=optimizer.init(leaves),
                      step=0)
