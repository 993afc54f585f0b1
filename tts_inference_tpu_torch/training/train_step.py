"""Training step: causal-LM fine-tune (full or LoRA) on ``torch.optim``.

Port of ``tts_inference_tpu/training/train_step.py``. The reference trains
with HF Trainer on one GPU (fp16, paged_adamw_8bit,
`modal_finetune_base.py:130-156`); the JAX package jits a pure step over a
mesh with optax. Here the step runs eagerly: autograd through the serve
path's own ``forward`` (a fresh zero cache doubles as the attention
buffer, written in place), ``torch.optim.AdamW`` with the learning rate set
from the cosine schedule before each update. LoRA mode differentiates only
the adapter tree, merged into the frozen base every step
(``lora.merge_params``).

Under a (dp, tp) mesh (``make_train_step(mesh=)``; the weights and the
adapters are this rank's shards, ``weights.shard_params`` /
``lora.init_lora(mesh=)``) each rank runs the same step on its shard, and
the collectives XLA derives for JAX are called explicitly:

- dp takes this rank's rows of the batch (``mesh.batch_pspec``); the loss
  is the global mean, its masked-token count summed over dp with no
  gradient, and every gradient is summed over dp;
- tp differentiates through the model's autograd-aware collectives
  (``parallel/collectives.py``), and the loss's log-softmax runs
  vocab-parallel: the shift (the max) and the sum of exponentials are
  taken over tp, and the target's logit comes from the rank whose block
  of the vocabulary partition holds it — no rank gathers the logits;
- a replicated leaf whose product is tp-local (A of a column-parallel
  LoRA target, B of a row-parallel one) has a partial gradient on each tp
  rank and is summed over tp; a replicated leaf on replicated activations
  (the norms, in a full fine-tune) already has the whole gradient on every
  rank and is not.

The optimizer stays elementwise on each shard (the JAX optimizer clips no
global norm), so a shard's update is the unsharded update's block.

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
from tts_inference_tpu_torch.parallel import collectives as C
from tts_inference_tpu_torch.parallel import mesh as M
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
    mesh=None,
) -> torch.Tensor:
    """Next-token cross entropy with length masking (f32 scalar).

    Uses the same forward as inference: a fresh zero cache doubles as the
    training attention buffer (one code path, no train/serve divergence).
    Under a mesh, `tokens` / `lens` are this dp rank's rows and `params`
    its shard; the result is this rank's share of the global mean, whose
    sum over dp is the loss."""
    b, s = tokens.shape
    dev = tokens.device
    local = model_cfg if mesh is None else M.local_model_config(model_cfg,
                                                                mesh.tp)
    cache = llama.init_kv_cache(local, b, s, device=dev)
    hidden, _ = llama.forward(params, model_cfg, tokens, cache,
                              torch.zeros(b, dtype=torch.int32, device=dev),
                              lens, mesh=mesh)
    targets = tokens[:, 1:].long()
    if mesh is None:
        logits = llama.compute_logits(params, model_cfg, hidden[:, :-1])
        logp = F.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, targets[..., None])[..., 0]
    else:
        nll = vocab_parallel_nll(params, model_cfg, hidden[:, :-1], targets,
                                 mesh)
    mask = (torch.arange(s - 1, device=dev)[None, :] + 1) < lens[:, None]
    count = C.all_reduce_dp(mask.sum().float(), mesh)
    return (nll * mask).sum() / count.clamp(min=1)


def vocab_parallel_nll(params: Dict, model_cfg: ModelConfig,
                       hidden: torch.Tensor, targets: torch.Tensor,
                       mesh) -> torch.Tensor:
    """-log softmax(logits)[target] (f32, the shape of `targets`) from this
    tp rank's block of the logits: log Σ exp over the whole vocabulary is
    the tp max plus the log of the tp sum of the shifted exponentials, and
    the target's logit is summed over tp from the rank that owns it."""
    vs = M.vocab_shards(model_cfg.vocab_size, mesh.tp)
    z = llama.local_logits(params, model_cfg, hidden, mesh)
    z = z.masked_fill(~vs.own_rows(mesh.tp_rank, z.device), float("-inf"))
    shift = C.all_reduce_max_tp(z.detach().amax(dim=-1), mesh)
    sumexp = C.reduce_from_tp(torch.exp(z - shift[..., None]).sum(dim=-1),
                              mesh)
    idx, own = vs.local_index(targets, mesh.tp_rank)
    picked = z.gather(-1, idx[..., None])[..., 0]
    zt = C.reduce_from_tp(torch.where(own, picked, torch.zeros_like(picked)),
                          mesh)
    return torch.log(sumexp) + shift - zt


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


def _sum_grads(leaves: List[torch.Tensor], reduce) -> None:
    """Sum the gradients of `leaves` with `reduce` (a collective, in place),
    one call per dtype over their gradients laid end to end."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for x in leaves:
        if x.grad is not None:
            by_dtype.setdefault(x.grad.dtype, []).append(x.grad)
    for grads in by_dtype.values():
        flat = reduce(torch.cat([g.reshape(-1) for g in grads]))
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def make_train_step(
    model_cfg: ModelConfig,
    optimizer: AdamWCosine,
    *,
    base_params: Optional[Dict] = None,
    lora_scale: float = 2.0,
    mesh=None,
):
    """Returns train_step(state, tokens, lens) -> (state, loss).

    With base_params set, `state.params` is a LoRA tree merged into the
    frozen base each step (grads flow only into A/B). The step updates
    `state` in place (parameters, optimizer moments, step) and returns it;
    `tokens` / `lens` may be numpy arrays (``data.batches``) or tensors.
    With `mesh`, every rank of it calls the step with the whole batch and
    its shards of the weights and adapters, and gets the global loss."""

    def train_step(state: TrainState, tokens, lens):
        leaves = tree_leaves(state.params)
        dev = leaves[0].device
        tokens = torch.as_tensor(tokens, device=dev)
        lens = torch.as_tensor(lens, device=dev)
        if mesh is not None:
            tokens = M.shard_tree(tokens, M.batch_pspec(), mesh)
            lens = M.shard_tree(lens, M.batch_pspec()[:1], mesh)
        state.optimizer.zero_grad(set_to_none=True)
        params = (state.params if base_params is None else
                  lora_lib.merge_params(base_params, state.params,
                                        lora_scale))
        loss = lm_loss(params, model_cfg, tokens, lens, mesh)
        del params      # the merged weights go with the graph in backward
        loss.backward()
        if mesh is not None:
            _sum_grads(leaves, lambda g: C.all_reduce_dp(g, mesh))
            if base_params is not None:
                _sum_grads(lora_lib.replicated_leaves(model_cfg,
                                                      state.params),
                           lambda g: C.all_reduce_tp(g, mesh))
            loss = C.all_reduce_dp(loss.detach().clone(), mesh)
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
