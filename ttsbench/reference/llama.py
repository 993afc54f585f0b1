"""Float32 reference of a pre-norm GQA decoder: RMSNorm, rotary positions
(half-rotation), SwiGLU, no biases, tied or untied head.

Runs one sequence at a time over its whole length, layer by layer, each
layer's bf16 weights widened to float32 as it is reached, so that it fits
beside a model that fills the card."""

from __future__ import annotations

import math

import torch


def _norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


@torch.no_grad()
def logits(params, cfg, ids, first: int, lo: int, hi: int,
           weight_fn=None) -> torch.Tensor:
    """Float32 logits of rows [lo, hi) at positions first … len(ids) − 1
    of the sequence `ids` (the row at position p predicts token p + 1).

    `weight_fn(w)` gives the float32 matrix of a weight (default: widen);
    the control passes a quantizing one."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for key, plain in (("rope_scaling", None), ("sliding_window", None),
                       ("attention_bias", False), ("mlp_bias", False),
                       ("hidden_act", "silu")):
        if cfg.get(key, plain) != plain:
            raise ValueError(f"the reference has no {key} = {cfg[key]!r}")
    wf = weight_fn or (lambda w: w.float())
    dev = params["embed"].device
    t = len(ids)
    h, nq, nkv = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"]
    d = cfg.get("head_dim") or h // nq
    eps = cfg["rms_norm_eps"]
    tok = torch.as_tensor(ids, dtype=torch.long, device=dev)
    x = params["embed"][tok].float()
    inv = 1.0 / (cfg["rope_theta"] ** (
        torch.arange(0, d, 2, dtype=torch.float64, device=dev) / d))
    ang = torch.arange(t, dtype=torch.float64, device=dev)[:, None] * inv
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    causal = torch.ones(t, t, dtype=torch.bool, device=dev).tril()
    for lp in params["layers"]:
        a = _norm(x, lp["input_norm"], eps)
        q = _rope((a @ wf(lp["wq"])).view(t, nq, d), cos, sin)
        k = _rope((a @ wf(lp["wk"])).view(t, nkv, d), cos, sin)
        v = (a @ wf(lp["wv"])).view(t, nkv, d)
        k = k.repeat_interleave(nq // nkv, dim=1)
        v = v.repeat_interleave(nq // nkv, dim=1)
        s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d)
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        o = torch.einsum("hqk,khd->qhd", p, v).reshape(t, nq * d)
        x = x + o @ wf(lp["wo"])
        a = _norm(x, lp["post_attn_norm"], eps)
        g = a @ wf(lp["w_gate"])
        x = x + (g * torch.sigmoid(g) * (a @ wf(lp["w_up"]))) @ wf(
            lp["w_down"])
    x = _norm(x[first:], params["final_norm"], eps)
    if cfg["tie_word_embeddings"]:
        return x @ wf(params["embed"][lo:hi]).t()
    return x @ wf(params["lm_head"][:, lo:hi])
