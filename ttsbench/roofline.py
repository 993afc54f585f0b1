"""Peaks of one H100 SXM, the bound of a K1 and a K6 call (shared by every
block family), and the Llama family's model FLOPs of a decode step
(`families/llama.py`; another family counts its own).

Peaks: NVIDIA's data sheet, dense rates — 3.35 TB/s of HBM, 989 TFLOP/s
bf16 on the tensor cores, 67 TFLOP/s f32 outside them. A bound is the
larger of the bytes at the memory rate (every input byte read once, every
output byte written once) and the operations at their type's peak. The
byte and operation counts of K1 and K6 are those of the repository's
kernel phase (`chip_smoke.py`), copied."""

from __future__ import annotations

from typing import Dict, List, Sequence

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
HEAD_ROWS = 156940 - 128000      # the sliced head's rows
SNAC_RATES = (8, 8, 4, 2)
SNAC_DIM = 1024
LATENT_PER_FRAME = 4             # SNAC latent positions per 7-token frame
SAMPLES_PER_FRAME = 2048
SAMPLE_RATE = 24000


def bound_s(nbytes: float, flops: float, kind: str) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[kind])


def k1_call_bound_s(keys: int, rows: int, hkv: int, g: int, d: int) -> float:
    """One decode-attention call over `rows` query rows that attend `keys`
    positions in all (Σ pos + 1): K and V rows of every kv head read once
    (2·D bf16 each), q read and the output written (bf16); 4·G·D
    operations per key and kv head (q·k and p·v)."""
    nbytes = keys * hkv * 2 * d * 2 + 2 * rows * hkv * g * d * 2
    return bound_s(nbytes, 4.0 * g * d * keys * hkv, "bf16")


def k6_call_bound_s(valid_latent: Sequence[int]) -> float:
    """One vocoder call's twelve residual units (three per decoder block),
    over each row's valid length: x read and the output written once, the
    weights once (f32); per output element the pointwise product (2·C),
    the 7-tap depthwise convolution and two snakes (~30 operations)."""
    total, up = 0.0, 1
    for i, rate in enumerate(SNAC_RATES):
        up *= rate
        c = SNAC_DIM // 2 ** (i + 1)
        elems = sum(v * up for v in valid_latent) * c
        total += 3 * bound_s(4.0 * (2 * elems + c * c + 10 * c),
                             elems * (2.0 * c + 30), "f32")
    return total


def matmul_params(cfg: Dict) -> int:
    """Weights a decode step multiplies per row: the seven matrices of
    every layer and the sliced head."""
    h, nq = cfg["hidden_size"], cfg["num_attention_heads"]
    d = cfg.get("head_dim") or h // nq
    nkv, ffn = cfg["num_key_value_heads"], cfg["intermediate_size"]
    per_layer = h * nq * d * 2 + h * nkv * d * 2 + 3 * h * ffn
    return cfg["num_hidden_layers"] * per_layer + h * HEAD_ROWS


def decode_launch(cfg: Dict, rec: Dict) -> Dict[str, float]:
    """A decode launch's model FLOPs and the bound of its K1 calls, from
    its recorded lengths and active rows: every active row takes `n`
    steps, attending its length + 1 positions at the first."""
    h, nq = cfg["hidden_size"], cfg["num_attention_heads"]
    d = cfg.get("head_dim") or h // nq
    nkv, nl = cfg["num_key_value_heads"], cfg["num_hidden_layers"]
    act: List[int] = [ln for ln, a in zip(rec["lengths"], rec["active"]) if a]
    rows, flops, k1 = len(act), 0.0, 0.0
    pm = matmul_params(cfg)
    for k in range(rec["n"]):
        keys = sum(ln + k + 1 for ln in act)
        flops += 2.0 * rows * pm + 4.0 * nl * nq * d * keys
        if rows:
            k1 += nl * k1_call_bound_s(keys, rows, nkv, nq // nkv, d)
    return {"flops": flops, "k1_bound_s": k1}
