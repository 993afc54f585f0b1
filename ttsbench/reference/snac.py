"""Float32 reference of the SNAC 24 kHz decoder with position noise.

    3 codebooks → embed + 1×1 projection, nearest upsample, sum
    → depthwise + pointwise input conv → 4 × [snake, transposed conv,
    noise·(1×1 conv of x) with noise addressed by absolute position,
    3 residual units (snake, dilated depthwise conv 7, snake, 1×1 conv,
    + x)] → snake → conv 7 → tanh → PCM16 by truncation.

Decodes a whole utterance at once; zero padding at both ends is the
sequence's own edge. The noise is N(0, 1) from a 32-bit splitmix hash of
(seed, block, position) by Box-Muller: the benchmark's own copy of the
hash the served path is specified to use."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

M32 = 0xFFFFFFFF
RATES = (8, 8, 4, 2)
STRIDES = (4, 2, 1)


def _mul32(x, c):
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _mix32(x):
    x = x & M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _noise(seed: int, block: int, length: int, dev) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.int64, device=dev) & M32
    base = _mix32(torch.tensor(seed & M32, dtype=torch.int64, device=dev)
                  ^ ((0x9E3779B9 * (block + 1)) & M32))
    h = _mix32(pos ^ base)
    h2 = _mix32(h ^ 0x68E31DA4)
    u1 = (h.float() + 1.0) / 4294967296.0
    u2 = h2.float() / 4294967296.0
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * np.pi) * u2)


def _snake(x, alpha):
    a = alpha[None, :, None]
    return x + torch.sin(a * x) ** 2 / (a + 1e-9)


@torch.no_grad()
def decode(params, layers, noise_seed: int = 0) -> torch.Tensor:
    """Codebook layers (n,), (2n,), (4n,) → float32 waveform (n · 2048,).
    Weights in torch layout: conv (Cout, Cin/g, K), transposed conv
    (Cin, Cout, K)."""
    dev = params["quantizer"][0]["codebook"].device
    z = None
    for q, stride, c in zip(params["quantizer"], STRIDES, layers):
        emb = q["codebook"][torch.as_tensor(c, dtype=torch.long, device=dev)]
        p = F.conv1d(emb.t()[None], q["out_proj"]["w"], q["out_proj"]["b"])
        p = p.repeat_interleave(stride, dim=-1)
        z = p if z is None else z + p
    d = params["decoder"]
    x = F.conv1d(z, d["in"]["dw"]["w"], d["in"]["dw"]["b"], padding=3,
                 groups=z.shape[1])
    x = F.conv1d(x, d["in"]["pw"]["w"], d["in"]["pw"]["b"])
    for i, (bp, rate) in enumerate(zip(d["blocks"], RATES)):
        x = _snake(x, bp["alpha"])
        x = F.conv_transpose1d(x, bp["up"]["w"], bp["up"]["b"], stride=rate,
                               padding=math.ceil(rate / 2),
                               output_padding=rate % 2)
        if bp.get("noise_lin") is not None:
            h = F.conv1d(x, bp["noise_lin"]["w"])
            x = x + _noise(noise_seed, i, x.shape[-1], dev)[None, None] * h
        for dil, rp in zip((1, 3, 9), bp["res"]):
            y = _snake(x, rp["alpha1"])
            y = F.conv1d(y, rp["conv1"]["w"], rp["conv1"]["b"],
                         padding=3 * dil, dilation=dil, groups=y.shape[1])
            y = _snake(y, rp["alpha2"])
            x = x + F.conv1d(y, rp["conv2"]["w"], rp["conv2"]["b"])
    x = _snake(x, d["out_alpha"])
    x = F.conv1d(x, d["out_conv"]["w"], d["out_conv"]["b"], padding=3)
    return torch.tanh(x)[0, 0]


def pcm16(audio: torch.Tensor) -> np.ndarray:
    """[-1, 1] float → int16 by truncation toward zero."""
    a = audio.detach().cpu().numpy()
    return np.clip(a * 32767.0, -32768, 32767).astype(np.int16)
