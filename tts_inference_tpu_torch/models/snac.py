"""SNAC-equivalent neural vocoder (codes → 24 kHz PCM), f32.

Port of ``tts_inference_tpu/models/snac.py``:

    3 hierarchical codebooks → embed + 1x1 out-projection, nearest-upsample,
    sum → depthwise+pointwise input conv → 4 × [Snake, ConvTranspose
    (×8/×8/×4/×2), position-addressed noise, 3 residual units]
    → Snake → Conv(→1) → tanh

The public functions keep the JAX package's (B, T, C) layout; inside,
``decode_latent`` keeps activations channel-first (B, C, T) for cuDNN and
hands the residual units to K6 (``ops.vocoder.fused_residual_unit``, which
reads the channel-first storage through strides) — the hand-written kernel
on CUDA for every unit, its plain version on the CPU.

TF32 is turned off for the whole process when this module is imported:
``torch.backends.cudnn.allow_tf32`` is True by default in torch, and a TF32
convolution (about three decimal digits) would break the vocoder's f32
parity with the JAX package and with K6.

The noise is a pure function of (seed, block, absolute position), so a
windowed streaming decode equals a batch decode on interior samples.
uint32 arithmetic is emulated in int64 masked to 32 bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tts_inference_tpu_torch.config import SnacConfig
from tts_inference_tpu_torch.ops.vocoder import (fused_residual_unit, snake,
                                                 valid_lengths)
from tts_inference_tpu_torch.utils import copy_async, to_numpy

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

__all__ = ["conv1d", "conv_transpose1d", "snake", "position_noise",
           "codes_to_latent", "decode_latent", "decode_codes", "to_pcm16",
           "SnacDecoder"]

Params = Dict
_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Primitive ops (public: (B, T, C); weights in torch layout)
# ---------------------------------------------------------------------------


def conv1d(x, w, b=None, *, stride=1, dilation=1, padding=0, groups=1):
    """1-D convolution. x: (B, T, Cin); w: (Cout, Cin//groups, K)."""
    return F.conv1d(x.transpose(1, 2), w, b, stride=stride, padding=padding,
                    dilation=dilation, groups=groups).transpose(1, 2)


def conv_transpose1d(x, w, b=None, *, stride=1, padding=0, output_padding=0):
    """1-D transposed convolution. x: (B, T, Cin); w: (Cin, Cout, K)."""
    return F.conv_transpose1d(x.transpose(1, 2), w, b, stride=stride,
                              padding=padding,
                              output_padding=output_padding).transpose(1, 2)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2³² for x in [0, 2³²), without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """splitmix-style 32-bit integer hash on int64 tensors holding uint32."""
    x = x & _M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def position_noise(seed, block_idx: int, offset, length: int, batch: int,
                   device=None) -> torch.Tensor:
    """Deterministic N(0, 1) noise addressed by absolute position:
    (batch, length, 1) f32; value at position p depends only on
    (seed, block, p)."""
    i64 = dict(dtype=torch.int64, device=device)
    seed = torch.as_tensor(seed, **i64).expand(batch) & _M32
    offset = torch.as_tensor(offset, **i64).expand(batch) & _M32
    pos = (torch.arange(length, **i64)[None, :] + offset[:, None]) & _M32
    base = _mix32(seed[:, None] ^ ((0x9E3779B9 * (block_idx + 1)) & _M32))
    h = _mix32(pos ^ base)
    h2 = _mix32(h ^ 0x68E31DA4)
    # Box–Muller from two uniform hashes
    u1 = (h.float() + 1.0) / 4294967296.0
    u2 = h2.float() / 4294967296.0
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = (2.0 * np.pi) * u2
    return (r * torch.cos(theta))[..., None]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def codes_to_latent(params: Params, cfg: SnacConfig,
                    codes: Sequence[torch.Tensor]) -> torch.Tensor:
    """3 codebook layers (B, n_i) → summed latent (B, T_latent, latent_dim)."""
    z = None
    for q, stride, c in zip(params["quantizer"], cfg.vq_strides, codes):
        emb = q["codebook"][c.long()]                     # (B, n, cd)
        proj = F.conv1d(emb.transpose(1, 2), q["out_proj"]["w"],
                        q["out_proj"]["b"])               # (B, L, n)
        if stride > 1:
            proj = proj.repeat_interleave(stride, dim=2)
        z = proj if z is None else z + proj
    return z.transpose(1, 2)


def _mask_tail(x: torch.Tensor,
               valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Channel-first (B, C, T): zero positions t >= valid[b]; None = no-op.
    Re-zeroing the pad zone after every spreading op makes a bucket-padded
    decode equal an unpadded one on all content samples."""
    if valid is None:
        return x
    t = torch.arange(x.shape[-1], device=x.device)
    return torch.where(t[None, None, :] < valid[:, None, None], x,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _snake_cf(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return snake(x.transpose(1, 2), alpha).transpose(1, 2)


def decode_latent(params: Params, cfg: SnacConfig, z: torch.Tensor, *,
                  noise_seed=0, latent_offset=0,
                  use_noise: Optional[bool] = None,
                  valid_latent=None) -> torch.Tensor:
    """Latent (B, T, latent_dim) → waveform (B, T*512) f32 in [-1, 1].

    ``latent_offset`` anchors the position noise (windowed decodes match
    batch decodes); ``valid_latent`` (scalar or (B,)) is the content length —
    the padded tail behaves like a sequence end."""
    dp = params["decoder"]
    use_noise = cfg.noise if use_noise is None else use_noise
    b = z.shape[0]
    dev = z.device
    valid = (None if valid_latent is None
             else valid_lengths(valid_latent, b, z.shape[1], dev))

    x = _mask_tail(z.transpose(1, 2), valid)
    if cfg.depthwise:
        x = F.conv1d(x, dp["in"]["dw"]["w"], dp["in"]["dw"]["b"], padding=3,
                     groups=cfg.latent_dim)
        x = F.conv1d(x, dp["in"]["pw"]["w"], dp["in"]["pw"]["b"])
    else:
        x = F.conv1d(x, dp["in"]["conv"]["w"], dp["in"]["conv"]["b"],
                     padding=3)
    x = _mask_tail(x, valid)

    up_total = 1
    offset = torch.as_tensor(latent_offset, dtype=torch.int64, device=dev)
    for i, (bp, rate) in enumerate(zip(dp["blocks"], cfg.decoder_rates)):
        x = _snake_cf(x, bp["alpha"])
        x = F.conv_transpose1d(x, bp["up"]["w"], bp["up"]["b"], stride=rate,
                               padding=math.ceil(rate / 2),
                               output_padding=rate % 2)
        up_total *= rate
        valid = None if valid is None else valid * rate
        x = _mask_tail(x, valid)
        if use_noise and bp["noise_lin"] is not None:
            h = F.conv1d(x, bp["noise_lin"]["w"])
            noise = position_noise(noise_seed, i, (offset * up_total) & _M32,
                                   x.shape[-1], b, device=dev)
            # noise is f32 (Box–Muller needs the mantissa); the product is
            # cast back to the compute dtype
            x = _mask_tail(x + (noise.transpose(1, 2) * h).to(x.dtype), valid)
        for dil, rp in zip((1, 3, 9), bp["res"]):
            x = fused_residual_unit(x.transpose(1, 2), rp, dil,
                                    valid).transpose(1, 2)

    x = _snake_cf(x, dp["out_alpha"])
    x = F.conv1d(x, dp["out_conv"]["w"], dp["out_conv"]["b"], padding=3)
    return torch.tanh(x)[:, 0].float()


def decode_codes(params: Params, cfg: SnacConfig,
                 codes: Sequence[torch.Tensor], *, noise_seed=0,
                 latent_offset=0, use_noise: Optional[bool] = None,
                 valid_latent=None) -> torch.Tensor:
    """Full decode: 3 code layers → waveform (B, samples)."""
    z = codes_to_latent(params, cfg, codes)
    return decode_latent(params, cfg, z, noise_seed=noise_seed,
                         latent_offset=latent_offset, use_noise=use_noise,
                         valid_latent=valid_latent)


def to_pcm16(audio: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float → int16 PCM (truncation toward zero, like astype)."""
    return torch.clamp(audio * 32767.0, -32768.0, 32767.0).to(torch.int16)


@dataclasses.dataclass
class SnacDecoder:
    """Decode at bucketed frame counts, several windows per device call.

    Buckets bound the shapes cuDNN sees (its algorithm choice is per shape)
    and match the JAX package's padding, so both decode the same windows.
    """

    params: Params
    cfg: SnacConfig
    frame_buckets: Tuple[int, ...] = (8, 16, 32, 64, 128, 256, 512, 1024)
    use_noise: Optional[bool] = None

    def __post_init__(self):
        if self.cfg.dtype != "float32":
            raise NotImplementedError(
                "the port's vocoder runs in f32 only; the bf16 vocoder is "
                "ROADMAP.md Queue 1 item 14")
        self.device = self.params["quantizer"][0]["codebook"].device

    def bucket_frames(self, n_frames: int) -> int:
        for b in self.frame_buckets:
            if n_frames <= b:
                return b
        return n_frames

    def decode_frames(self, l1, l2, l3, *, noise_seed: int = 0,
                      first_frame: int = 0) -> np.ndarray:
        """Decode n frames (host API) → (n * 2048,) float32."""
        return self.decode_frames_batch(
            [(np.asarray(l1), np.asarray(l2), np.asarray(l3))],
            first_frames=[first_frame], noise_seeds=[noise_seed])[0]

    def decode_frames_batch(self, layers, *, first_frames,
                            noise_seeds) -> list:
        """Decode several independent frame windows in ONE device call
        (rows bucketed to a power of two, frames to frame_buckets; per-row
        valid lengths keep each row equal to its solo decode)."""
        return self.decode_frames_batch_fetch(self.decode_frames_batch_launch(
            layers, first_frames=first_frames, noise_seeds=noise_seeds))

    def decode_frames_batch_launch(self, layers, *, first_frames,
                                   noise_seeds):
        """Launch the batched decode and queue its device→host copy;
        returns a handle for :meth:`decode_frames_batch_fetch`."""
        n_rows = len(layers)
        ns = [int(l1.shape[-1]) for l1, _, _ in layers]
        nb = self.bucket_frames(max(ns))
        rb = 1
        while rb < n_rows:
            rb *= 2
        lat = max(self.cfg.vq_strides)

        def stack(idx, mult):
            out = np.zeros((rb, mult * nb), np.int64)
            for r, lay in enumerate(layers):
                x = np.asarray(lay[idx], dtype=np.int64)
                out[r, : x.shape[-1]] = x
            return torch.from_numpy(out).to(self.device)

        def pad_vec(vals):
            out = np.zeros(rb, np.int64)
            out[:n_rows] = vals
            return torch.from_numpy(out).to(self.device)

        codes = (stack(0, 1), stack(1, 2), stack(2, 4))
        audio = decode_codes(
            self.params, self.cfg, codes,
            noise_seed=pad_vec([int(s) & _M32 for s in noise_seeds]),
            latent_offset=pad_vec([f * lat for f in first_frames]),
            use_noise=self.use_noise,
            valid_latent=pad_vec([n * lat for n in ns]).to(torch.int32),
        )
        (host,) = copy_async(audio)
        return host, ns

    def decode_frames_batch_fetch(self, handle) -> list:
        """Blocking half: host audio rows for a launched batch."""
        host, ns = handle
        spf = self.cfg.samples_per_frame
        audio = to_numpy(host)
        return [audio[r, : ns[r] * spf] for r in range(len(ns))]
