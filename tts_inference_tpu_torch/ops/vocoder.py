"""K6: one fused SNAC residual unit (f32, bf16 or float16).

Port of ``tts_inference_tpu/ops/pallas/vocoder.py::fused_residual_unit``:

    snake → dilated depthwise conv(7) → snake → pointwise C×C → + bias → + x
    → rows t >= valid[b] set to 0

The kernels are hand-written CUDA C++ for Hopper: one for f32
(``csrc/vocoder.cu``) and one 16-bit body (``csrc/vocoder16.cuh``) with a
bf16 instance (``--vocoder-bf16``) and a float16 instance
(``SnacConfig.dtype="float16"``): the JAX package casts the vocoder's
parameters once and runs the unit in the dtype of x, its pointwise product
accumulating in f32, which the 16-bit body runs on the tensor cores.
``fused_residual_unit_reference`` beside them is the plain PyTorch version
in any of the three dtypes (in 16 bits: torch's operations in the order of
``tts_inference_tpu/models/snac.py::_residual_unit``, each rounding). The
wrapper takes the plain version only for tensors on the CPU; a CUDA tensor
launches the kernel of its dtype or raises.

Layout: the public functions keep the JAX package's (B, T, C) indexing. The
tensor may be channel-last contiguous or a transposed view of a channel-first
(B, C, T) contiguous tensor (what the port's decoder keeps for cuDNN); the
output has the input's memory layout. Parameters are the port's torch-layout
unit dict: ``{"alpha1": (C,), "conv1": {"w": (C, 1, 7), "b"}, "alpha2",
"conv2": {"w": (C, C, 1), "b"}}``, in the dtype of x. The kernels take C up
to ``MAX_CHANNELS``; the f32 kernel the dilations whose halo fits a warp's
staging buffer (up to 9), the 16-bit body SNAC's dilations 1, 3 and 9 (a
template parameter of its register window).

A 16-bit call is planned here, so that the CPU tests reach the rules:
``plan16`` picks the segment length and the grid of the persistent blocks,
``paths16`` whether x and the weight come by the copy engine (TMA) or are
gathered by the block's threads (what a tensor map cannot describe).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tts_inference_tpu_torch.ops import _build

launches = _build.LaunchCounter()        # the f32 kernel
launches_bf16 = _build.LaunchCounter()   # the 16-bit body in bf16
launches_f16 = _build.LaunchCounter()    # the 16-bit body in float16

KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

MAX_CHANNELS = 512    # the widest tile the kernels have
DILATIONS16 = (1, 3, 9)   # the 16-bit body's instances

# The 16-bit body's tiling by padded channel count (csrc/vocoder16.cuh,
# Cfg16): segments of a tile, blocks that share a tile (C 512: each owns
# half of the output channels), and the channels of the copy engine's x
# boxes, which are also the rows of its weight boxes.
SEGMENTS16 = {64: 4, 128: 2, 256: 1, 512: 1}
SPLIT16 = {64: 1, 128: 1, 256: 1, 512: 2}
BOX16 = {64: 64, 128: 128, 256: 256, 512: 256}
SEGMENT_LENGTHS = (32, 64, 128, 256, 512, 1024)


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation x + sin²(αx)/α, per-channel α on the last axis."""
    return x + torch.sin(alpha * x) ** 2 / (alpha + 1e-9)


def valid_lengths(valid, b: int, t: int, device) -> torch.Tensor:
    """None | int | (B,) → (B,) int32 content lengths on `device`."""
    if valid is None:
        return torch.full((b,), t, dtype=torch.int32, device=device)
    v = torch.as_tensor(valid, dtype=torch.int32, device=device)
    return v.expand(b).contiguous() if v.dim() == 0 else v


def fused_residual_unit_reference(x, p, dilation, valid=None):
    """Plain PyTorch version (cuDNN/CPU convolutions), same (B, T, C) API,
    in the dtype of x. In float16 on the card it takes PyTorch's own CUDA
    convolutions: cuDNN's float16 depthwise convolution faults (an illegal
    address) at (8, 128, 16384), the C 128 unit of a 16-frame call."""
    if x.dtype == torch.float16 and x.device.type == "cuda" \
            and torch.backends.cudnn.enabled:
        with torch.backends.cudnn.flags(enabled=False):
            return fused_residual_unit_reference(x, p, dilation, valid)
    b, t, c = x.shape
    v = valid_lengths(valid, b, t, x.device)
    y = snake(x, p["alpha1"]).transpose(1, 2)
    y = F.conv1d(y, p["conv1"]["w"], p["conv1"]["b"], padding=3 * dilation,
                 dilation=dilation, groups=c)
    y = snake(y.transpose(1, 2), p["alpha2"]).transpose(1, 2)
    y = F.conv1d(y, p["conv2"]["w"], p["conv2"]["b"]).transpose(1, 2)
    keep = torch.arange(t, device=x.device)[None, :, None] < v[:, None, None]
    return torch.where(keep, x + y,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def padded_channels(c: int) -> int:
    return 64 if c <= 64 else 128 if c <= 128 else 256 if c <= 256 else 512


def plan16(b: int, t: int, c: int, sms: int) -> tuple:
    """(segment length, blocks) of a 16-bit call on a card of `sms` SMs.
    A block runs one SM and walks (row, tile) items; a tile is S segments
    of L time steps. L is the one of SEGMENT_LENGTHS with the least
    makespan, waves × (L + 21): an item of L steps costs L plus its halo's
    snake1 (up to 2·32 steps at a third of the work of an output)."""
    cp = padded_channels(c)
    s, split = SEGMENTS16[cp], SPLIT16[cp]
    best = None
    for seg in SEGMENT_LENGTHS:
        items = b * -(-t // (s * seg))
        groups = max(1, min(items, sms // split))
        cost = -(-items // groups) * (seg + 21)
        if best is None or cost < best[0]:
            best = (cost, seg, groups * split)
    return best[1], best[2]


def paths16(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """(x by TMA, weight by TMA) for a 16-bit call: a tensor map needs
    16-byte aligned starts and pitches, channel-first x (time contiguous),
    boxes that stay inside the array (the channel count a multiple of the
    box), and T of at least one box (32 steps); else the block gathers."""
    b, t, c = x.shape
    cp = padded_channels(c)
    sb, st, sc = x.stride()
    x_tma = (st == 1 and x.data_ptr() % 16 == 0 and sc % 8 == 0
             and sb % 8 == 0 and c % BOX16[cp] == 0 and t >= 32)
    w_tma = w.data_ptr() % 16 == 0 and c % BOX16[cp] == 0
    return bool(x_tma), bool(w_tma)


_sms = {}


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def _check(x, p, valid_vec):
    b, t, c = x.shape
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"fused_residual_unit: {x.dtype}; the kernels take "
                        "f32, bf16 and float16")
    if not (x.is_contiguous() or x.transpose(1, 2).is_contiguous()):
        raise ValueError("fused_residual_unit: x must be (B, T, C) "
                         "contiguous or a (B, C, T)-contiguous transpose")
    if c > MAX_CHANNELS:
        raise ValueError(f"fused_residual_unit: {c} channels > {MAX_CHANNELS}")
    tensors = {"alpha1": p["alpha1"], "alpha2": p["alpha2"],
               "dw": p["conv1"]["w"], "dw_b": p["conv1"]["b"],
               "pw": p["conv2"]["w"], "pw_b": p["conv2"]["b"]}
    shapes = {"alpha1": (c,), "alpha2": (c,), "dw": (c, 1, 7), "dw_b": (c,),
              "pw": (c, c, 1), "pw_b": (c,)}
    for name, w in tensors.items():
        if tuple(w.shape) != shapes[name]:
            raise ValueError(f"fused_residual_unit: {name} {tuple(w.shape)} "
                             f"!= {shapes[name]} (depthwise geometry)")
        if w.dtype != x.dtype or not w.is_contiguous() \
                or w.device != x.device:
            raise ValueError(f"fused_residual_unit: {name} must be "
                             f"contiguous {x.dtype} on {x.device}")
    if valid_vec.shape != (b,):
        raise ValueError("fused_residual_unit: valid must be (B,)")
    return tensors


def fused_residual_unit(x, p, dilation, valid=None):
    """(B, T, C) residual-unit output in the dtype of x (f32, bf16 or
    float16); kernel on CUDA, plain on the CPU."""
    b, t, c = x.shape
    v = valid_lengths(valid, b, t, x.device)
    w = _check(x, p, v)
    if x.device.type == "cpu":
        return fused_residual_unit_reference(x, p, dilation, v)
    if x.device.type != "cuda":
        raise ValueError(f"fused_residual_unit: no kernel for {x.device}")
    lib = _build.load()
    wide = x.dtype == torch.float32
    if wide:
        fn, max_dilation, counter = (lib.tts_fused_residual_unit,
                                     lib.tts_fused_residual_unit_max_dilation,
                                     launches)
    else:
        t16 = "bf16" if x.dtype == torch.bfloat16 else "f16"
        fn = getattr(lib, f"tts_fused_residual_unit_{t16}")
        max_dilation = getattr(lib,
                               f"tts_fused_residual_unit_{t16}_max_dilation")
        counter = launches_bf16 if t16 == "bf16" else launches_f16
        if dilation not in DILATIONS16:
            raise ValueError(f"fused_residual_unit: dilation {dilation}: the "
                             f"16-bit kernel is built for {DILATIONS16}")
    if not 1 <= dilation <= max_dilation(c):
        raise ValueError(f"fused_residual_unit: dilation {dilation} at {c} "
                         "channels: the tile's halo does not fit")
    out = torch.empty_like(x)
    if out.stride() != x.stride():
        raise ValueError("fused_residual_unit: output layout differs")
    sb, st, sc = x.stride()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), v.data_ptr(), w["alpha1"].data_ptr(),
            w["dw"].data_ptr(), w["dw_b"].data_ptr(), w["alpha2"].data_ptr(),
            w["pw"].data_ptr(), w["pw_b"].data_ptr(), out.data_ptr(),
            b, t, c, int(dilation), sb, st, sc)
    if wide:
        err = fn(*args, stream)
    else:
        seg, blocks = plan16(b, t, c, _sm_count(x.device))
        x_tma, w_tma = paths16(x, w["pw"])
        err = fn(*args, seg, blocks, int(x_tma) | int(w_tma) << 1, stream)
    _build.check(err, "fused_residual_unit")
    counter.add()
    return out
