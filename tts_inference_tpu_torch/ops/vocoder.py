"""K6: one fused SNAC residual unit (f32 or bf16).

Port of ``tts_inference_tpu/ops/pallas/vocoder.py::fused_residual_unit``:

    snake → dilated depthwise conv(7) → snake → pointwise C×C → + bias → + x
    → rows t >= valid[b] set to 0

The kernels are hand-written CUDA C++ for Hopper (``csrc/vocoder.cu``): one
for f32, one for bf16 (``--vocoder-bf16``: the JAX package casts the
vocoder's parameters once and runs the unit in the dtype of x, its
pointwise product accumulating in f32), whose pointwise product runs on the
tensor cores. ``fused_residual_unit_reference`` beside them is the plain
PyTorch version in either dtype (in bf16: torch's bf16 operations in the
order of ``tts_inference_tpu/models/snac.py::_residual_unit``, each
rounding). The wrapper takes the plain version only for tensors on the
CPU; a CUDA tensor launches the kernel of its dtype or raises.

Layout: the public functions keep the JAX package's (B, T, C) indexing. The
tensor may be channel-last contiguous or a transposed view of a channel-first
(B, C, T) contiguous tensor (what the port's decoder keeps for cuDNN); the
output has the input's memory layout. Parameters are the port's torch-layout
unit dict: ``{"alpha1": (C,), "conv1": {"w": (C, 1, 7), "b"}, "alpha2",
"conv2": {"w": (C, C, 1), "b"}}``, in the dtype of x. The kernel takes C up to
``MAX_CHANNELS`` and the dilations whose halo fits a warp's staging buffer
(up to 9; SNAC uses 1, 3 and 9).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tts_inference_tpu_torch.ops import _build

launches = _build.LaunchCounter()        # the f32 kernel
launches_bf16 = _build.LaunchCounter()   # the bf16 kernel

KERNEL_DTYPES = (torch.float32, torch.bfloat16)

MAX_CHANNELS = 512    # the widest tile the kernel has: C × 32 time steps of y2


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
    in the dtype of x."""
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


def _check(x, p, valid_vec):
    b, t, c = x.shape
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"fused_residual_unit: {x.dtype}; the kernels take "
                        "f32 and bf16")
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
    """(B, T, C) residual-unit output in the dtype of x (f32 or bf16);
    kernel on CUDA, plain on the CPU."""
    b, t, c = x.shape
    v = valid_lengths(valid, b, t, x.device)
    w = _check(x, p, v)
    if x.device.type == "cpu":
        return fused_residual_unit_reference(x, p, dilation, v)
    if x.device.type != "cuda":
        raise ValueError(f"fused_residual_unit: no kernel for {x.device}")
    lib = _build.load()
    bf16 = x.dtype == torch.bfloat16
    fn, max_dilation, counter = (
        (lib.tts_fused_residual_unit_bf16,
         lib.tts_fused_residual_unit_bf16_max_dilation, launches_bf16)
        if bf16 else (lib.tts_fused_residual_unit,
                      lib.tts_fused_residual_unit_max_dilation, launches))
    if not 1 <= dilation <= max_dilation(c):
        raise ValueError(f"fused_residual_unit: dilation {dilation} at {c} "
                         "channels: the tile's halo does not fit")
    out = torch.empty_like(x)
    if out.stride() != x.stride():
        raise ValueError("fused_residual_unit: output layout differs")
    sb, st, sc = x.stride()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(
        x.data_ptr(), v.data_ptr(), w["alpha1"].data_ptr(),
        w["dw"].data_ptr(), w["dw_b"].data_ptr(), w["alpha2"].data_ptr(),
        w["pw"].data_ptr(), w["pw_b"].data_ptr(), out.data_ptr(),
        b, t, c, int(dilation), sb, st, sc, stream)
    _build.check(err, "fused_residual_unit")
    counter.add()
    return out
