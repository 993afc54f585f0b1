"""SNAC-equivalent neural vocoder (codes → 24 kHz PCM), f32, bf16 or float16.

Port of ``tts_inference_tpu/models/snac.py``:

    3 hierarchical codebooks → embed + 1x1 out-projection, nearest-upsample,
    sum → depthwise+pointwise input conv → 4 × [Snake, ConvTranspose
    (×8/×8/×4/×2), position-addressed noise, 3 residual units]
    → Snake → Conv(→1) → tanh

The public functions keep the JAX package's (B, T, C) layout; inside,
``decode_latent`` keeps activations channel-first (B, C, T) for cuDNN and
hands the residual units to K6 (``ops.vocoder.fused_residual_unit``, which
reads the channel-first storage through strides) — the hand-written kernel
on CUDA for every unit (f32, or the 16-bit body under
``SnacConfig.dtype="bfloat16"`` / ``"float16"``), its plain version on the
CPU. As in the JAX package, the compute dtype is
``SnacConfig.dtype``: ``SnacDecoder`` casts every f32 parameter to it once,
the position noise stays f32 and its product is cast back, and the PCM is
f32 whatever the dtype.

``SnacDecoder`` makes every vocoder call of the serve path — the vocode
worker's batched window decode and the fused first-chunk decode — as one
launch: on a CUDA device a CUDA graph per geometry (row bucket and frame
bucket; first-chunk geometry and batch), captured at warmup or, counted as
a late capture, on first use, the JAX package's ``jax.jit`` of the decode
per shape. Decodes longer than ``graph_max_frames`` (whole utterances) run
eagerly and are counted.

TF32 is turned off for the whole process when this module is imported:
``torch.backends.cudnn.allow_tf32`` is True by default in torch, and a TF32
convolution (about three decimal digits) would break the vocoder's f32
parity with the JAX package and with K6.

The noise is a pure function of (seed, block, absolute position), so a
windowed streaming decode equals a batch decode on interior samples.
uint32 arithmetic is emulated in int64 masked to 32 bits.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import math
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tts_inference_tpu_torch.config import SnacConfig
from tts_inference_tpu_torch.ops import _build
from tts_inference_tpu_torch.ops.vocoder import (fused_residual_unit, snake,
                                                 valid_lengths)
from tts_inference_tpu_torch.utils import copy_async, cuda_graphs, to_numpy

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

__all__ = ["conv1d", "conv_transpose1d", "snake", "position_noise",
           "codes_to_latent", "decode_latent", "decode_codes", "to_pcm16",
           "SnacDecoder"]

log = logging.getLogger("tts_inference_tpu_torch.vocoder")

Params = Dict
_M32 = 0xFFFFFFFF
# SnacConfig.dtype → the compute dtype (the JAX package's table)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


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
        if stride > 1:   # nearest-neighbour upsample, device work only
            b, d, n = proj.shape
            proj = proj[..., None].expand(b, d, n, stride).reshape(
                b, d, n * stride)
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


def _upsample(x: torch.Tensor, up: Params, rate: int) -> torch.Tensor:
    """A decoder block's transposed convolution, channel-first. Torch's CPU
    float16 transposed convolution rounds by the input's length (one float16
    step apart between a window and a whole utterance: 8 PCM16 LSB at the
    output), so on the CPU float16 takes the same function as a convolution
    of the input with zeros stuffed between its steps (the flipped kernel,
    K − 1 − padding on each side), which does not."""
    pad, out_pad = math.ceil(rate / 2), rate % 2
    if x.dtype != torch.float16 or x.device.type != "cpu":
        return F.conv_transpose1d(x, up["w"], up["b"], stride=rate,
                                  padding=pad, output_padding=out_pad)
    b, c, t = x.shape
    k = up["w"].shape[-1]
    z = x.new_zeros(b, c, (t - 1) * rate + 1 + out_pad)
    z[:, :, 0:(t - 1) * rate + 1:rate] = x
    z = F.pad(z, (k - 1 - pad, k - 1 - pad))
    return F.conv1d(z, up["w"].transpose(0, 1).flip(-1), up["b"])


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
        x = _upsample(x, bp["up"], rate)
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


def _cast_tree(tree, dtype):
    """Every f32 tensor of a parameter tree cast to `dtype` (ints, None and
    other dtypes as they are)."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_tree(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32:
        return tree.to(dtype)
    return tree


def _census_name(key) -> str:
    if key[0] == "decode":
        return f"capture_vocoder_r{key[1]}_f{key[2]}"
    return "capture_first_chunk_b{}_c{}_f{}_e{}".format(*key[1:])


@dataclasses.dataclass
class SnacDecoder:
    """Decode at bucketed frame counts, several windows per device call.

    Buckets bound the shapes cuDNN sees (its algorithm choice is per shape)
    and match the JAX package's padding, so both decode the same windows.

    Every call goes through :meth:`run`: on a CUDA device with ``graphs`` a
    CUDA graph per key — ("decode", row bucket, frame bucket) for the
    batched window decode up to ``graph_max_frames``, ("first_chunk",
    batch, n_codes, nf, emit) for the fused first chunk — replayed over
    fixed input tensors; the CPU, ``graphs=False`` and longer decodes run
    the same bodies eagerly. A call's inputs, its replay and its output's
    device→host copy are enqueued under one lock: the graphs share one
    memory pool (a replay may overwrite another graph's outputs), and the
    scheduler thread and the vocode worker both call, on one stream.
    """

    params: Params
    cfg: SnacConfig
    frame_buckets: Tuple[int, ...] = (8, 16, 32, 64, 128, 256, 512, 1024)
    use_noise: Optional[bool] = None
    graphs: bool = True
    # the largest frame bucket a graph is kept for: the streaming window's
    # (Runtime sets it from StreamConfig); whole-utterance decodes, up to
    # 4608/7 frames, would need graphs of hundreds of MB each
    graph_max_frames: int = 16

    def __post_init__(self):
        if self.cfg.dtype not in DTYPES:
            raise ValueError(f"SnacConfig.dtype {self.cfg.dtype!r}: the "
                             f"vocoder computes in one of {sorted(DTYPES)}")
        # cast ONCE here, as the JAX package does, so the weights stay in
        # the compute dtype in device memory
        self.dtype = DTYPES[self.cfg.dtype]
        if self.dtype != torch.float32:
            self.params = _cast_tree(self.params, self.dtype)
        self.device = self.params["quantizer"][0]["codebook"].device
        self.use_graphs = self.graphs and self.device.type == "cuda"
        self._graphs: Dict[tuple, cuda_graphs.Graph] = {}
        self._static: Dict[tuple, Dict[str, torch.Tensor]] = {}
        self._pool = None
        self._lock = threading.Lock()
        self._warming = False
        # the census: name → capture ms (on the CPU, or without graphs, the
        # first eager call's ms: the keys the card would capture)
        self.graph_census_ms: Dict[str, float] = {}
        self.late_captures = 0           # captured outside warmup
        self.launches = collections.Counter()   # calls by kind
        self.replays = collections.Counter()    # of them graph replays
        self.eager_calls = 0   # decodes beyond graph_max_frames

    def bucket_frames(self, n_frames: int) -> int:
        for b in self.frame_buckets:
            if n_frames <= b:
                return b
        return n_frames

    # -- launches: CUDA-graph replay or eager ----------------------------------

    def run(self, key: tuple, body: Callable, **inputs) -> tuple:
        """One vocoder call: `body(**inputs)` → output tensors, whose
        device→host copies are returned (``HostCopy`` each). `inputs` are
        CPU tensors (host data) or device tensors. With graphs, the inputs
        are copied into the key's fixed tensors (host data from pinned
        memory, without blocking) and the key's graph replays; `body` is
        read only when the key is captured."""
        graphable = key[0] != "decode" or key[2] <= self.graph_max_frames
        with self._lock:
            self.launches[key[0]] += 1
            if not (self.use_graphs and graphable):
                if not graphable:
                    self.eager_calls += 1
                t0 = time.perf_counter()
                outs = body(**{k: v.to(self.device)
                               for k, v in inputs.items()})
                name = _census_name(key)
                if graphable and name not in self.graph_census_ms:
                    self.graph_census_ms[name] = \
                        (time.perf_counter() - t0) * 1e3
                return copy_async(*outs)
            static = self._put(key, inputs)
            graph = self._graphs.get(key) or self._capture(key, body, static)
            self.replays[key[0]] += 1
            return copy_async(*graph.replay())

    def _put(self, key, inputs) -> Dict[str, torch.Tensor]:
        """Copy a call's inputs into the key's fixed tensors, in stream
        order."""
        static = self._static.get(key)
        if static is None:
            static = self._static[key] = {
                k: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                for k, v in inputs.items()}
        for k, v in inputs.items():
            if v.device.type == "cpu":
                v = v.pin_memory()
            static[k].copy_(v, non_blocking=True)
        return static

    def _capture(self, key, body, static) -> cuda_graphs.Graph:
        """Capture `body` over the key's fixed tensors into a CUDA graph of
        the decoder's memory pool, after one eager pass in this thread (not
        counted: cuDNN's plans, the kernels' one-time attributes and the
        workspace come into being outside the capture); a capture that
        fails raises."""
        with cuda_graphs.CAPTURE_LOCK:
            with _build.record_launches():
                body(**static)
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            # thread_local: the engine's threads keep launching meanwhile
            with _build.record_launches() as launches, torch.cuda.graph(
                    graph, pool=self._pool,
                    capture_error_mode="thread_local"):
                outputs = body(**static)
            ms = (time.perf_counter() - t0) * 1e3
        self._graphs[key] = g = cuda_graphs.Graph(graph, outputs, launches)
        name = _census_name(key)
        self.graph_census_ms[name] = ms
        if not self._warming:
            self.late_captures += 1
            log.warning("captured %s on first use (%.0f ms): the warmup "
                        "did not reach it", name, ms)
        return g

    @contextlib.contextmanager
    def warming(self):
        """Captures inside the block are the warmup's, not late ones."""
        prev, self._warming = self._warming, True
        try:
            yield
        finally:
            self._warming = prev

    def warmup_keys(self, rows: int) -> list:
        """The batched decode's graph keys for up to `rows` windows: every
        row bucket (powers of two) and every frame bucket up to
        graph_max_frames."""
        rbs = [1]
        while rbs[-1] < rows:
            rbs.append(2 * rbs[-1])
        nbs = [b for b in self.frame_buckets if b <= self.graph_max_frames]
        return [("decode", rb, nb) for rb in rbs for nb in nbs]

    def warmup_graphs(self, rows: int) -> dict:
        """Capture the batched decode of every key of ``warmup_keys(rows)``
        (a call of zero codes each; without graphs on the card, the call
        runs once). The CPU has nothing to capture or set up: no call runs,
        and its census fills as calls are made. Returns the census."""
        if self.device.type == "cpu":
            return self.census()
        with self.warming():
            for key in self.warmup_keys(rows):
                if _census_name(key) in self.graph_census_ms:
                    continue    # captured already (run, on the CPU)
                _, rb, nb = key
                self.decode_frames_batch(
                    [(np.zeros(nb, np.int64), np.zeros(2 * nb, np.int64),
                      np.zeros(4 * nb, np.int64))] * rb,
                    first_frames=[0] * rb, noise_seeds=[0] * rb)
        return self.census()

    def census(self) -> dict:
        """The vocoder's graph census under the engine census's names with
        a ``vocoder_`` prefix, and its calls."""
        return {"vocoder_graphs_compiled": len(self.graph_census_ms),
                "vocoder_graph_census_ms": dict(self.graph_census_ms),
                "vocoder_late_captures": self.late_captures,
                "vocoder_launches": dict(self.launches),
                "vocoder_replays": dict(self.replays),
                "vocoder_eager_calls": self.eager_calls}

    # -- the host API ------------------------------------------------------------

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
        returns a handle for :meth:`decode_frames_batch_fetch`. The codes,
        noise seeds, latent offsets and valid lengths travel as ONE host
        array of (rows, 7·frames + 3) int64."""
        n_rows = len(layers)
        ns = [int(l1.shape[-1]) for l1, _, _ in layers]
        nb = self.bucket_frames(max(ns))
        rb = 1
        while rb < n_rows:
            rb *= 2
        lat = max(self.cfg.vq_strides)
        packed = np.zeros((rb, 7 * nb + 3), np.int64)
        for r, lay in enumerate(layers):
            for (lo, mult), x in zip(((0, 1), (nb, 2), (3 * nb, 4)), lay):
                x = np.asarray(x, dtype=np.int64)
                packed[r, lo: lo + x.shape[-1]] = x
            packed[r, 7 * nb:] = (int(noise_seeds[r]) & _M32,
                                  first_frames[r] * lat, ns[r] * lat)
        (host,) = self.run(("decode", rb, nb), self._decode_body(nb),
                           packed=torch.from_numpy(packed))
        return host, ns

    def _decode_body(self, nb: int) -> Callable:
        def body(packed):
            meta = packed[:, 7 * nb:]
            codes = (packed[:, :nb], packed[:, nb: 3 * nb],
                     packed[:, 3 * nb: 7 * nb])
            return (decode_codes(self.params, self.cfg, codes,
                                 noise_seed=meta[:, 0],
                                 latent_offset=meta[:, 1],
                                 use_noise=self.use_noise,
                                 valid_latent=meta[:, 2]),)
        return body

    def decode_frames_batch_fetch(self, handle) -> list:
        """Blocking half: host audio rows for a launched batch."""
        host, ns = handle
        spf = self.cfg.samples_per_frame
        audio = to_numpy(host)
        return [audio[r, : ns[r] * spf] for r in range(len(ns))]
