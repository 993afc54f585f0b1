"""Windowed vs batch decode of the bf16 vocoder: where it differs, and what
making it exact would cost.

    python -m tts_inference_tpu_torch.tools.vocoder_exactness     # the card
    python -m tts_inference_tpu_torch.tools.vocoder_exactness --tiny \\
        --device cpu

Two parts, one JSON line each:

- ``ops``: every library convolution of the decoder (the input pointwise
  conv, each block's transposed conv, noise projection, a depthwise and a
  pointwise conv of its residual units, the output conv), on seeded random
  input at a streaming window's length and at 4× it (a batch decode's), in
  bf16 and in f32 rounded once to bf16: how many outputs of the window's
  interior differ between the two lengths;
- ``variants``: 40 frames of seeded codes through the full decoder with the
  transposed convolutions in bf16 (the serve path), in f32 rounded once,
  and in TF32 rounded once (bf16 values are exact in TF32): windowed
  (``LookaheadStreamingDecoder``, default ``StreamConfig``) against one
  batch decode in PCM16, and the device ms of one replayed 8-row, 16-frame
  call (CUDA events around replays) on the card.

The weights are seeded random (``weights.init_snac_params``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys

import numpy as np
import torch
import torch.nn.functional as F


def _ops(cfg, params, dev) -> dict:
    """Per library op: outputs of a window's interior that differ between
    a window-length and a 4×-length call, in bf16 and in f32 rounded once."""
    dp = params["decoder"]
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}

    def compare(name, fn, cin, t_win, interior):
        x = torch.randn(1, cin, 4 * t_win, generator=g, device=dev)
        row = {}
        for mode, dt in (("bf16", torch.bfloat16), ("f32_rounded", torch.float32)):
            xb = x.bfloat16().to(dt)
            full = fn(xb, dt).bfloat16()[..., interior[0]: interior[1]]
            win = fn(xb[..., :t_win].contiguous(), dt).bfloat16()[
                ..., interior[0]: interior[1]]
            row[mode] = {"differing": int((full != win).sum()),
                         "of": full.numel()}
        out[name] = row

    def w(t, dt):
        return t.bfloat16().to(dt)   # the bf16 weights, exactly

    t = 16 * max(cfg.vq_strides)   # the latent steps of a 16-frame window
    compare("in_pw", lambda x, dt: F.conv1d(
        x, w(dp["in"]["pw"]["w"], dt), w(dp["in"]["pw"]["b"], dt)),
        cfg.latent_dim, t, (0, t - 4))
    cin = cfg.decoder_dim
    for i, (bp, rate) in enumerate(zip(dp["blocks"], cfg.decoder_rates)):
        compare(f"up{i}", lambda x, dt, bp=bp, rate=rate: F.conv_transpose1d(
            x, w(bp["up"]["w"], dt), w(bp["up"]["b"], dt), stride=rate,
            padding=math.ceil(rate / 2), output_padding=rate % 2),
            cin, t, (0, (t - 2) * rate))
        cin //= 2
        t *= rate
        if bp["noise_lin"] is not None:
            compare(f"noise_lin{i}", lambda x, dt, bp=bp: F.conv1d(
                x, w(bp["noise_lin"]["w"], dt)), cin, t, (0, t - 4))
        rp = bp["res"][2]
        compare(f"dw{i}", lambda x, dt, rp=rp: F.conv1d(
            x, w(rp["conv1"]["w"], dt), w(rp["conv1"]["b"], dt), padding=27,
            dilation=9, groups=x.shape[1]), cin, t, (0, t - 40))
        compare(f"pw{i}", lambda x, dt, rp=rp: F.conv1d(
            x, w(rp["conv2"]["w"], dt), w(rp["conv2"]["b"], dt)), cin, t,
            (0, t - 4))
    compare("out_conv", lambda x, dt: F.conv1d(
        x, w(dp["out_conv"]["w"], dt), w(dp["out_conv"]["b"], dt),
        padding=3), cin, t, (0, t - 8))
    return out


def _variants(cfg, params, dev) -> dict:
    """Windowed vs batch PCM16 and one replayed call's device ms with the
    transposed convolutions in bf16, in f32 rounded once, in TF32 rounded
    once."""
    from tts_inference_tpu_torch import protocol
    from tts_inference_tpu_torch.config import StreamConfig
    from tts_inference_tpu_torch.models import snac
    from tts_inference_tpu_torch.streaming.lookahead import \
        LookaheadStreamingDecoder

    rng = np.random.default_rng(0)
    frames = rng.integers(0, cfg.codebook_size, (40, protocol.FRAME_SIZE))
    codes = [int(c) for c in (frames + np.asarray(
        protocol.POSITION_OFFSETS)[None]).reshape(-1)]
    l1, l2, l3 = protocol.deinterleave_frames(np.asarray(codes, np.int32))
    layers = [tuple(rng.integers(0, cfg.codebook_size, m * 16)
                    for m in (1, 2, 4)) for _ in range(8)]
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    plain = F.conv_transpose1d
    out = {}
    for mode in ("bf16", "f32_rounded", "tf32_rounded"):
        def conv_t(x, w, b=None, mode=mode, **kw):
            if mode == "bf16" or x.dtype != torch.bfloat16:
                return plain(x, w, b, **kw)
            prev = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = mode == "tf32_rounded"
            try:
                return plain(x.float(), w.float(),
                             None if b is None else b.float(),
                             **kw).bfloat16()
            finally:
                torch.backends.cudnn.allow_tf32 = prev

        F.conv_transpose1d = conv_t
        try:
            dec = snac.SnacDecoder(params, bf16)
            with dec.warming():
                dec.warmup_graphs(8)
                batch = dec.decode_frames(l1, l2, l3)
                la = LookaheadStreamingDecoder(dec, StreamConfig(), 0)
                parts = []
                for i in range(0, len(codes), protocol.FRAME_SIZE):
                    la.feed(codes[i: i + protocol.FRAME_SIZE])
                    parts.append(la.poll())
                parts.append(la.flush())
                windowed = np.concatenate([p for p in parts if p is not None])
                dec.decode_frames_batch(layers, first_frames=[0] * 8,
                                        noise_seeds=list(range(8)))
        finally:
            F.conv_transpose1d = plain
        a, b = (snac.to_pcm16(torch.from_numpy(x)).numpy().astype(np.int32)
                for x in (batch, windowed))
        row = {"windowed_vs_batch_pcm16_max": int(np.abs(a - b).max()),
               "samples_differing": int((a != b).sum()), "samples": len(a)}
        if dev.type == "cuda":
            graph = dec._graphs[("decode", 8, 16)].graph
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                graph.replay()
            end.record()
            torch.cuda.synchronize()
            row["call_ms_8_rows_16_frames"] = start.elapsed_time(end) / 20
        out[mode] = row
        del dec
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; an error when there "
                         "is none)")
    args = ap.parse_args(argv)

    from tts_inference_tpu_torch import weights
    from tts_inference_tpu_torch.config import SnacConfig, tiny_config
    from tts_inference_tpu_torch.runtime import default_device

    dev = torch.device(args.device) if args.device else default_device()
    cfg = tiny_config().snac if args.tiny else SnacConfig()
    params = weights.init_snac_params(cfg, args.seed, dev)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    with torch.no_grad():
        print(json.dumps({"device": card, "ops": _ops(cfg, params, dev)}),
              flush=True)
        print(json.dumps({"device": card,
                          "variants": _variants(cfg, params, dev)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
