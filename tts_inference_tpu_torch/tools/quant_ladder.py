"""Quantization quality ladder in audio space.

Port of ``tts_inference_tpu/tools/quant_ladder.py`` (its functions, flags
— ``--device`` for ``--cpu`` — and JSON keys). The same seeds and prompts
go through bf16 / int8 / int8 + int8 KV / int4 (group 512) / int4 (group
128) end to end (engine → vocoder), and each rung reports, against the
bf16 run:

- waveform MSE / max-diff / corr / std-ratio (free-running generation: one
  token flip cascades, so these bound the behavioural divergence, not only
  the numeric error);
- token agreement: the fraction of matching tokens and the first
  divergence;
- teacher-forced next-token agreement: bf16's own token sequence through
  each quantized model's prefill — the share of positions with the same
  argmax, and the logits' relative RMS. This isolates numeric error from
  cascades and is the number that transfers to real weights.

On the card the rungs run the port's kernels: K1 in every rung's decode,
K2 in the int8 rungs (and the int8 head of the int4 rungs), K4 in the int4
rungs, K6 in the vocoder. Weights are seeded random unless
``--model-path``; each rung re-creates them from the same seed, so the
bf16 tree is the common ancestor of every rung. At full geometry each rung
runs in a process of its own (a full-width runtime's graphs and pools are
freed only with the process); a rung that fails reports ``{"error": …}``
and the ladder goes on.

Usage:
    python -m tts_inference_tpu_torch.tools.quant_ladder --tiny --device cpu
    python -m tts_inference_tpu_torch.tools.quant_ladder --full-geometry \\
        --tokens 420 --utterances 3 --out ladder.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

LADDER = (
    # (name, dict(quantize=, weight_bits=, group=, kv_int8=, kv_int4=))
    ("bf16", dict(quantize=False)),
    ("int8", dict(quantize=True, weight_bits=8)),
    ("int8+kv8", dict(quantize=True, weight_bits=8, kv_int8=True)),
    ("int4_g512", dict(quantize=True, weight_bits=4, group=512)),
    ("int4_g128", dict(quantize=True, weight_bits=4, group=128)),
)

PROMPTS = [
    "The quick brown fox jumps over the lazy dog.",
    "Nadi ke kinare ek chhota sa gaon tha.",
    "Streaming synthesis must hold its cadence for minutes.",
]

REPO = Path(__file__).resolve().parents[2]


def _build(cfg_over: Dict, *, tiny: bool, seed: int, tokens: int,
           model_path: Optional[str] = None,
           snac_path: Optional[str] = None, device=None,
           llama_tree: Optional[Dict] = None,
           snac_tree: Optional[Dict] = None):
    """One runtime of the ladder rung (no warmup: graphs are captured on
    first use). `llama_tree` / `snac_tree`: the JAX package's pytrees in
    place of seeded weights, as ``Runtime.create`` takes them (tests)."""
    import dataclasses as dc

    from tts_inference_tpu_torch.config import Config, tiny_config
    from tts_inference_tpu_torch.runtime import Runtime

    cfg = tiny_config() if tiny else Config()
    eng = dc.replace(
        cfg.engine,
        max_input_len=64 if tiny else 128,
        max_output_len=max(tokens + 32, 128),
        max_batch_size=8 if not tiny else cfg.engine.max_batch_size,
        kv_cache_int8=bool(cfg_over.get("kv_int8")),
        kv_cache_int4=bool(cfg_over.get("kv_int4")),
        paged_kv=bool(cfg_over.get("kv_int4")),   # int4 KV requires paged
    )
    cfg = dc.replace(cfg, engine=eng)
    if cfg_over.get("group"):
        os.environ["TTS_INT4_GROUP"] = str(cfg_over["group"])
    try:
        rt = Runtime.create(
            cfg, seed=seed, warmup=False, device=device,
            model_path=model_path, snac_path=snac_path,
            quantize=bool(cfg_over.get("quantize")),
            weight_bits=int(cfg_over.get("weight_bits", 8)),
            llama_tree=llama_tree, snac_tree=snac_tree,
        )
    finally:
        os.environ.pop("TTS_INT4_GROUP", None)
    return rt


def _gen_tokens(rt, text: str, tokens: int, seed: int) -> List[int]:
    """Greedy, audio-only constrained generation: every rung emits in-range
    audio tokens, so quantization shows up as different codes — comparable
    waveforms — never as an undecodable stream."""
    from tts_inference_tpu_torch import protocol
    from tts_inference_tpu_torch.config import SamplingConfig

    prompt = rt.pipeline.build_prompt(text, "tara", force_speech=True)
    sampling = SamplingConfig(
        greedy=True, max_tokens=tokens, seed=seed,
        token_range=(protocol.TOKEN_AUDIO_BASE,
                     protocol.TOKEN_AUDIO_BASE + protocol.AUDIO_VOCAB),
    )
    return list(rt.engine.generate(prompt, sampling).token_ids)


def _vocode(rt, token_ids: List[int], noise_seed: int = 0) -> np.ndarray:
    """Batch decode: extractor → deinterleave → full vocoder pass (float)."""
    from tts_inference_tpu_torch import protocol

    ex = protocol.TokenExtractor()
    ex.started = True          # force_speech: SOS is in the prompt
    codes: List[int] = []
    for t in token_ids:
        codes.extend(ex.feed(int(t)))
    nf = len(codes) // protocol.FRAME_SIZE
    if nf == 0:
        return np.zeros(0, np.float32)
    codes = codes[: nf * protocol.FRAME_SIZE]
    l1, l2, l3 = protocol.deinterleave_frames(codes)
    return np.asarray(rt.vocoder.decode_frames(
        np.asarray(l1, np.int32), np.asarray(l2, np.int32),
        np.asarray(l3, np.int32), noise_seed=noise_seed,
    ), np.float32)


def _wave_metrics(a: np.ndarray, b: np.ndarray) -> Dict[str, float]:
    n = min(len(a), len(b))
    if n == 0:
        return {"mse": float("nan"), "max_diff": float("nan"),
                "corr": 0.0, "std_ratio": 0.0, "len_ratio": 0.0}
    x, y = a[:n], b[:n]
    mse = float(np.mean((x - y) ** 2))
    mx = float(np.max(np.abs(x - y)))
    sx, sy = float(np.std(x)), float(np.std(y))
    corr = float(np.corrcoef(x, y)[0, 1]) if sx > 0 and sy > 0 else 0.0
    return {
        "mse": mse, "max_diff": mx, "corr": corr,
        "std_ratio": (min(sx, sy) / max(sx, sy)) if max(sx, sy) else 0.0,
        "len_ratio": min(len(a), len(b)) / max(len(a), len(b)),
    }


def _token_metrics(ref: List[int], got: List[int]) -> Dict[str, float]:
    n = min(len(ref), len(got))
    div = next((i for i in range(n) if ref[i] != got[i]), n)
    match = sum(1 for i in range(n) if ref[i] == got[i])
    return {
        "first_divergence": div if div < n or len(ref) != len(got) else -1,
        "token_match_frac": match / max(n, 1),
        "len_ref": len(ref), "len_got": len(got),
    }


@torch.no_grad()
def _tf_logits(rt, token_seq: List[int],
               n_positions: int = 24) -> Optional[np.ndarray]:
    """Teacher-forced logits at `n_positions` prefix lengths of a fixed
    token sequence → (n_positions, V) on the host: one prefill of the whole
    sequence per prefix length (prefill returns the last valid position's
    logits)."""
    from tts_inference_tpu_torch.models import llama

    t = len(token_seq)
    if t < 8:
        return None
    dev = rt.device
    toks = torch.tensor([list(token_seq)], dtype=torch.int32, device=dev)
    cfg = rt.config.model
    params = rt.engine.core.params
    lens = sorted({int(x) for x in np.linspace(8, t, n_positions)})
    rows = []
    for ln in lens:
        cache = llama.init_kv_cache(cfg, 1, ((t + 127) // 128) * 128,
                                    device=dev)
        lg, _ = llama.prefill(params, cfg, toks,
                              torch.tensor([ln], dtype=torch.int32,
                                           device=dev), cache)
        rows.append(lg.float().cpu().numpy().reshape(-1))
    return np.stack(rows)


def _teacher_forced(lg_q: Optional[np.ndarray],
                    lg_r: Optional[np.ndarray]) -> Dict[str, float]:
    """A rung's teacher-forced logits against the cached bf16 ones (on the
    host: the bf16 runtime is gone before any other rung boots)."""
    if lg_q is None or lg_r is None:
        return {}
    agree = float((lg_q.argmax(-1) == lg_r.argmax(-1)).mean())
    rms = float(np.sqrt(np.mean((lg_q - lg_r) ** 2))
                / (np.sqrt(np.mean(lg_r ** 2)) + 1e-9))
    return {"tf_argmax_agree": agree, "tf_logit_rel_rms": rms,
            "tf_positions": int(lg_q.shape[0])}


def run_rung(name: str, over: Dict, *, tiny: bool, tokens: int,
             utterances: int, seed: int, ref_path: str,
             model_path: Optional[str] = None,
             snac_path: Optional[str] = None, device=None) -> Dict:
    """One rung end to end. bf16 writes the reference npz (tokens, waves,
    teacher-forcing logits); the other rungs read it. The entry also has
    the kernels the rung launched (``launches``)."""
    from tts_inference_tpu_torch.ops._build import (launch_counts,
                                                    launches_since)

    prompts = (PROMPTS * ((utterances + len(PROMPTS) - 1) // len(PROMPTS))
               )[:utterances]
    t0 = time.perf_counter()
    before = launch_counts()
    rt = _build(over, tiny=tiny, seed=seed, tokens=tokens,
                model_path=model_path, snac_path=snac_path, device=device)
    per_utt = []
    if name == "bf16":
        ref = {}
        for i, text in enumerate(prompts):
            tok = _gen_tokens(rt, text, tokens, seed=seed + i)
            wav = _vocode(rt, tok, noise_seed=seed + i)
            ref[f"tokens_{i}"] = np.asarray(tok, np.int64)
            ref[f"wave_{i}"] = wav
            per_utt.append({"tokens": len(tok),
                            "audio_s": len(wav) / 24000.0})
        tf = _tf_logits(rt, list(ref["tokens_0"]))
        if tf is not None:
            # omitted rather than stored as None (an object array, which
            # np.load with allow_pickle=False refuses)
            ref["tf_logits"] = tf
        np.savez(ref_path, **ref)
        return {"utterances": per_utt,
                "build_s": round(time.perf_counter() - t0, 1),
                "launches": launches_since(before)}
    ref = np.load(ref_path)
    for i, text in enumerate(prompts):
        tok = _gen_tokens(rt, text, tokens, seed=seed + i)
        wav = _vocode(rt, tok, noise_seed=seed + i)
        m = _wave_metrics(ref[f"wave_{i}"], wav)
        m.update(_token_metrics([int(t) for t in ref[f"tokens_{i}"]], tok))
        per_utt.append(m)
    entry: dict = {"utterances": per_utt,
                   "build_s": round(time.perf_counter() - t0, 1)}
    if "tf_logits" in ref.files:
        entry.update(_teacher_forced(
            _tf_logits(rt, [int(t) for t in ref["tokens_0"]]),
            ref["tf_logits"]))
    for k in ("mse", "max_diff", "corr", "token_match_frac"):
        entry[k] = round(float(np.median([u[k] for u in per_utt])), 6)
    entry["launches"] = launches_since(before)
    return entry


def run_ladder(*, tiny: bool, tokens: int, utterances: int, seed: int,
               rungs=LADDER, model_path: Optional[str] = None,
               snac_path: Optional[str] = None,
               subprocess_rungs: bool = False, device=None) -> Dict:
    import tempfile

    results: Dict[str, dict] = {}
    ref_path = os.path.join(tempfile.mkdtemp(prefix="quant_ladder_"),
                            "ref.npz")
    for name, over in rungs:
        if subprocess_rungs:
            import subprocess as sp

            cmd = [sys.executable, "-m",
                   "tts_inference_tpu_torch.tools.quant_ladder",
                   "--rung", name, "--ref-path", ref_path,
                   "--tokens", str(tokens),
                   "--utterances", str(utterances), "--seed", str(seed)]
            cmd.append("--tiny" if tiny else "--full-geometry")
            if device:
                cmd += ["--device", str(device)]
            if model_path:
                cmd += ["--model-path", model_path]
            if snac_path:
                cmd += ["--snac-path", snac_path]
            r = sp.run(cmd, capture_output=True, text=True, cwd=REPO)
            if r.returncode != 0:
                entry = {"error": r.stderr[-2000:]}
            else:
                entry = json.loads(r.stdout.strip().splitlines()[-1])
        else:
            entry = run_rung(name, over, tiny=tiny, tokens=tokens,
                             utterances=utterances, seed=seed,
                             ref_path=ref_path, model_path=model_path,
                             snac_path=snac_path, device=device)
        results[name] = entry
        print(f"[ladder] {name}: "
              f"{json.dumps({k: v for k, v in entry.items() if k != 'utterances'})}",
              file=sys.stderr, flush=True)
    return {"tokens": tokens, "utterances": utterances, "seed": seed,
            "tiny": tiny, "rungs": results}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; an error when there "
                         "is none — ask for the CPU with --device cpu)")
    ap.add_argument("--full-geometry", action="store_true",
                    help="3B dims with synthetic weights (card run)")
    ap.add_argument("--tokens", type=int, default=140)
    ap.add_argument("--utterances", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip", default="",
                    help="comma-separated rung names to skip")
    ap.add_argument("--model-path", default=None,
                    help="real checkpoint dir: the fidelity gate on real "
                         "weights")
    ap.add_argument("--snac-path", default=None)
    ap.add_argument("--rung", default=None,
                    help="internal: run ONE rung in this process")
    ap.add_argument("--ref-path", default=None,
                    help="internal: bf16 reference npz path")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    tiny = args.tiny or not (args.full_geometry or args.model_path)
    if args.rung:
        over = dict(LADDER)[args.rung]
        entry = run_rung(args.rung, over, tiny=tiny, tokens=args.tokens,
                         utterances=args.utterances, seed=args.seed,
                         ref_path=args.ref_path,
                         model_path=args.model_path,
                         snac_path=args.snac_path, device=args.device)
        print(json.dumps(entry, default=str))
        return 0
    skip = {s for s in args.skip.split(",") if s}
    rungs = tuple((n, o) for n, o in LADDER if n not in skip)
    out = run_ladder(tiny=tiny, tokens=args.tokens,
                     utterances=args.utterances, seed=args.seed,
                     rungs=rungs, model_path=args.model_path,
                     snac_path=args.snac_path,
                     subprocess_rungs=not tiny, device=args.device)
    js = json.dumps(out, indent=2, default=str)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js)
    print(js)
    return 0


if __name__ == "__main__":
    sys.exit(main())
