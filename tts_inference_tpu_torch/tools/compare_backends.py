"""Backend A/B parity harness: the serving engine against an eager twin.

Port of ``tts_inference_tpu/tools/compare_backends.py`` (its functions,
flags — ``--device`` for ``--cpu`` — and JSON keys). The two backends are
the engine as it serves (on the card: replayed CUDA graphs, sampling on the
device, a KV window picked from the buckets) and a plain eager per-step
argmax loop over the same weights (``models/llama.prefill`` /
``decode_one`` with the sliced head's ``logits_base``). The report names
the first mismatching token; the report also has both token lists
(``engine_tokens``, ``eager_tokens``). On the CPU the two agree exactly.
On the card in bf16 the two run other windows and prefill shapes (another
summation order), so a greedy token can flip where the top-2 logits nearly
tie; ``chip_smoke.py`` accepts a mismatch only at such a gap.

    python -m tts_inference_tpu_torch.tools.compare_backends --tiny \\
        --device cpu --text "parity check" --max-tokens 48

Exits 1 on a mismatch.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Sequence

import torch


@torch.no_grad()
def eager_greedy(
    params, model_cfg, prompt_ids: Sequence[int], max_tokens: int,
    eos_id: int, logits_base: int = 0,
) -> List[int]:
    """Plain per-step argmax loop — no graphs, no sampler, no engine — on the
    device of the weights.

    ``logits_base`` mirrors the engine's sliced-head setting
    (EngineConfig.sliced_head, protocol.HEAD_SLICE_BASE) so the twin argmaxes
    over the same candidate rows as the serving decode path.
    """
    from tts_inference_tpu_torch.models import llama

    dev = params["final_norm"].device
    cache = llama.init_kv_cache(
        model_cfg, 1, len(prompt_ids) + max_tokens + 8, device=dev)
    logits, cache = llama.prefill(
        params, model_cfg,
        torch.tensor([list(prompt_ids)], dtype=torch.int32, device=dev),
        torch.tensor([len(prompt_ids)], dtype=torch.int32, device=dev),
        cache, logits_base=logits_base,
    )
    out: List[int] = []
    tok = (logits_base + torch.argmax(logits, -1)).to(torch.int32)
    for _ in range(max_tokens):
        out.append(int(tok[0]))
        if out[-1] == eos_id:
            break
        logits, cache = llama.decode_one(
            params, model_cfg, tok, cache, logits_base=logits_base)
        tok = (logits_base + torch.argmax(logits, -1)).to(torch.int32)
    return out


def first_mismatch(a: Sequence[int], b: Sequence[int]) -> int:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return -1 if len(a) == len(b) else min(len(a), len(b))


def compare(runtime, text: str, voice: str, max_tokens: int) -> Dict:
    from tts_inference_tpu_torch.config import SamplingConfig

    prompt = runtime.pipeline.build_prompt(text, voice)
    eng = runtime.engine

    t0 = time.perf_counter()
    res = eng.generate(
        prompt,
        SamplingConfig(greedy=True, max_tokens=max_tokens,
                       repetition_penalty=1.0),
    )
    engine_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    eager = eager_greedy(
        eng.core.params, eng.core.model_cfg, prompt, max_tokens, eng.eos_id,
        logits_base=eng.core.logits_base,
    )
    eager_s = time.perf_counter() - t0

    mismatch = first_mismatch(res.token_ids, eager)
    return {
        "prompt_tokens": len(prompt),
        "engine": {
            "tokens": len(res.token_ids),
            "time_s": round(engine_s, 3),
            "tokens_per_sec": round(len(res.token_ids) / engine_s, 1),
        },
        "eager": {
            "tokens": len(eager),
            "time_s": round(eager_s, 3),
            "tokens_per_sec": round(len(eager) / eager_s, 1),
        },
        "match": mismatch == -1,
        "first_mismatch": mismatch,
        "engine_head": res.token_ids[:10],
        "eager_head": eager[:10],
        "engine_tokens": list(res.token_ids),
        "eager_tokens": eager,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--text", default="parity check")
    ap.add_argument("--voice", default="tara")
    ap.add_argument("--max-tokens", type=int, default=48)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; an error when there "
                         "is none — ask for the CPU with --device cpu)")
    ap.add_argument("--model-path")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from tts_inference_tpu_torch.config import Config, tiny_config
    from tts_inference_tpu_torch.runtime import Runtime

    rt = Runtime.create(
        tiny_config() if args.tiny else Config(),
        model_path=args.model_path, seed=args.seed, warmup=False,
        device=args.device,
    )
    report = compare(rt, args.text, args.voice, args.max_tokens)
    print(json.dumps(report, indent=2))
    return 0 if report["match"] else 1


if __name__ == "__main__":
    sys.exit(main())
