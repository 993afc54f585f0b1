"""Fine-tune CLI: LoRA (or full) training loop with periodic sampling.

Port of ``tts_inference_tpu/training/finetune.py``. The reference training
loop (`pretrained_base/modal_finetune_base.py`: 4-bit base + LoRA r=16
α=32, HF Trainer fp16, 100 steps, SamplingCallback every 20 steps, save +
push) on one device: the eager train step of ``train_step.py`` (AdamW +
cosine schedule on ``torch.optim``), step checkpoints with retention
(``checkpoint.CheckpointManager``), a greedy sample every N steps, and a
weight-space merge command (`merge_and_unload` analog) writing a serving
checkpoint that ``Runtime.create(model_path=…)`` and ``cli serve
--model-path`` boot.

    # tiny end-to-end demo (synthetic corpus, CPU)
    python -m tts_inference_tpu_torch.training.finetune train --tiny \\
        --device cpu --steps 10 --out-dir /tmp/ft
    python -m tts_inference_tpu_torch.training.finetune merge --tiny \\
        --device cpu --adapter-dir /tmp/ft --out-dir /tmp/merged
    python -m tts_inference_tpu_torch.cli serve --tiny --device cpu \\
        --model-path /tmp/merged

Without ``--device`` (or the JAX CLI's ``--cpu``) both commands run on
``cuda`` and fail when there is none. The base is ``--model-path`` (an HF
dir, through the port's loader and its tokenizer) or seeded random weights
drawn on the device; torch draws other numbers on the CPU than on the card,
so the adapter records the random base's seed and device type and
``merge`` refuses another. A LoRA run with ``--extend-vocab`` records the
seed of the new embedding rows, which ``merge`` draws again, and ``merge``
refuses another seed. The merged directory's metadata says ``"kind":
"merged"`` (the JAX package's adapter kind overwrites it: ROADMAP.md Queue
3) and carries the model config; the base dir's tokenizer files are copied
beside it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import time

import numpy as np
import torch


def _device(args) -> torch.device:
    from tts_inference_tpu_torch.runtime import default_device

    if args.cpu:
        return torch.device("cpu")
    return torch.device(args.device) if args.device else default_device()


def _base(args, dev: torch.device) -> dict:
    """Which base weights a run starts from: a checkpoint dir, or seeded
    random weights, which differ by device type."""
    if args.model_path:
        return {"model_path": os.path.abspath(args.model_path)}
    return {"seed": args.seed, "device": dev.type}


def _model_setup(args, dev: torch.device):
    from tts_inference_tpu_torch.config import Config, tiny_config
    from tts_inference_tpu_torch.runtime import load_model, model_tokenizer

    cfg = tiny_config() if args.tiny else Config()
    params, cfg = load_model(cfg, dev, model_path=args.model_path,
                             seed=args.seed)
    return cfg, params, model_tokenizer(args.model_path)


def _records(args, rng):
    from tts_inference_tpu_torch.training import data as D

    if args.dataset:
        if os.path.isdir(args.dataset):
            # HF-datasets on-disk dir (arrow/parquet) — the reference's
            # load_dataset path (modal_finetune_base.py:73)
            return D.load_dataset_dir(args.dataset)
        return D.load_jsonl(args.dataset)
    return D.synthetic_records(rng, n=args.synthetic_records)


def cmd_train(args) -> int:
    from tts_inference_tpu_torch.training import data as D
    from tts_inference_tpu_torch.training import lora as L
    from tts_inference_tpu_torch.training.checkpoint import (
        CheckpointManager, save_params)
    from tts_inference_tpu_torch.training.train_step import (
        init_train_state, make_optimizer, make_train_step)

    dev = _device(args)
    cfg, params, tokenizer = _model_setup(args, dev)
    rng = np.random.default_rng(args.seed)
    records = _records(args, rng)

    # tag mining → vocab extension (reference: add_special_tokens + resize)
    tags = D.mine_tags([r["text"] for r in records])
    extended = bool(tags and args.extend_vocab)
    if extended:
        params = D.extend_vocab(params, len(tags), seed=args.seed)
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(
                cfg.model, vocab_size=cfg.model.vocab_size + len(tags)
            )
        )
        print(f"mined {len(tags)} tags, vocab extended to "
              f"{cfg.model.vocab_size}")

    scale = L.lora_scale(args.lora_r, args.lora_alpha)
    optimizer = make_optimizer(args.lr, args.steps)
    if args.full_finetune:
        trainable = params
        step_fn = make_train_step(cfg.model, optimizer)
    else:
        gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
        trainable = L.init_lora(gen, cfg.model, params, r=args.lora_r,
                                alpha=args.lora_alpha)
        step_fn = make_train_step(
            cfg.model, optimizer, base_params=params, lora_scale=scale
        )
    state = init_train_state(trainable, optimizer)

    os.makedirs(args.out_dir, exist_ok=True)
    mgr = CheckpointManager(os.path.join(args.out_dir, "ckpts"),
                            max_to_keep=2)
    losses, step_ms, tokens_seen = [], [], 0
    t0 = time.time()
    step = 0
    while step < args.steps:
        n_before = step
        for tokens, lens in D.batches(
            tokenizer, records, args.batch_size, args.max_len,
            shuffle_rng=rng,
        ):
            t1 = time.perf_counter()
            state, loss = step_fn(state, tokens, lens)
            losses.append(float(loss))      # waits for the step
            step_ms.append((time.perf_counter() - t1) * 1e3)
            tokens_seen += int(lens.sum())
            step += 1
            if step % args.log_every == 0 or step == args.steps:
                print(f"step {step}/{args.steps} loss {losses[-1]:.4f} "
                      f"({(time.time() - t0):.1f}s)", flush=True)
            if args.save_every and step % args.save_every == 0:
                mgr.save(step, state.params)
            if args.sample_every and step % args.sample_every == 0:
                _sample(cfg, params, state.params, tokenizer, args, scale,
                        dev)
            if step >= args.steps:
                break
        if step == n_before:
            raise ValueError(f"{len(records)} records make no batch of "
                             f"{args.batch_size}")
    mgr.save(step, state.params)
    mgr.close()
    save_params(
        os.path.join(args.out_dir, "adapter"), state.params,
        metadata={
            "kind": "full" if args.full_finetune else "lora",
            "lora_r": args.lora_r, "lora_alpha": args.lora_alpha,
            "steps": step, "final_loss": losses[-1],
            "vocab_size": cfg.model.vocab_size,
            "base": _base(args, dev),
            **({"vocab_seed": args.seed} if extended else {}),
        },
    )
    print(json.dumps({"steps": step, "first_loss": losses[0],
                      "final_loss": losses[-1], "losses": losses,
                      "step_ms": step_ms, "tokens": tokens_seen}))
    return 0


def _sample(cfg, base_params, trainable, tokenizer, args, scale,
            dev) -> None:
    """Periodic greedy sample (the reference's SamplingCallback)."""
    from tts_inference_tpu_torch import protocol as P
    from tts_inference_tpu_torch.config import SamplingConfig
    from tts_inference_tpu_torch.engine.engine import GenerationEngine
    from tts_inference_tpu_torch.training import lora as L

    with torch.no_grad():
        params = (trainable if args.full_finetune
                  else L.merge_params(base_params, trainable, scale))
        eng = GenerationEngine(params, cfg.model, cfg.engine, device=dev)
        prompt = tokenizer.encode("tara: sample check")
        res = eng.generate(
            P.format_prompt_ids(prompt),
            SamplingConfig(greedy=True, max_tokens=24,
                           repetition_penalty=1.0),
        )
    print(f"  sample tokens: {res.token_ids[:12]}…", flush=True)


def cmd_merge(args) -> int:
    """Adapter + base → merged serving checkpoint (modal_merge_base.py)."""
    from tts_inference_tpu_torch.runtime import TOKENIZER_FILES
    from tts_inference_tpu_torch.training import lora as L
    from tts_inference_tpu_torch.training.checkpoint import (restore_params,
                                                             save_params)

    dev = _device(args)
    adapter, meta = restore_params(os.path.join(args.adapter_dir, "adapter"),
                                   dev)
    trained, base = meta.get("base"), _base(args, dev)
    if meta.get("kind") != "full" and trained is not None and (
            "seed" in trained or "seed" in base) and trained != base:
        raise ValueError(
            f"the adapter was trained on the base {trained}, this merge "
            f"would build {base}: seeded random weights differ by seed and "
            "by device type, so merge with the same --seed and device (or "
            "the same --model-path)")
    if meta.get("kind") != "full" and meta.get("vocab_seed",
                                               args.seed) != args.seed:
        raise ValueError(
            f"the adapter was trained on embedding rows drawn with seed "
            f"{meta['vocab_seed']}, this merge would draw them with "
            f"{args.seed}: merge with --seed {meta['vocab_seed']}")
    cfg, params, _ = _model_setup(args, dev)
    with torch.no_grad():
        if meta.get("kind") == "full":
            merged = adapter
        else:
            scale = L.lora_scale(meta.get("lora_r", args.lora_r),
                                 meta.get("lora_alpha", args.lora_alpha))
            if meta.get("vocab_size") and \
                    meta["vocab_size"] != cfg.model.vocab_size:
                from tts_inference_tpu_torch.training.data import \
                    extend_vocab

                params = extend_vocab(
                    params, meta["vocab_size"] - cfg.model.vocab_size,
                    seed=args.seed,
                )
            merged = L.merge_params(params, adapter, scale)
    model_cfg = dataclasses.replace(
        cfg.model, vocab_size=meta.get("vocab_size", cfg.model.vocab_size))
    t0 = time.perf_counter()
    nbytes = save_params(args.out_dir, merged, metadata={
        **meta, "kind": "merged", "source_adapter": args.adapter_dir,
        "model_config": dataclasses.asdict(model_cfg),
    })
    save_s = time.perf_counter() - t0
    for f in TOKENIZER_FILES:
        if args.model_path and os.path.exists(
                os.path.join(args.model_path, f)):
            shutil.copy(os.path.join(args.model_path, f), args.out_dir)
    print(json.dumps({"out_dir": args.out_dir, "kind": "merged",
                      "bytes": nbytes, "save_s": save_s}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="finetune")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--tiny", action="store_true")
        p.add_argument("--cpu", action="store_true",
                       help="run on the CPU (as --device cpu)")
        p.add_argument("--device", default=None,
                       help="torch device (default: cuda; an error when "
                            "there is none)")
        p.add_argument("--model-path")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--lora-r", type=int, default=16)
        p.add_argument("--lora-alpha", type=float, default=32.0)

    t = sub.add_parser("train")
    common(t)
    t.add_argument("--dataset", help="JSONL with text/voice/codes records, "
                                     "or an HF-datasets on-disk dir "
                                     "(arrow/parquet)")
    t.add_argument("--synthetic-records", type=int, default=32)
    t.add_argument("--steps", type=int, default=100)
    t.add_argument("--batch-size", type=int, default=2)
    t.add_argument("--max-len", type=int, default=128)
    t.add_argument("--lr", type=float, default=2e-4)
    t.add_argument("--log-every", type=int, default=5)
    t.add_argument("--save-every", type=int, default=50)
    t.add_argument("--sample-every", type=int, default=0,
                   help="greedy sample every N steps (0 = off)")
    t.add_argument("--extend-vocab", action="store_true")
    t.add_argument("--full-finetune", action="store_true")
    t.add_argument("--out-dir", required=True)
    t.set_defaults(fn=cmd_train)

    m = sub.add_parser("merge")
    common(m)
    m.add_argument("--adapter-dir", required=True)
    m.add_argument("--out-dir", required=True)
    m.set_defaults(fn=cmd_merge)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
