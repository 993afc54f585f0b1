"""Training data pipeline: transcripts (+ optional audio codes) → LM batches.

Port of ``tts_inference_tpu/training/data.py``. The reference fine-tunes on
an HF dataset of tagged transcripts (`modal_finetune_base.py:73-105`: regex
tag mining → add_special_tokens → resize_token_embeddings). Here:

- JSONL records {"text": …, "voice": …, "codes": [interleaved audio codes]}
  become full Orpheus sequences: [SOH] text [EOT, EOH] [SOS] audio [EOS]
  (TTS objective) or text-only sequences when codes are absent.
- Tag mining extracts `<tag>`-style markers and extends the embedding table
  (new rows appended — the resize_token_embeddings analog).
- A synthetic generator stands in for real corpora in tests/demos (the
  reference's fake-backend pattern, SURVEY.md §4.6).

Everything but ``extend_vocab`` is numpy and the standard library, so the
same numpy seed gives the JAX package's records and token arrays bit for
bit. ``extend_vocab`` draws its new rows from a CPU ``torch.Generator``
(seed, and seed + 1 for an untied head's columns) and moves them to the
table's device, so a seed gives the same rows on every device: torch's
numbers, at the JAX function's scale. ``load_dataset_dir`` imports
``pyarrow`` or ``datasets`` only when called.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tts_inference_tpu_torch import protocol as P
from tts_inference_tpu_torch.utils.tokenizer import TokenizerProtocol

TAG_RE = re.compile(r"<[a-zA-Z_][a-zA-Z0-9_]*>")


def mine_tags(texts: Sequence[str]) -> List[str]:
    """Collect distinct <tag> markers (reference: regex tag mining)."""
    tags = set()
    for t in texts:
        tags.update(TAG_RE.findall(t))
    return sorted(tags)


def extend_vocab(params: Dict, n_new: int, seed: int = 0) -> Dict:
    """Append n_new embedding rows (resize_token_embeddings analog).

    New rows are drawn at the embedding's own scale (its population std).
    Tied LM heads pick the new rows up automatically; untied heads get
    matching output columns."""
    if n_new <= 0:
        return params
    emb = params["embed"]
    std = float(torch.std(emb.detach().float(), correction=0))

    def draw(shape, s, dtype):
        gen = torch.Generator().manual_seed(s)
        return (torch.randn(shape, generator=gen, dtype=torch.float32)
                * std).to(emb.device, dtype)

    out = dict(params)
    out["embed"] = torch.cat(
        [emb, draw((n_new, emb.shape[1]), seed, emb.dtype)], dim=0)
    if "lm_head" in params:
        head = params["lm_head"]
        out["lm_head"] = torch.cat(
            [head, draw((head.shape[0], n_new), seed + 1, head.dtype)], dim=1)
    return out


def build_sequence(
    tokenizer: TokenizerProtocol,
    text: str,
    voice: str = "tara",
    codes: Optional[Sequence[int]] = None,
) -> List[int]:
    """One training sequence in the Orpheus format."""
    ids = P.format_prompt_ids(
        tokenizer.encode(P.format_prompt_text(text, voice))
    )
    if codes:
        ids += [P.TOKEN_SOS]
        ids += [int(c) + P.TOKEN_AUDIO_BASE for c in codes]
        ids += [P.TOKEN_EOS]
    return ids


def load_jsonl(path: str) -> List[dict]:
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def load_dataset_dir(path: str, *, split: Optional[str] = None,
                     text_column: str = "text",
                     voice_column: str = "voice",
                     codes_column: str = "codes") -> List[dict]:
    """Read an HF-datasets on-disk dataset (arrow dir from
    `Dataset.save_to_disk`, or a directory of parquet files) into the same
    record schema `load_jsonl` yields, so a real corpus (the reference's
    `rumik-ai/hi-elise`, `modal_finetune_base.py:73-105`) drops into
    `finetune.py` without conversion.

    Mirrors the reference's `.remove_columns(["audio"])`: raw audio arrays
    are dropped; only text/voice/codes survive. Missing voice defaults to
    "tara"; missing codes → text-only LM records. Needs ``pyarrow``
    (parquet) or ``datasets`` (arrow): a missing one raises ImportError.
    """
    import glob as _glob

    rows: Iterator[dict]
    if _glob.glob(os.path.join(path, "*.parquet")):
        import pyarrow.parquet as pq

        tables = [pq.read_table(p)
                  for p in sorted(_glob.glob(os.path.join(path, "*.parquet")))]
        rows = (r for t in tables for r in t.to_pylist())
    else:
        import datasets  # HF datasets: the arrow on-disk format

        ds = datasets.load_from_disk(path)
        if isinstance(ds, datasets.DatasetDict):
            ds = ds[split] if split else ds[next(iter(ds))]
        drop = [c for c in ds.column_names
                if c not in (text_column, voice_column, codes_column)]
        if drop:
            ds = ds.remove_columns(drop)  # the reference's audio-drop
        rows = iter(ds)
    out: List[dict] = []
    for r in rows:
        text = r.get(text_column)
        if text is None:
            continue
        rec = {"text": str(text),
               "voice": str(r.get(voice_column) or "tara")}
        codes = r.get(codes_column)
        if codes:
            rec["codes"] = [int(c) for c in codes]
        out.append(rec)
    return out


def synthetic_records(rng: np.random.Generator, n: int = 32,
                      frames: int = 4) -> List[dict]:
    """Synthetic tagged corpus (tests/demo; no downloadable datasets)."""
    words = ["nadi", "pahad", "suraj", "chand", "hawa", "baarish",
             "kitab", "gaana", "safar", "sapna"]
    tags = ["<laugh>", "<sigh>"]
    out = []
    for i in range(n):
        k = int(rng.integers(3, 9))
        text = " ".join(rng.choice(words, size=k))
        if rng.random() < 0.3:
            text = f"{rng.choice(tags)} {text}"
        codes = []
        for _ in range(frames):
            for p in range(P.FRAME_SIZE):
                codes.append(int(rng.integers(0, P.CODEBOOK_SIZE))
                             + P.POSITION_OFFSETS[p])
        out.append({"text": text, "voice": "tara", "codes": codes})
    return out


def batches(
    tokenizer: TokenizerProtocol,
    records: Sequence[dict],
    batch_size: int,
    max_len: int,
    *,
    shuffle_rng: Optional[np.random.Generator] = None,
    drop_remainder: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (tokens (B, max_len) int32, lens (B,)) right-padded batches."""
    order = np.arange(len(records))
    if shuffle_rng is not None:
        shuffle_rng.shuffle(order)
    buf_tokens, buf_lens = [], []
    for idx in order:
        r = records[int(idx)]
        seq = build_sequence(
            tokenizer, r["text"], r.get("voice", "tara"), r.get("codes")
        )[:max_len]
        buf_tokens.append(seq)
        buf_lens.append(len(seq))
        if len(buf_tokens) == batch_size:
            out = np.zeros((batch_size, max_len), np.int32)
            for i, s in enumerate(buf_tokens):
                out[i, : len(s)] = s
            yield out, np.asarray(buf_lens, np.int32)
            buf_tokens, buf_lens = [], []
    if buf_tokens and not drop_remainder:
        out = np.zeros((len(buf_tokens), max_len), np.int32)
        for i, s in enumerate(buf_tokens):
            out[i, : len(s)] = s
        yield out, np.asarray(buf_lens, np.int32)


def inspect(records: Sequence[dict]) -> dict:
    """Dataset schema dump + tag census (reference: inspect_dataset.py:16-85)."""
    import collections

    fields = collections.Counter()
    tag_counts = collections.Counter()
    text_lens, code_lens = [], []
    for r in records:
        for k in r:
            fields[k] += 1
        text = r.get("text", "")
        text_lens.append(len(text))
        tag_counts.update(TAG_RE.findall(text))
        if r.get("codes"):
            code_lens.append(len(r["codes"]))

    def stats(xs):
        return ({"min": min(xs), "max": max(xs),
                 "mean": round(sum(xs) / len(xs), 1)} if xs else {})
    return {
        "records": len(records),
        "fields": dict(fields),
        "text_chars": stats(text_lens),
        "audio_codes": stats(code_lens),
        "tags": dict(tag_counts),
    }


def _main(argv=None) -> int:
    """CLI: python -m tts_inference_tpu_torch.training.data --dataset x.jsonl"""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", help="JSONL path or HF-datasets on-disk "
                                      "dir (omit for synthetic demo)")
    ap.add_argument("--synthetic-records", type=int, default=32)
    args = ap.parse_args(argv)
    if args.dataset and os.path.isdir(args.dataset):
        recs = load_dataset_dir(args.dataset)
    elif args.dataset:
        recs = load_jsonl(args.dataset)
    else:
        recs = synthetic_records(np.random.default_rng(0),
                                 n=args.synthetic_records)
    print(json.dumps(inspect(recs), indent=2))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_main())
