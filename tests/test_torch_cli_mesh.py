"""The single-stream commands under a mesh: `cli generate`, `dump-tokens`
and `quantize` with `--tp/--dp` on the CPU (twins of the JAX CLI's
`--tp/--dp` on every runtime command, tts_inference_tpu/cli.py:91-94).

The sharded command starts its followers itself (gloo processes over
localhost); process 0 prints the command's JSON and writes its files, the
followers print nothing. Greedy decoding, so a token flips only at a top-2
tie (tests/torch_mesh_work.py::_requests): the tokens and the PCM equal the
unsharded command's. `quantize` writes the unsharded command's files byte
for byte — at the default int4 group too, which the tiny model's K of 128
shrinks to 64 and tp 2 cuts into row shards of group 32 — and its output
boots sharded.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
GEN = ["--tiny", "--device", "cpu", "--text", "mesh check", "--greedy",
       "--force-speech", "--audio-only", "--max-tokens", "48"]


def _run(*argv) -> list:
    """The JSON lines a command prints, run as its own process on one
    torch thread (a sharded command's followers are started with its
    environment and print to the same stdout)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-m", "tts_inference_tpu_torch.cli",
                          *argv], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


def _single(*argv) -> dict:
    lines = _run(*argv)
    assert len(lines) == 1
    return lines[0]


def test_cli_generate_tp2_matches(tmp_path):
    """`generate --tp 2` writes the unsharded command's WAV, and only
    process 0 prints."""
    one = _single("generate", *GEN, "--output",
                  str(tmp_path / "one.wav"))
    lines = _run("generate", *GEN, "--output", str(tmp_path / "two.wav"),
                 "--tp", "2")
    assert len(lines) == 1 and lines[0]["tokens"] == one["tokens"] == 48
    assert (tmp_path / "two.wav").read_bytes() == \
        (tmp_path / "one.wav").read_bytes()


def test_cli_dump_tokens_tp2_matches():
    """`dump-tokens --tp 2 --no-warmup`: the unsharded token ids (its
    sampling is the command's own, seeded)."""
    argv = ["--tiny", "--device", "cpu", "--text", "dump", "--max-tokens",
            "40", "--no-warmup"]
    one = _single("dump-tokens", *argv)
    lines = _run("dump-tokens", *argv, "--tp", "2")
    assert len(lines) == 1
    assert lines[0]["prompt_ids"] == one["prompt_ids"]
    assert lines[0]["token_ids"] == one["token_ids"]
    assert len(one["token_ids"]) == 40


@pytest.mark.parametrize("bits", ["8", "4"])
def test_cli_quantize_tp2_writes_the_unsharded_checkpoint(tmp_path, bits,
                                                          monkeypatch):
    """`quantize --tp 2`: the shards gathered back to process 0 (int4 row
    shards at group 32 put back at the checkpoint's 64) are written as the
    unsharded command writes them, byte for byte; process 0 alone prints
    and writes. int4: the checkpoint boots under `--tp 2`."""
    monkeypatch.delenv("TTS_INT4_GROUP", raising=False)
    argv = ["--tiny", "--device", "cpu", "--weight-bits", bits]
    _single("quantize", *argv, "--out", str(tmp_path / "one"))
    lines = _run("quantize", *argv, "--out", str(tmp_path / "two"),
                     "--tp", "2")
    assert len(lines) == 1 and lines[0]["weight_bits"] == int(bits)
    for f in ("params.safetensors", "metadata.json"):
        assert (tmp_path / "two" / f).read_bytes() == \
            (tmp_path / "one" / f).read_bytes(), f
    if bits == "4":
        boot = ["--model-path", str(tmp_path / "two"), "--device", "cpu",
                "--text", "boot", "--max-tokens", "8", "--no-warmup"]
        want = _single("dump-tokens", *boot)
        got = _run("dump-tokens", *boot, "--tp", "2")
        assert got[0]["token_ids"] == want["token_ids"]
