"""The port booted from checkpoint directories against the JAX package
booted from the same ones: ``Runtime.create(model_path=, snac_path=,
lora_path=, tokenizer_path=)`` (configs field by field, prompt ids, greedy
tokens through the engine: exact), ``cli generate | dump-tokens | quantize |
devices`` and the KV-bucket flags; and a boot in a process where jax, the
JAX package, safetensors, tokenizers, transformers, ml_dtypes and orbax
cannot be imported (a GPU host needs none of them)."""

import json
import os
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
pytest.importorskip("safetensors")
pytest.importorskip("tokenizers")

from tts_inference_tpu import cli as jcli  # noqa: E402
from tts_inference_tpu.config import (ModelConfig, SamplingConfig,  # noqa: E402
                                      SnacConfig, extended_kv_buckets,
                                      tiny_config)
from tts_inference_tpu.runtime import Runtime as JRuntime  # noqa: E402
from tts_inference_tpu_torch import cli  # noqa: E402
from tts_inference_tpu_torch import runtime as truntime  # noqa: E402
from tts_inference_tpu_torch import weights  # noqa: E402
from tts_inference_tpu_torch.utils.tokenizer import HFTokenizer  # noqa: E402

from tests.torch_port_helpers import AUDIO_RANGE, port_config  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
REAL_VOCAB = 156940
CFG = tiny_config()
TEXT = "Hello there, how are you doing today?"


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """An HF dir (real Orpheus vocab over tiny widths, sharded, with the
    repo's BPE tokenizer fixture), a SNAC dir and a LoRA adapter."""
    from safetensors.torch import save_file

    from tests.test_llama import hf_tiny
    from tests.torch_snac_ref import TorchSnacRef
    from tts_inference_tpu.tools.tokenizer_fixture import write_tiny_tokenizer

    root = tmp_path_factory.mktemp("ckpt")
    model = hf_tiny(ModelConfig.tiny(vocab_size=REAL_VOCAB), seed=3)
    model_dir = root / "model"
    model.save_pretrained(str(model_dir), safe_serialization=True,
                          max_shard_size="10MB")
    write_tiny_tokenizer(str(model_dir))

    scfg = SnacConfig(latent_dim=32, decoder_dim=64, codebook_dim=4)
    torch.manual_seed(4)
    ref = TorchSnacRef(scfg).eval()
    snac_dir = root / "snac"
    snac_dir.mkdir()
    torch.save(ref.state_dict(), str(snac_dir / "pytorch_model.bin"))
    (snac_dir / "config.json").write_text(json.dumps({
        "sampling_rate": 24000, "latent_dim": 32, "decoder_dim": 64,
        "decoder_rates": [8, 8, 4, 2], "codebook_size": 4096,
        "codebook_dim": 4, "vq_strides": [4, 2, 1],
        "noise": True, "depthwise": True}))

    sd = model.state_dict()
    rng = np.random.default_rng(5)
    lora = {}
    for t in ("model.layers.0.self_attn.v_proj", "model.layers.1.mlp.up_proj"):
        w = sd[f"{t}.weight"]
        lora[f"base_model.model.{t}.lora_A.weight"] = torch.from_numpy(
            rng.normal(size=(8, w.shape[1])).astype(np.float32))
        lora[f"base_model.model.{t}.lora_B.weight"] = torch.from_numpy(
            (rng.normal(size=(w.shape[0], 8)) * 0.1).astype(np.float32))
    lora_dir = root / "lora"
    lora_dir.mkdir()
    save_file(lora, str(lora_dir / "adapter_model.safetensors"))
    (lora_dir / "adapter_config.json").write_text(
        json.dumps({"r": 8, "lora_alpha": 16}))
    return {"model": str(model_dir), "snac": str(snac_dir),
            "lora": str(lora_dir), "root": root}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its boots run beside other
    files' servers, which wait on starved OpenMP threads when all cores are
    taken."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _greedy(n):
    return SamplingConfig(greedy=True, max_tokens=n, token_range=AUDIO_RANGE)


@pytest.mark.parametrize("lora", [False, True])
def test_runtime_boots_as_the_jax_package_does(dirs, lora):
    kw = dict(model_path=dirs["model"], snac_path=dirs["snac"],
              lora_path=dirs["lora"] if lora else None)
    jrt = JRuntime.create(CFG, **kw)
    trt = truntime.Runtime.create(port_config(CFG), device="cpu", **kw)
    assert trt.config == port_config(jrt.config)
    assert trt.config.model.vocab_size == REAL_VOCAB
    assert trt.config.snac.codebook_size == 4096
    assert isinstance(trt.tokenizer, HFTokenizer)
    assert set(trt.load_timings) >= {"load_model_s", "load_snac_s",
                                     "load_tokenizer_s"}
    for voice in ("tara", None):
        want = jrt.pipeline.build_prompt(TEXT, voice)
        assert trt.pipeline.build_prompt(TEXT, voice) == want
    prompt = jrt.pipeline.build_prompt(TEXT, "tara", force_speech=True)
    jtok = jrt.engine.generate(prompt, _greedy(28)).token_ids
    ttok = trt.engine.generate(prompt, _greedy(28)).token_ids
    assert ttok == jtok and len(ttok) == 28


def test_tokenizer_path_and_fallbacks(dirs, tmp_path):
    """--tokenizer-path wins; a model dir without tokenizer files gives
    bytes, as in the JAX package."""
    import shutil

    bare = tmp_path / "bare"
    shutil.copytree(dirs["model"], bare)
    for f in ("tokenizer.json", "tokenizer_config.json"):
        os.remove(bare / f)
    for tok_path, kind in ((None, "ByteTokenizer"),
                           (dirs["model"], "HFTokenizer")):
        jrt = JRuntime.create(CFG, model_path=str(bare),
                              tokenizer_path=tok_path)
        trt = truntime.Runtime.create(port_config(CFG), device="cpu",
                                      model_path=str(bare),
                                      tokenizer_path=tok_path)
        assert type(trt.tokenizer).__name__ == kind
        assert type(jrt.tokenizer).__name__ == kind
        assert trt.pipeline.build_prompt(TEXT) == \
            jrt.pipeline.build_prompt(TEXT)


def test_cli_generate_writes_a_24khz_wav(dirs, tmp_path, capsys):
    out = tmp_path / "o.wav"
    assert cli.main(["generate", "--model-path", dirs["model"],
                     "--snac-path", dirs["snac"], "--lora-path", dirs["lora"],
                     "--device", "cpu", "--no-warmup", "--text", TEXT,
                     "--force-speech", "--audio-only", "--max-tokens", "35",
                     "--output", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["tokens"] == 35
    with wave.open(str(out)) as w:
        assert w.getframerate() == 24000 and w.getnchannels() == 1
        assert w.getnframes() == 5 * 2048


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_dump_tokens_and_devices(dirs, capsys):
    args = ["--model-path", dirs["model"], "--no-warmup", "--text", TEXT,
            "--max-tokens", "8"]
    assert jcli.main(["dump-tokens", "--cpu", *args]) == 0
    want = _last_json(capsys)
    assert cli.main(["dump-tokens", "--device", "cpu", *args]) == 0
    got = _last_json(capsys)
    assert set(got) == set(want)
    assert got["prompt_ids"] == want["prompt_ids"]
    assert len(got["token_ids"]) == len(want["token_ids"]) == 8
    assert jcli.main(["devices"]) == 0
    jdev = _last_json(capsys)
    assert cli.main(["devices"]) == 0
    tdev = _last_json(capsys)
    assert set(tdev) == set(jdev) == {"platform", "devices", "device_count"}
    assert tdev["device_count"] == len(tdev["devices"]) >= 1


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("bits", [8, 4])
def test_cli_quantize_boots_without_quantizing(dirs, tmp_path, bits,
                                               monkeypatch, capsys):
    """`cli quantize` → a boot from its output: the leaves equal the JAX
    package's quantize_llama_params of the same checkpoint, byte for byte,
    and nothing is quantized at boot."""
    from tts_inference_tpu.models.loader import load_llama_checkpoint
    from tts_inference_tpu.models.quant import quantize_llama_params

    out = str(tmp_path / f"q{bits}")
    assert cli.main(["quantize", "--model-path", dirs["model"], "--device",
                     "cpu", "--quantize", "--weight-bits", str(bits),
                     "--out", out]) == 0
    line = _last_json(capsys)
    assert line["weight_bits"] == bits and line["bytes"] > 0
    meta = json.loads(open(os.path.join(out, "metadata.json")).read())
    assert meta["quantized"] == bits and meta["vocab_size"] == REAL_VOCAB
    assert meta["model_config"]["vocab_size"] == REAL_VOCAB

    def boom(*a, **k):
        raise AssertionError("quantized at boot")

    monkeypatch.setattr(truntime, "quantize_llama_params", boom)
    trt = truntime.Runtime.create(port_config(CFG), device="cpu",
                                  model_path=out, quantize=True,
                                  weight_bits=bits)
    jparams, _ = load_llama_checkpoint(dirs["model"])
    want = weights.llama_params_from_jax(
        _np_tree(quantize_llama_params(jparams, bits=bits)))
    got = trt.engine.core.params
    assert trt.config.model.vocab_size == REAL_VOCAB

    def same(a, b, path):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), path
            for k in b:
                same(a[k], b[k], f"{path}.{k}")
        elif isinstance(b, (list, tuple)):
            assert type(a) is type(b) and len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}[{i}]")
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert torch.equal(a, b), path

    same(got, want, "params")
    assert type(got["layers"][0]["wq"]).__name__ == (
        "QuantLinearI4" if bits == 4 else "QuantLinear")
    toks = trt.engine.generate(trt.pipeline.build_prompt(
        TEXT, force_speech=True), _greedy(14)).token_ids
    assert len(toks) == 14


def test_a_jax_orbax_dir_is_refused(tmp_path):
    (tmp_path / "params").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        truntime.Runtime.create(port_config(CFG), device="cpu",
                                model_path=str(tmp_path))


@pytest.mark.parametrize("flags", [[], ["--kv-buckets", "64,128"],
                                   ["--max-input-len", "96",
                                    "--prefill-buckets", "32,96"]])
def test_engine_flags_map_as_the_jax_cli_maps_them(flags):
    """--kv-buckets given: used as given, not extended (the JAX CLI's
    rule); otherwise extended to max_seq_len; --max-input-len and
    --prefill-buckets reach the engine config."""
    args = cli.build_parser().parse_args(
        ["serve", "--tiny", "--device", "cpu", *flags])
    ecfg = cli._config(args).engine
    if "--kv-buckets" in flags:
        assert ecfg.kv_buckets == (64, 128)
    else:
        assert ecfg.kv_buckets == extended_kv_buckets(
            CFG.engine.kv_buckets, CFG.engine.max_seq_len)
    if "--max-input-len" in flags:
        assert ecfg.max_input_len == 96 and ecfg.prefill_buckets == (32, 96)


def test_write_build_info(dirs, tmp_path):
    trt = truntime.Runtime.create(port_config(CFG), device="cpu",
                                  model_path=dirs["model"])
    p = tmp_path / "build_info.json"
    trt.write_build_info(str(p))
    info = json.loads(p.read_text())
    assert info["framework"] == "tts_inference_tpu_torch"
    assert info["backend"] == "cpu"
    assert info["model"]["vocab_size"] == REAL_VOCAB
    assert "load_model_s" in info["load_timings"]


POISONED = ("jax", "tts_inference_tpu", "safetensors", "tokenizers",
            "transformers", "ml_dtypes", "orbax")


def test_boot_with_no_checkpoint_library(tmp_path):
    """The port's own writers make a checkpoint, `cli quantize` quantizes
    it and `cli generate` boots both, in a process where none of jax, the
    JAX package, safetensors, tokenizers, transformers, ml_dtypes or orbax
    can be imported."""
    d = tmp_path / "ck"
    code = "\n".join([
        "import sys",
        *[f"sys.modules[{m!r}] = None" for m in POISONED],
        "from tts_inference_tpu_torch import cli",
        "from tts_inference_tpu_torch.tools import make_checkpoint",
        f"make_checkpoint.main(['--out', {str(d)!r}, '--tiny', "
        "'--device', 'cpu'])",
        "common = ['--device', 'cpu', '--no-warmup', '--text', 'hi there',",
        "          '--force-speech', '--audio-only', '--max-tokens', '14']",
        f"m, s = {str(d / 'model')!r}, {str(d / 'snac')!r}",
        f"q = {str(d / 'q')!r}",
        "assert cli.main(['quantize', '--model-path', m, '--device', 'cpu',",
        "                 '--quantize', '--out', q]) == 0",
        "for path in (m, q):",
        "    assert cli.main(['generate', '--model-path', path,",
        "                     '--snac-path', s, '--tokenizer-path', m,",
        f"                     '--output', {str(tmp_path / 'o.wav')!r},",
        "                     *common]) == 0",
        "bad = [k for k, v in sys.modules.items() if v is not None and",
        f"       k.split('.')[0] in {POISONED!r}]",
        "assert not bad, bad",
        "print('BOOTED')",
    ])
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO),
                                  OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "BOOTED" in res.stdout, res.stderr[-3000:]
    lines = [json.loads(x) for x in res.stdout.splitlines()
             if x.startswith("{")]
    assert sum("rtf" in x for x in lines) == 2
