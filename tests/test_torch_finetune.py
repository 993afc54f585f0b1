"""``finetune train → merge → serve`` of the port on the CPU (tiny): step
checkpoints with retention, the adapter's and the merged dir's metadata,
the merged tree equal to an in-memory ``merge_params``, the merged dir
booted by ``Runtime.create`` and ``cli generate`` with greedy tokens equal
to an engine over the in-memory merge; a base from ``--model-path`` (its
tokenizer travels to the merged dir); ``--full-finetune``,
``--extend-vocab``; a merge that would build another random base raises;
the merged ``kind`` against the JAX package's (ROADMAP.md Queue 3)."""

import json
import os

import numpy as np
import pytest
import torch

from tts_inference_tpu_torch import cli, weights
from tts_inference_tpu_torch.config import SamplingConfig, tiny_config
from tts_inference_tpu_torch.engine.engine import GenerationEngine
from tts_inference_tpu_torch.runtime import Runtime, load_model
from tts_inference_tpu_torch.training import data as D
from tts_inference_tpu_torch.training import finetune
from tts_inference_tpu_torch.training import lora as L
from tts_inference_tpu_torch.training.checkpoint import restore_params
from tts_inference_tpu_torch.utils.tokenizer import HFTokenizer

from tests.torch_port_helpers import AUDIO_RANGE

CFG = tiny_config()
TRAIN = ["--tiny", "--batch-size", "2", "--max-len", "64", "--lora-r", "4",
         "--log-every", "3"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (it runs beside other
    files' servers, which wait on starved OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _summary(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _greedy(n=21):
    return SamplingConfig(greedy=True, max_tokens=n, token_range=AUDIO_RANGE)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """6 LoRA steps on a JSONL corpus (``--cpu``, the JAX CLI's spelling),
    a step checkpoint every 2, a greedy sample every 3; then the merge."""
    root = tmp_path_factory.mktemp("ft")
    recs = D.synthetic_records(np.random.default_rng(0), n=8)
    (root / "d.jsonl").write_text("\n".join(json.dumps(r) for r in recs))
    out, merged = root / "ft", root / "merged"
    assert finetune.main(["train", *TRAIN, "--cpu", "--steps", "6",
                          "--save-every", "2", "--sample-every", "3",
                          "--dataset", str(root / "d.jsonl"),
                          "--out-dir", str(out), "--seed", "1"]) == 0
    assert finetune.main(["merge", "--tiny", "--device", "cpu",
                          "--adapter-dir", str(out), "--out-dir",
                          str(merged), "--seed", "1"]) == 0
    return root


def test_train_writes_adapter_and_retained_steps(trained):
    out = trained / "ft"
    assert sorted(os.listdir(out / "ckpts")) == ["4", "6"]   # max_to_keep 2
    ad, meta = restore_params(str(out / "adapter"))
    last, _ = restore_params(str(out / "ckpts" / "6"))
    assert meta["kind"] == "lora" and meta["steps"] == 6
    assert meta["base"] == {"seed": 1, "device": "cpu"}
    assert meta["vocab_size"] == CFG.model.vocab_size
    assert len(ad["layers"]) == CFG.model.num_hidden_layers
    for le, ll in zip(ad["layers"], last["layers"]):
        for t in L.DEFAULT_TARGETS:
            assert le[t]["A"].shape[1] == le[t]["B"].shape[0] == 4
            assert torch.equal(le[t]["B"], ll[t]["B"]) and le[t]["B"].any()


def test_merge_serves_the_in_memory_merge(trained):
    """The merged dir holds merge_params(base, adapter) bit for bit, says
    "kind": "merged", and boots: Runtime.create and cli generate, greedy
    tokens equal to an engine over the in-memory merge."""
    merged_dir = str(trained / "merged")
    ad, meta = restore_params(str(trained / "ft" / "adapter"))
    base = weights.init_llama_params(CFG.model, 1, "cpu")
    want = L.merge_params(base, ad, L.lora_scale(4, 32.0))
    got, mmeta = restore_params(merged_dir)
    assert mmeta["kind"] == "merged" and mmeta["steps"] == 6
    assert mmeta["model_config"]["hidden_size"] == CFG.model.hidden_size
    for lg, lw, lb in zip(got["layers"], want["layers"], base["layers"]):
        for t in L.DEFAULT_TARGETS:
            assert torch.equal(lg[t], lw[t]) and not torch.equal(lg[t], lb[t])
    assert torch.equal(got["embed"], base["embed"])

    rt = Runtime.create(CFG, model_path=merged_dir, device="cpu")
    assert rt.config.model == CFG.model
    prompt = rt.pipeline.build_prompt("hello", force_speech=True)
    served = rt.engine.generate(prompt, _greedy()).token_ids
    eng = GenerationEngine(want, CFG.model, CFG.engine, device="cpu")
    assert served == eng.generate(prompt, _greedy()).token_ids
    assert len(served) == 21

    wav = trained / "o.wav"
    assert cli.main(["generate", "--tiny", "--device", "cpu", "--no-warmup",
                     "--model-path", merged_dir, "--text", "hello",
                     "--greedy", "--max-tokens", "21", "--force-speech",
                     "--audio-only", "--output", str(wav)]) == 0
    assert wav.stat().st_size > 44


@pytest.mark.parametrize("other", ["seed", "device"])
def test_merge_refuses_another_random_base(trained, tmp_path, other):
    """Torch draws other numbers per seed and per device type: a merge
    that would rebuild a different random base raises."""
    src = trained / "ft"
    args = ["merge", "--tiny", "--device", "cpu", "--adapter-dir", str(src),
            "--out-dir", str(tmp_path / "m"), "--seed", "1"]
    if other == "seed":
        args[-1] = "2"
    else:
        adir = tmp_path / "ft"
        (adir / "adapter").mkdir(parents=True)
        meta = json.loads((src / "adapter" / "metadata.json").read_text())
        meta["base"]["device"] = "cuda"
        (adir / "adapter" / "metadata.json").write_text(json.dumps(meta))
        os.link(src / "adapter" / "params.safetensors",
                adir / "adapter" / "params.safetensors")
        args[5] = str(adir)
    with pytest.raises(ValueError, match="trained on the base"):
        finetune.main(args)
    assert not (tmp_path / "m").exists()


def test_full_finetune_and_extended_vocab(tmp_path, capsys):
    """--full-finetune --extend-vocab: the adapter is the whole tree with
    the mined tags' rows appended; its merge is that tree, and it boots
    with the extended vocab."""
    out, merged = tmp_path / "ft", tmp_path / "merged"
    assert finetune.main(["train", *TRAIN, "--device", "cpu", "--steps", "2",
                          "--synthetic-records", "6", "--save-every", "0",
                          "--full-finetune", "--extend-vocab",
                          "--out-dir", str(out)]) == 0
    summary = _summary(capsys)
    assert summary["steps"] == 2 and len(summary["step_ms"]) == 2
    assert summary["losses"][0] == summary["first_loss"]
    ad, meta = restore_params(str(out / "adapter"))
    tags = D.mine_tags([r["text"] for r in D.synthetic_records(
        np.random.default_rng(0), n=6)])
    vocab = CFG.model.vocab_size + len(tags)
    assert tags
    assert meta["kind"] == "full" and meta["vocab_size"] == vocab
    assert ad["embed"].shape[0] == vocab
    assert sorted(os.listdir(out / "ckpts")) == ["2"]
    assert finetune.main(["merge", "--tiny", "--device", "cpu",
                          "--adapter-dir", str(out), "--out-dir",
                          str(merged)]) == 0
    got, mmeta = restore_params(str(merged))
    assert mmeta["kind"] == "merged" and mmeta["vocab_size"] == vocab
    assert torch.equal(got["layers"][1]["w_down"], ad["layers"][1]["w_down"])
    rt = Runtime.create(CFG, model_path=str(merged), device="cpu")
    assert rt.config.model.vocab_size == vocab
    toks = rt.engine.generate(
        rt.pipeline.build_prompt("hi", force_speech=True), _greedy(7))
    assert len(toks.token_ids) == 7


@pytest.fixture(scope="module")
def hf_base(tmp_path_factory):
    """A tiny HF dir with a BPE tokenizer.json."""
    from tts_inference_tpu_torch.tools import make_checkpoint

    root = tmp_path_factory.mktemp("ck")
    assert make_checkpoint.main(["--out", str(root), "--tiny",
                                 "--device", "cpu"]) == 0
    return str(root / "model")


def test_lora_on_an_hf_base_keeps_its_tokenizer(hf_base, tmp_path, capsys):
    """A base from --model-path (an HF dir with a BPE tokenizer.json): the
    run tokenizes with it, the merge copies it beside the merged weights,
    and the merged dir boots with it."""
    model = hf_base
    capsys.readouterr()
    out, merged = tmp_path / "ft", tmp_path / "merged"
    assert finetune.main(["train", *TRAIN, "--device", "cpu", "--steps", "2",
                          "--synthetic-records", "4", "--model-path", model,
                          "--out-dir", str(out)]) == 0
    assert _summary(capsys)["steps"] == 2
    _, meta = restore_params(str(out / "adapter"))
    assert meta["base"] == {"model_path": os.path.abspath(model)}
    assert finetune.main(["merge", "--device", "cpu", "--model-path", model,
                          "--adapter-dir", str(out), "--out-dir",
                          str(merged)]) == 0
    assert sorted(f for f in os.listdir(merged) if f.startswith("token")) \
        == ["tokenizer.json", "tokenizer_config.json"]
    rt = Runtime.create(CFG, model_path=str(merged), device="cpu")
    assert isinstance(rt.tokenizer, HFTokenizer)
    assert rt.config.model.vocab_size == CFG.model.vocab_size


def test_lora_extended_vocab_merges_only_with_its_seed(hf_base, tmp_path):
    """LoRA with --extend-vocab on an HF base: the adapter records the seed
    of the new embedding rows; a merge with another seed (which would draw
    other rows) raises, one with the same seed writes the rows the adapter
    was trained against."""
    out, merged = tmp_path / "ft", tmp_path / "merged"
    assert finetune.main(["train", *TRAIN, "--device", "cpu", "--steps", "1",
                          "--synthetic-records", "6", "--save-every", "0",
                          "--extend-vocab", "--model-path", hf_base,
                          "--seed", "3", "--out-dir", str(out)]) == 0
    _, meta = restore_params(str(out / "adapter"))
    tags = D.mine_tags([r["text"] for r in D.synthetic_records(
        np.random.default_rng(3), n=6)])
    assert tags and meta["vocab_seed"] == 3
    assert meta["vocab_size"] == CFG.model.vocab_size + len(tags)
    merge = ["merge", "--device", "cpu", "--model-path", hf_base,
             "--adapter-dir", str(out), "--out-dir", str(merged)]
    with pytest.raises(ValueError, match="drawn with seed 3"):
        finetune.main([*merge, "--seed", "4"])
    assert not merged.exists()
    assert finetune.main([*merge, "--seed", "3"]) == 0
    got, _ = restore_params(str(merged))
    base, _ = load_model(CFG, torch.device("cpu"), model_path=hf_base)
    want = D.extend_vocab(base, len(tags), seed=3)["embed"]
    assert torch.equal(got["embed"], want)


def test_finetune_needs_a_card_unless_asked_for_the_cpu(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in (["train", "--steps", "1"], ["merge", "--adapter-dir", "x"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            finetune.main([*cmd, "--tiny", "--out-dir", str(tmp_path)])


def test_too_few_records_for_a_batch_raise(tmp_path):
    with pytest.raises(ValueError, match="make no batch"):
        finetune.main(["train", *TRAIN, "--device", "cpu", "--steps", "2",
                       "--synthetic-records", "1", "--out-dir",
                       str(tmp_path)])


def test_merged_kind_differs_from_the_jax_package(trained, tmp_path):
    """The JAX merge writes {"kind": "merged", …, **meta}: the adapter's
    "kind": "lora" comes after and wins, so its merged dir says "lora". The
    port's says "merged" (ROADMAP.md Queue 3)."""
    import jax

    from tts_inference_tpu.config import tiny_config as jtiny
    from tts_inference_tpu.models import llama as jllama
    from tts_inference_tpu.training import finetune as jfinetune
    from tts_inference_tpu.training import lora as jL
    from tts_inference_tpu.training.checkpoint import save_params

    cfg = jtiny()
    params = jllama.init_llama_params(jax.random.PRNGKey(0), cfg.model)
    ad = jL.init_lora(jax.random.PRNGKey(1), cfg.model, params, r=4)
    save_params(str(tmp_path / "ft" / "adapter"), ad, metadata={
        "kind": "lora", "lora_r": 4, "lora_alpha": 32.0, "steps": 1,
        "vocab_size": cfg.model.vocab_size})
    assert jfinetune.main(["merge", "--tiny", "--cpu", "--adapter-dir",
                           str(tmp_path / "ft"), "--out-dir",
                           str(tmp_path / "jm")]) == 0
    jmeta = json.loads((tmp_path / "jm" / "metadata.json").read_text())
    assert jmeta["kind"] == "lora"
    meta = json.loads((trained / "merged" / "metadata.json").read_text())
    assert meta["kind"] == "merged"
