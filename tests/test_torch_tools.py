"""PyTorch port, the diagnostic and quality tools on the CPU, each held
against the JAX package's own with the same numpy weights and inputs:
``lookahead_sweep``, ``sos_ablation``, ``compare_backends``,
``quant_ladder`` and ``make_artifacts``."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tts_inference_tpu import protocol as P
from tts_inference_tpu.config import SnacConfig, tiny_config
from tts_inference_tpu_torch import weights
from tts_inference_tpu_torch.models.snac import SnacDecoder
from tts_inference_tpu_torch.runtime import Runtime
from tts_inference_tpu_torch.tools import compare_backends as TCB
from tts_inference_tpu_torch.tools import lookahead_sweep as TLS
from tts_inference_tpu_torch.tools import make_artifacts as TMA
from tts_inference_tpu_torch.tools import quant_ladder as TQL
from tts_inference_tpu_torch.tools import sos_ablation as TSA

from tests.torch_port_helpers import (numpy_llama_tree, numpy_snac_tree,
                                      port_config, to_jax)

CFG = tiny_config()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its boots run beside other
    files' servers, which wait on starved OpenMP threads when all cores are
    taken."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decoders(cfg: SnacConfig):
    """(JAX decoder, port decoder) over the same numpy weights."""
    from tts_inference_tpu.models.snac import SnacDecoder as JSnac

    tree = numpy_snac_tree(cfg, seed=1)
    return (JSnac(to_jax(tree), cfg),
            SnacDecoder(weights.snac_params_from_jax(tree, "cpu"),
                        port_config(cfg)))


def _stream(rng, n_frames=6):
    """A raw LM stream with two speech segments (the JAX test's)."""
    def frames(k):
        return [int(rng.integers(0, P.CODEBOOK_SIZE)) + P.POSITION_OFFSETS[p]
                + P.TOKEN_AUDIO_BASE for _ in range(k)
                for p in range(P.FRAME_SIZE)]

    return ([P.TOKEN_SOH, 100, P.TOKEN_EOT, P.TOKEN_EOH, P.TOKEN_SOS]
            + frames(n_frames // 2) + [P.TOKEN_DELIMITER, P.TOKEN_SOS]
            + frames(n_frames // 2) + [P.TOKEN_EOS])


# -- lookahead_sweep -----------------------------------------------------------


def test_lookahead_sweep_matches_jax():
    """The JAX test's sweep (24 frames, lookahead 0 / 3 / 5, left context
    4) on both decoders: every stat within 1e-6, the same pass flags, and
    the JAX test's claims on the port's table."""
    from tts_inference_tpu.tools.lookahead_sweep import sweep

    cfg = SnacConfig(latent_dim=32, decoder_dim=64, codebook_dim=4,
                     codebook_size=64)
    jdec, tdec = _decoders(cfg)
    rng = np.random.default_rng(0)
    codes = [int(rng.integers(0, 64)) + P.POSITION_OFFSETS[p]
             for _ in range(24) for p in range(P.FRAME_SIZE)]
    want = sweep(jdec, codes, lookaheads=(0, 3, 5), left_context=4)
    got = TLS.sweep(tdec, codes, lookaheads=(0, 3, 5), left_context=4)
    assert set(got) == set(want) == {0, 3, 5}
    for la in want:
        assert set(got[la]) == set(want[la])
        assert got[la]["pass"] == bool(want[la]["pass"]), la
        for k, v in want[la].items():
            if k != "pass":
                assert abs(got[la][k] - v) <= 1e-6, (la, k, got[la][k], v)
    assert got[3]["mse"] < 1e-9 and got[5]["mse"] < 1e-9
    assert got[3]["pass"] and got[5]["pass"]
    assert got[0]["mse"] > got[3]["mse"]


def test_lookahead_sweep_main_prints_json_where_jax_fails(capsys):
    """The port's main prints its table; the JAX tool's main raises, since
    its pass flag is a numpy bool, which json.dumps refuses (ROADMAP Queue
    3, PR 14): shown on its quality_stats, which main dumps."""
    from tts_inference_tpu.tools import lookahead_sweep as JLS

    assert TLS.main(["--tiny", "--device", "cpu", "--frames", "12"]) == 0
    table = json.loads(capsys.readouterr().out)
    assert set(table) == {"0", "2", "3", "5", "10", "20"}
    assert all(isinstance(row["pass"], bool) for row in table.values())
    assert table["3"]["pass"] and table["5"]["pass"]
    a = np.sin(np.linspace(0, 20, 4096))
    b = a + 1e-3 * np.cos(np.linspace(0, 7, 4096))
    assert TLS.quality_stats(a, b) == {
        k: (bool(v) if k == "pass" else v)
        for k, v in JLS.quality_stats(a, b).items()}
    json.dumps(TLS.quality_stats(a, b))
    with pytest.raises(TypeError, match="not JSON serializable"):
        json.dumps(JLS.quality_stats(a, b))


# -- sos_ablation --------------------------------------------------------------


def test_sos_ablation_matches_jax(tmp_path):
    """First- and last-SOS extraction of a two-segment stream: the same
    frame counts and census, and WAVs within 1 PCM16 step of JAX's."""
    from tts_inference_tpu.tools.sos_ablation import ablate
    from tts_inference_tpu.utils.audio import read_wav

    jdec, tdec = _decoders(SnacConfig(latent_dim=32, decoder_dim=64,
                                      codebook_dim=4))
    toks = _stream(np.random.default_rng(0))
    want = ablate(jdec, toks, str(tmp_path / "jax"))
    got = TSA.ablate(tdec, toks, str(tmp_path / "port"))
    assert got["census"] == want["census"]
    assert got["first_sos"]["frames"] == want["first_sos"]["frames"] == 6
    assert got["last_sos"]["frames"] == want["last_sos"]["frames"] == 3
    for s in TSA.STRATEGIES:
        a, _ = read_wav(want[s]["wav"])
        b, _ = read_wav(got[s]["wav"])
        assert got[s]["wav"].startswith(str(tmp_path / "port"))
        pa = np.round(a * 32767).astype(np.int32)
        pb = np.round(b * 32767).astype(np.int32)
        assert pa.shape == pb.shape and pa.size == got[s]["frames"] * 2048
        assert np.abs(pa - pb).max() <= 1


# -- compare_backends ------------------------------------------------------------


@pytest.fixture(scope="module")
def trees():
    return (numpy_llama_tree(CFG.model, seed=0),
            numpy_snac_tree(CFG.snac, seed=1))


def test_compare_backends_matches_jax(trees):
    """On the CPU the engine and the eager twin agree; the twin's greedy
    tokens equal the JAX twin's exactly."""
    from tts_inference_tpu.tools.compare_backends import eager_greedy

    ltree, stree = trees
    rt = Runtime.create(port_config(CFG), device="cpu", llama_tree=ltree,
                        snac_tree=stree)
    rep = TCB.compare(rt, "parity", "tara", max_tokens=12)
    assert rep["match"], rep
    assert rep["engine"]["tokens"] == rep["eager"]["tokens"] >= 1
    assert rep["first_mismatch"] == -1
    core = rt.engine.core
    prompt = rt.pipeline.build_prompt("parity", "tara")
    want = eager_greedy(to_jax(ltree), CFG.model, prompt, 12,
                        P.TOKEN_EOS, logits_base=core.logits_base)
    got = TCB.eager_greedy(core.params, core.model_cfg, prompt, 12,
                           P.TOKEN_EOS, logits_base=core.logits_base)
    assert got == want and len(got) >= 1
    assert TCB.first_mismatch([1, 2, 3], [1, 2]) == 2
    assert TCB.first_mismatch([1, 2], [1, 5]) == 1


# -- quant_ladder ----------------------------------------------------------------


def test_quant_ladder_metrics_match_jax():
    from tts_inference_tpu.tools import quant_ladder as JQL

    rng = np.random.default_rng(3)
    a = np.sin(np.linspace(0, 20, 2048)).astype(np.float32)
    b = (a + 0.01 * rng.standard_normal(2048)).astype(np.float32)
    for x, y in ((a, a.copy()), (a, b), (a, b[:1500]), (a, a[:0])):
        got, want = TQL._wave_metrics(x, y), JQL._wave_metrics(x, y)
        assert got.keys() == want.keys()
        np.testing.assert_equal(got, want)
    for ref, hyp in (([1, 2, 3, 4], [1, 2, 9, 4]), ([1, 2], [1, 2]),
                     ([1, 2, 3], [1, 2]), ([5], [6, 7])):
        assert TQL._token_metrics(ref, hyp) == JQL._token_metrics(ref, hyp)
    assert [n for n, _ in TQL.LADDER] == [n for n, _ in JQL.LADDER]
    assert dict(TQL.LADDER) == dict(JQL.LADDER)
    assert TQL.PROMPTS == JQL.PROMPTS


def _jax_rung(over, tokens, ltree, stree):
    """The JAX ladder's rung runtime (its _build's config) over the numpy
    weights, built from its parts."""
    import jax

    from tts_inference_tpu.engine.engine import GenerationEngine
    from tts_inference_tpu.models.quant import quantize_llama_params
    from tts_inference_tpu.models.snac import SnacDecoder as JSnac
    from tts_inference_tpu.runtime import Runtime as JRuntime
    from tts_inference_tpu.streaming.pipeline import TTSPipeline
    from tts_inference_tpu.utils.tokenizer import ByteTokenizer

    cfg = dataclasses.replace(CFG, engine=dataclasses.replace(
        CFG.engine, max_input_len=64, max_output_len=max(tokens + 32, 128)))
    params = to_jax(ltree)
    if over.get("quantize"):
        params = quantize_llama_params(params, bits=over["weight_bits"])
    params = jax.block_until_ready(params)
    eng = GenerationEngine(params, cfg.model, cfg.engine, eos_id=P.TOKEN_EOS)
    voc = JSnac(to_jax(stree), cfg.snac)
    return JRuntime(cfg, TTSPipeline(eng, voc, ByteTokenizer(), cfg), eng,
                    voc, ByteTokenizer(), {})


@pytest.mark.parametrize("rung", ["bf16", "int4_g128"])
def test_quant_ladder_rung_matches_jax(rung, trees, monkeypatch):
    """A rung's greedy tokens equal the JAX ladder's, and its
    teacher-forced logits are within 1e-4 relative RMS of JAX's."""
    from tts_inference_tpu.tools import quant_ladder as JQL

    ltree, stree = trees
    over = dict(TQL.LADDER)[rung]
    tokens = 28
    if over.get("group"):
        monkeypatch.setenv("TTS_INT4_GROUP", str(over["group"]))
    jrt = _jax_rung(over, tokens, ltree, stree)
    monkeypatch.delenv("TTS_INT4_GROUP", raising=False)
    trt = TQL._build(over, tiny=True, seed=0, tokens=tokens, device="cpu",
                     llama_tree=ltree, snac_tree=stree)
    if rung != "bf16":
        assert type(trt.engine.core.params["layers"][0]["wq"]).__name__ \
            == "QuantLinearI4"
    want = JQL._gen_tokens(jrt, TQL.PROMPTS[0], tokens, seed=0)
    got = TQL._gen_tokens(trt, TQL.PROMPTS[0], tokens, seed=0)
    assert got == want and len(got) == tokens
    lw = JQL._tf_logits(jrt, want)
    lg = TQL._tf_logits(trt, got)
    n = len({int(x) for x in np.linspace(8, tokens, 24)})   # 21 positions
    assert lg.shape == lw.shape == (n, CFG.model.vocab_size)
    rel = np.sqrt(np.mean((lg - lw) ** 2)) / np.sqrt(np.mean(lw ** 2))
    assert rel <= 1e-4, rel
    tf = TQL._teacher_forced(lg, lw)
    assert tf["tf_argmax_agree"] == 1.0 and tf["tf_positions"] == n


def test_run_ladder_in_process_has_every_rungs_keys():
    """The JAX slow case's checks on a short in-process ladder."""
    out = TQL.run_ladder(tiny=True, tokens=42, utterances=1, seed=0,
                         device="cpu")
    rungs = out["rungs"]
    assert set(rungs) == {n for n, _ in TQL.LADDER}
    assert rungs["bf16"]["utterances"][0]["audio_s"] > 0.3
    assert rungs["bf16"]["launches"] == {}        # no kernel on the CPU
    for name in ("int8", "int8+kv8", "int4_g512", "int4_g128"):
        e = rungs[name]
        assert "error" not in e
        assert np.isfinite(e["mse"]) and np.isfinite(e["corr"])
        assert 0.0 <= e["token_match_frac"] <= 1.0
        for k in ("max_diff", "build_s", "tf_argmax_agree",
                  "tf_logit_rel_rms", "tf_positions", "utterances"):
            assert k in e, (name, k)
        assert e["tf_logit_rel_rms"] < 1.0
    assert rungs["int8"]["tf_logit_rel_rms"] < \
        rungs["int4_g512"]["tf_logit_rel_rms"]


# -- make_artifacts ----------------------------------------------------------------


def test_make_artifacts_writes_under_build_and_passes(tmp_path, monkeypatch,
                                                      capsys):
    """The default --out is build/artifacts_torch under the working
    directory (never artifacts/); the gate passes on the CPU."""
    monkeypatch.chdir(tmp_path)
    assert TMA.main(["--device", "cpu", "--tokens", "140"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = tmp_path / "build" / "artifacts_torch"
    assert line["passed"] and line["max_lsb_diff"] <= 2
    assert line["stream_wav"] == os.path.join("build", "artifacts_torch",
                                              "tiny_stream.wav")
    assert sorted(os.listdir(out)) == ["fidelity.json", "tiny_batch.wav",
                                       "tiny_stream.wav"]
    assert not (tmp_path / "artifacts").exists()
    rep = json.loads((out / "fidelity.json").read_text())
    assert rep["artifact_gate"]["passed"] and rep["pass"]
    assert rep["request"]["tokens"] == 140 and rep["request"]["chunks"] >= 2
