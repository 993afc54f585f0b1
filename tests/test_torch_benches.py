"""PyTorch port, the measurement tools on the CPU: the chained timer of
``utils/cuda_graphs.py``; ``step_bench``, ``vocode_bench`` and
``kv_kernel_bench`` printing the JAX tools' keys at a tiny size; the
kv bench's pools held to the JAX tool's, built from the same numpy draws;
and every new tool raising without a card unless asked for the CPU."""

import json

import numpy as np
import pytest
import torch

from tts_inference_tpu_torch.tools import kv_kernel_bench as KB
from tts_inference_tpu_torch.tools import step_bench as SB
from tts_inference_tpu_torch.tools import vocode_bench as VB
from tts_inference_tpu_torch.utils.cuda_graphs import chained_ms

STEP_KEYS = ("full_us_per_step", "matmuls_us_per_step",
             "attention_us_per_step", "head_sample_us_per_step",
             "kv_write_us_per_step", "residual_us_per_step")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its boots run beside other
    files' servers, which wait on starved OpenMP threads when all cores are
    taken."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chained_ms_feeds_each_call_the_one_before():
    seen = []

    def step(c):
        seen.append(c)
        return c + 1

    ms = chained_ms(step, 0, reps=5, iters=2, device="cpu")
    assert seen == [0, 1, 2, 3, 4] * 2
    assert ms > 0.0


@pytest.mark.parametrize("flags,kv", [
    ([], "bf16/dense"),
    (["--paged-kv", "--kv-int8"], "int8/paged"),
    (["--quantize", "--weight-bits", "4", "--paged-kv", "--kv-int4"],
     "int4/paged"),
])
def test_step_bench_main_tiny_cpu(flags, kv, capsys):
    """One JSON line per component as it is measured, then the whole
    report: attention is null on the CPU (the JAX tool's answer there),
    kv_write null on a dense cache, the residual full − parts; no kernel
    runs on the CPU."""
    assert SB.main(["--tiny", "--device", "cpu", "--batch", "8", "--steps",
                    "14", "--reps", "4", "--iters", "1", *flags]) == 0
    out = capsys.readouterr().out
    lines = out[: out.index("{\n")].strip().splitlines()
    report = json.loads(out[out.index("{\n"):])
    streamed = {k: v for line in lines for k, v in json.loads(line).items()}
    paged = "--paged-kv" in flags
    assert list(streamed) == [k for k in STEP_KEYS[:5]]
    assert report["kv"] == kv and report["device"] == "cpu"
    assert report["batch"] == 8 and report["component_layers"] == 2
    # decoded on from the 64-token prefill until a timed run of 14 steps
    # ends just under the window (max_seq 320)
    assert report["start_depth"] == [64 + 7 * ((320 - 14 - 16 - 64) // 7)] * 2
    assert report["attention_us_per_step"] is None
    assert (report["kv_write_us_per_step"] is not None) == paged
    for k in STEP_KEYS:
        assert k in report
        if k not in ("attention_us_per_step", "kv_write_us_per_step"):
            assert report[k] is not None, k
    parts = sum(report[k] for k in STEP_KEYS[1:5] if report[k])
    assert report["residual_us_per_step"] == pytest.approx(
        report["full_us_per_step"] - parts, abs=0.2)
    assert all(v == {} for v in report["launches"].values())
    assert sorted(report["graphs_ms"]) == [
        "capture_decode_n7_w320", "capture_prefill_64"]


@pytest.mark.parametrize("bf16", [False, True])
def test_vocode_bench_main_tiny_cpu(bf16, capsys):
    argv = ["--tiny", "--device", "cpu", "--rows", "5", "--frames", "12",
            "--iters", "2"] + (["--bf16"] if bf16 else [])
    assert VB.main(argv) == 0
    rep = json.loads(capsys.readouterr().out)
    for k in ("rows", "frames", "dtype", "bucket", "ms_per_call",
              "emitted_audio_s_per_call", "device_rtf"):
        assert k in rep
    assert rep["dtype"] == ("bfloat16" if bf16 else "float32")
    assert rep["bucket"] == [8, 16] and rep["rows"] == 5
    assert rep["emitted_audio_s_per_call"] == round(5 * 12 * 2048 / 24000, 3)
    assert rep["ms_per_call"] > 0 and rep["calls"] == 3
    assert rep["launches"] == {} and rep["capture_ms"] is None


def test_kv_kernel_bench_pools_match_jax():
    """The bf16, int8 and int4 pools equal the JAX tool's, built from the
    same numpy draws with its expressions."""
    import jax.numpy as jnp

    from tts_inference_tpu.ops.pallas.paged_attention_int4 import (
        quantize_kv_int4, scales_to_planes)

    n, hkv, bs, d = 9, 4, 16, 32
    rng = np.random.default_rng(0)
    kf = jnp.asarray(rng.normal(size=(n, hkv, bs, d)), jnp.bfloat16)
    vf = jnp.asarray(rng.normal(size=(n, hkv, bs, d)), jnp.bfloat16)
    sc = jnp.max(jnp.abs(kf.astype(jnp.float32)), -1) / 127.0
    k8 = jnp.clip(jnp.round(kf.astype(jnp.float32) / sc[..., None]),
                  -127, 127).astype(jnp.int8)
    scv = jnp.max(jnp.abs(vf.astype(jnp.float32)), -1) / 127.0
    v8 = jnp.clip(jnp.round(vf.astype(jnp.float32) / scv[..., None]),
                  -127, 127).astype(jnp.int8)
    k4n, k4sn = quantize_kv_int4(jnp.moveaxis(kf, 1, 2))
    v4n, v4sn = quantize_kv_int4(jnp.moveaxis(vf, 1, 2))
    want = {"bf16": (kf, vf),
            "int8": (k8, v8, sc, scv),
            "int4": (jnp.moveaxis(k4n, 1, 2), jnp.moveaxis(v4n, 1, 2),
                     jnp.moveaxis(scales_to_planes(k4sn), 1, 3),
                     jnp.moveaxis(scales_to_planes(v4sn), 1, 3))}

    tkf, tvf = KB.bf16_pools(np.random.default_rng(0), n, hkv, bs, d, "cpu")
    got = {"bf16": (tkf, tvf), "int8": KB.int8_pools(tkf, tvf),
           "int4": KB.int4_pools(tkf, tvf)}
    for kind in want:
        for g, w in zip(got[kind], want[kind]):
            w = np.asarray(w.astype(jnp.float32) if w.dtype == jnp.bfloat16
                           else w)
            assert tuple(g.shape) == w.shape, kind
            np.testing.assert_array_equal(g.float().numpy()
                                          if g.dtype == torch.bfloat16
                                          else g.numpy(), w, err_msg=kind)


def test_kv_kernel_bench_main_cpu(capsys):
    assert KB.main(["--device", "cpu", "--b", "2", "--wb", "2", "--bs", "16",
                    "--hkv", "2", "--g", "3", "--d", "16", "--reps",
                    "3"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("shape: B=2 W=32 Hkv=2 G=3 D=16")
    assert [ln.split(":")[0].strip() for ln in lines[1:4]] == \
        ["bf16", "int8", "int4"]
    assert lines[4].startswith("  int4 speedup vs int8:")
    rep = json.loads(lines[5])
    assert set(rep["us_per_layer_step"]) == {"bf16", "int8", "int4"}
    assert rep["int4_speedup_vs_int8"] == pytest.approx(
        rep["us_per_layer_step"]["int8"] / rep["us_per_layer_step"]["int4"])
    assert rep["launches"] == {} and rep["w"] == 32


@pytest.mark.parametrize("tool,argv", [
    ("step_bench", ["--tiny"]),
    ("vocode_bench", ["--tiny"]),
    ("kv_kernel_bench", ["--b", "2", "--wb", "1", "--bs", "16"]),
    ("quant_ladder", ["--tiny"]),
    ("compare_backends", ["--tiny"]),
    ("lookahead_sweep", ["--tiny"]),
    ("sos_ablation", ["--tiny", "--tokens-json", "-"]),
    ("make_artifacts", []),
])
def test_tools_need_a_card_unless_asked_for_the_cpu(tool, argv, monkeypatch,
                                                    tmp_path):
    import importlib

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"tts_inference_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)


@pytest.mark.parametrize("prefill_len,window", [(None, 64), (60, 128)])
def test_step_profile_prefill_len_sets_the_decode_window(prefill_len,
                                                         window):
    """``step_profile --prefill-len`` (the JAX ``profile_decode``'s flag)
    admits that many tokens, so the decode runs at the window that depth
    needs; without it, the short prompt's."""
    import dataclasses

    from tts_inference_tpu_torch.config import tiny_config
    from tts_inference_tpu_torch.engine.engine import EngineCore
    from tts_inference_tpu_torch.runtime import Runtime
    from tts_inference_tpu_torch.tools import step_profile

    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, kv_buckets=(64, 128, 256)))
    rt = Runtime.create(cfg, device="cpu")
    core = EngineCore(rt.engine.core.params, cfg.model, cfg.engine,
                      device="cpu")
    out = step_profile.decode_launches(rt, core, 1, prefill_len)
    assert out["wall_ms_per_step"] > 0
    assert sorted(k for k in core.graph_census_ms if "decode" in k) == \
        [f"capture_decode_n7_w{window}"]
