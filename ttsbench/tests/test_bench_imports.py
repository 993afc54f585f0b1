"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names."""

import subprocess
import sys
from pathlib import Path

from ttsbench import run

ROOT = Path(__file__).resolve().parents[2]


def test_whole_name_comparison(monkeypatch):
    monkeypatch.setitem(sys.modules, "tts_inference_tpu_torch_fake", object())
    assert "tts_inference_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tts_inference_tpu.config", object())
    assert run.forbidden_modules() == ["tts_inference_tpu"]
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert "jaxlib" in run.forbidden_modules()


def test_harness_and_port_load_no_jax():
    code = ("import ttsbench.run as r, ttsbench.serve, ttsbench.check, "
            "ttsbench.readers, ttsbench.loadgen, "
            "tts_inference_tpu_torch.serving.app, "
            "tts_inference_tpu_torch.engine.scheduler, "
            "tts_inference_tpu_torch.runtime; print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_port():
    for f in (ROOT / "ttsbench" / "reference").glob("*.py"):
        text = f.read_text()
        assert "tts_inference_tpu" not in text, f
        assert "import jax" not in text, f
