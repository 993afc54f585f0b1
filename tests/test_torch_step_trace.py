"""PyTorch port: ``step_profile --trace-dir`` (the JAX ``profile_decode``'s
flag) and ``utils/timing.maybe_profile`` (the JAX module's, over
torch.profiler), on the CPU."""

import collections
import json

import pytest
import torch

from tts_inference_tpu_torch.tools import step_profile
from tts_inference_tpu_torch.utils import timing


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs, beside other files'
    CPU-bound workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ops(path) -> collections.Counter:
    """Complete events of a Chrome trace, by name."""
    events = json.loads(path.read_text())["traceEvents"]
    return collections.Counter(e["name"] for e in events
                               if e.get("ph") == "X")


def test_maybe_profile_writes_a_chrome_trace(tmp_path):
    with timing.maybe_profile(None) as prof:
        torch.ones(3).sum()
    assert prof is None and not list(tmp_path.iterdir())
    with timing.maybe_profile(str(tmp_path / "t"), "probe") as prof:
        torch.mm(torch.ones(4, 4), torch.ones(4, 4))
    assert prof is not None
    assert _ops(tmp_path / "t" / "probe.json")["aten::mm"] == 1


def test_step_profile_trace_dir_names_the_profiled_launches(tmp_path,
                                                            capsys):
    """`--trace-dir DIR`: one trace of each core's profiled decode launches,
    listed in the JSON line, holding every product the launches ran —
    7 linears a layer and the head, a step — beside the step's attention
    writes and the sampler."""
    out_dir = tmp_path / "traces"
    assert step_profile.main(["--tiny", "--device", "cpu", "--launches",
                              "2", "--trace-dir", str(out_dir)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    names = sorted(p.name for p in out_dir.iterdir())
    assert names == ["decode_eager.json", "decode_replayed.json"]
    assert line["trace_files"] == sorted(str(p) for p in out_dir.iterdir())
    per_step = 7 * 2 + 1                # tiny: 2 layers
    steps = 2 * line["steps_per_launch"]
    for name in names:
        ops = _ops(out_dir / name)
        assert ops["aten::mm"] == steps * per_step, (name, ops["aten::mm"])
        assert ops["aten::index_put_"] > 0 and ops["aten::argmax"] > 0
    assert line["eager"]["wall_ms_per_step"] > 0
