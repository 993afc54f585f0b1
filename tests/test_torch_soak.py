"""PyTorch port, the soak harness (``tools/soak.py``) on the CPU:

- the twin of tests/test_soak.py (slow, as that file is): randomized churn
  over the tiny scheduler ends clean within the JAX tool's gates;
- a short run on a tiny paged on-demand pool that preempts, where resumes,
  cancels and the held queue meet: it asserts only what a busy CPU cannot
  make flaky — no error event, no slot or block leak, the vocode queue
  drained, every submission accounted for — and leaves the RSS and TTFA
  drift gates to the card;
- the tool's command line over that pool.
"""

import dataclasses
import json

import pytest
import torch

from tts_inference_tpu.config import tiny_config
from tts_inference_tpu_torch.engine.scheduler import Scheduler
from tts_inference_tpu_torch.runtime import Runtime
from tts_inference_tpu_torch.tools import soak

from tests.torch_port_helpers import (numpy_llama_tree, numpy_snac_tree,
                                      port_config)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite runs it beside
    other files' CPU-bound workers and servers, which wait on starved
    OpenMP threads when every worker takes all the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runtime(cfg):
    return Runtime.create(port_config(cfg), device="cpu",
                          llama_tree=numpy_llama_tree(cfg.model, seed=0),
                          snac_tree=numpy_snac_tree(cfg.snac, seed=1))


def _soak(cfg, **kw):
    rt = _runtime(cfg)
    sched = Scheduler(rt.engine.core.params, rt.config, rt.vocoder,
                      rt.tokenizer)
    sched.start()
    try:
        return soak.run_soak(sched, **kw), sched
    finally:
        sched.stop()


@pytest.mark.slow
def test_soak_short():
    report, _ = _soak(tiny_config(), duration_s=6.0, warm_s=3.0,
                      target_streams=3, cancel_rate=0.15, seed=1,
                      rss_limit_mb=256.0)
    assert report["ok"], report


def test_soak_on_a_preempting_pool():
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, paged_kv=True, kv_cache_int8=True, kv_on_demand=True,
        kv_block_size=32, kv_pool_tokens=6 * 32, resume_buckets=(128, 256)))
    report, sched = _soak(cfg, duration_s=3.0, warm_s=0.0, target_streams=4,
                          max_tokens_range=(40, 90), cancel_rate=0.2, seed=3)
    assert report["hard_ok"], report
    assert report["errors"] == 0 and report["completed"] == report[
        "submitted"] > 0
    assert report["slots_held_at_end"] == report["kv_tokens_held_at_end"] == 0
    assert report["vocode_pending_at_end"] == 0
    assert sched.core.free_tokens() == 6 * 32
    # the pool preempts (seed and lengths fixed); the CPU launches
    # eagerly: resumes are counted, none replayed
    assert report["preemptions"] >= 1
    assert report["resumes"] == report["preemptions"]
    assert report["resume_replays"] == 0 and report["late_captures"] == 0
    assert {"rss_growth_mb", "ttfa_drift", "rss_limit_mb",
            "drift_limit"} <= set(report)


def test_soak_command_line(capsys):
    rc = soak.main(["--duration", "1.5", "--streams", "2",
                    "--seed", "2", "--tiny", "--device", "cpu",
                    "--no-warmup", "--paged-kv", "--kv-on-demand",
                    "--kv-block-size", "32", "--kv-pool-tokens", "256",
                    "--native-protocol"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["hard_ok"], report
    assert rc == (0 if report["ok"] else 1)
