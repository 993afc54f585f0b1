"""PyTorch port, the native streaming runtime (``utils/native.py`` over
``native/tts_runtime.cpp``) on the CPU:

- the five cases of tests/test_native.py against the port: the extractor
  with and without restart, deinterleave, the emission window, the restart
  count, and the scheduler's native path equal to its Python path (tokens
  and PCM byte for byte);
- the port's ``NativeExtractor`` equal to the JAX package's native and
  Python extractors on one stream;
- the lookahead decoder's native window assembly equal to its Python one;
- no fallback: with the source missing, ``Scheduler(use_native=True)``,
  ``NativeExtractor`` and ``native_deinterleave`` raise;
- builds that race (separate processes) load one library and leave no
  temporary file.

The library is built by the test run (it needs g++), never skipped.
"""

import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from tts_inference_tpu import protocol as JP
from tts_inference_tpu.config import SamplingConfig, StreamConfig, tiny_config
from tts_inference_tpu_torch import protocol as P
from tts_inference_tpu_torch.engine import scheduler as TS
from tts_inference_tpu_torch.runtime import Runtime
from tts_inference_tpu_torch.utils import native as N

from tests.torch_port_helpers import (AUDIO_RANGE, numpy_llama_tree,
                                      numpy_snac_tree, port_config)

REPO = Path(__file__).resolve().parents[1]
SCFG = StreamConfig(frames_per_chunk=2, lookahead_frames=3,
                    left_context_frames=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite runs it beside
    other files' CPU-bound workers and servers, which wait on starved
    OpenMP threads when every worker takes all the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand_tokens(rng, n=300):
    """Mixed stream: specials, text tokens, audio tokens, out-of-range."""
    toks = []
    for k in rng.integers(0, 5, size=n):
        if k == 0:
            toks.append(int(rng.integers(0, 1000)))
        elif k == 1:
            toks.append(P.TOKEN_SOS if rng.random() < 0.3
                        else P.TOKEN_DELIMITER)
        elif k == 4 and rng.random() < 0.02:
            toks.append(P.TOKEN_EOS)
        else:
            toks.append(P.TOKEN_AUDIO_BASE
                        + int(rng.integers(0, P.AUDIO_VOCAB + 50)))
    return toks


@pytest.mark.parametrize("restart", [False, True])
def test_extractor_equivalence(restart, rng):
    toks = rand_tokens(rng)
    py = P.TokenExtractor(restart_on_sos=restart)
    nat = N.NativeExtractor(restart_on_sos=restart)
    got_py, got_nat = [], []
    for i in range(0, len(toks), 11):
        got_py.extend(py.feed_many(toks[i:i + 11]))
        got_nat.extend(nat.feed_many(toks[i:i + 11]))
    assert got_nat == got_py
    assert nat.finished == py.finished
    assert nat.total_codes == len(py.codes)
    if py.codes:
        np.testing.assert_array_equal(nat.codes_range(0, len(py.codes)),
                                      np.asarray(py.codes))


def test_deinterleave_equivalence(rng):
    codes = [int(rng.integers(-100, P.AUDIO_VOCAB + 100))
             for _ in range(50 * 7)]
    for got, want in zip(N.native_deinterleave(codes),
                         P.deinterleave_frames(codes)):
        np.testing.assert_array_equal(got, want)


def test_emission_window_matches_lookahead_logic():
    spf = 2048
    # not enough pending frames → nothing
    assert N.native_emission_window(0, 6, spf, 5, 4, 2, False) is None
    # enough: emitted 0, total 10, lookahead 3 → stable 7 frames
    assert N.native_emission_window(0, 10, spf, 3, 4, 2, False) == (
        0, 10, 0, 7 * spf)
    # mid-stream: emitted 7 frames, total 14 → w0 = 7 - 4 = 3
    assert N.native_emission_window(7 * spf, 14, spf, 3, 4, 2, False) == (
        3, 14, 4 * spf, 8 * spf)
    # flush emits the tail regardless of chunk granularity
    assert N.native_emission_window(7 * spf, 9, spf, 3, 4, 2, True) == (
        3, 9, 4 * spf, 6 * spf)
    # flush with nothing left
    assert N.native_emission_window(9 * spf, 9, spf, 3, 4, 2, True) is None


def test_native_restart_count_matches_python():
    toks = [P.TOKEN_SOS, 128266 + 5, 128266 + 4096, P.TOKEN_SOS,
            128266 + 9, P.TOKEN_SOS, 128266 + 11, P.TOKEN_EOS]
    py = P.TokenExtractor(restart_on_sos=True)
    nat = N.NativeExtractor(restart_on_sos=True)
    assert py.feed_many(toks) == nat.feed_many(toks)
    assert py.restart_count == nat.restart_count == 2
    assert py.finished and nat.finished


@pytest.mark.parametrize("restart", [False, True])
def test_native_extractor_matches_jax_package(restart, rng):
    """The port's extractor, the JAX package's native one and its Python
    one on the same stream, started as force_speech starts them."""
    from tts_inference_tpu.utils import native as JN

    toks = rand_tokens(rng, 400)
    ours = N.NativeExtractor(restart_on_sos=restart, started=True)
    jnat = JN.NativeExtractor(restart_on_sos=restart, started=True)
    ref = JP.TokenExtractor(restart_on_sos=restart)
    ref.started = True
    got, want, jgot = [], [], []
    for i in range(0, len(toks), 7):
        got.extend(ours.feed_many(toks[i:i + 7]))
        jgot.extend(jnat.feed_many(toks[i:i + 7]))
        want.extend(ref.feed_many(toks[i:i + 7]))
    assert got == jgot == want
    assert ours.finished == jnat.finished == ref.finished
    assert ours.restart_count == jnat.restart_count == ref.restart_count
    assert ours.total_codes == jnat.total_codes == len(ref.codes)
    np.testing.assert_array_equal(ours.codes_range(0, ours.total_codes),
                                  jnat.codes_range(0, jnat.total_codes))


@pytest.fixture(scope="module")
def rt():
    cfg = tiny_config()
    return Runtime.create(port_config(cfg), device="cpu",
                          llama_tree=numpy_llama_tree(cfg.model, seed=0),
                          snac_tree=numpy_snac_tree(cfg.snac, seed=1))


def test_lookahead_native_window(rt, rng):
    from tts_inference_tpu_torch.streaming.lookahead import \
        LookaheadStreamingDecoder

    codes = [P.TOKEN_AUDIO_BASE + int(c)
             for c in rng.integers(0, P.AUDIO_VOCAB, 12 * 7)]
    las = [LookaheadStreamingDecoder(rt.vocoder, port_config(SCFG), 0,
                                     use_native=flag) for flag in (True,
                                                                   False)]
    for la in las:
        la.feed(codes)
    plan = las[0].plan()
    assert plan is not None and plan == las[1].plan()
    for got, want in zip(*(la.window_layers(plan) for la in las)):
        np.testing.assert_array_equal(got, want)


def _run_sched(rt, use_native):
    s = TS.Scheduler(rt.engine.core.params, rt.config, rt.vocoder,
                     rt.tokenizer, use_native=use_native)
    reqs = [TS.TTSRequest(text=f"native {i}", sampling=port_config(
        SamplingConfig(max_tokens=35, seed=90 + i, token_range=AUDIO_RANGE)),
        stream_cfg=port_config(SCFG), force_speech=True) for i in range(3)]
    for r in reqs:
        s.submit(r)
    for _ in range(2000):
        if not s.step() and s.n_queued == 0 and not s.n_active:
            break
    s.drain_vocoder()
    out = []
    for r in reqs:
        chunks = []
        while True:
            kind, payload = r.events.get(timeout=120)
            if kind == "chunk":
                chunks.append(payload.pcm)
            elif kind == "done":
                out.append((b"".join(chunks), payload.tokens))
                break
            else:
                raise AssertionError(payload)
    s.stop()
    return s, out


def test_scheduler_native_path_matches_python(rt):
    """`serve --native-protocol`: identical streams through the C++
    extractor and deinterleave."""
    s, native = _run_sched(rt, True)
    assert s.use_native
    _, python = _run_sched(rt, False)
    assert native == python
    assert all(tokens == 35 and pcm for pcm, tokens in native)


def test_missing_library_raises_and_does_not_fall_back(rt, monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(N, "SOURCE", tmp_path / "missing.cpp")
    assert not N.available()
    with pytest.raises(RuntimeError, match="not found"):
        TS.Scheduler(rt.engine.core.params, rt.config, rt.vocoder,
                     rt.tokenizer, use_native=True)
    with pytest.raises(RuntimeError):
        N.NativeExtractor()
    with pytest.raises(RuntimeError):
        N.native_deinterleave([P.TOKEN_AUDIO_BASE] * 7)
    # a source that does not compile raises with the compiler's message
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(N, "SOURCE", bad)
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="build failed"):
        N.load()


def test_racing_builds_load_one_library(tmp_path):
    """Three processes build the same source into an empty directory at
    once: each loads it, one file results, no temporary file is left."""
    src = tmp_path / "tts_runtime.cpp"
    shutil.copy(REPO / "native" / "tts_runtime.cpp", src)
    out = tmp_path / "build"
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        from pathlib import Path
        from tts_inference_tpu_torch.utils import native as N
        N.SOURCE, N.BUILD_DIR = Path({str(src)!r}), Path({str(out)!r})
        l1, l2, l3 = N.native_deinterleave(list(range(7)))
        assert (len(l1), len(l2), len(l3)) == (1, 2, 4)
        print(N.library_path(N.SOURCE).name)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    names = {p.communicate(timeout=300)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    assert len(names) == 1
    files = sorted(f.name for f in out.iterdir() if f.name != ".lock")
    assert files == list(names)
