"""The port keeps its own copies of the JAX package's jax-free modules
(protocol, config, utils.audio, utils.tokenizer, utils.timing). These cases
hold each copy to its original on seeded inputs."""

import dataclasses

import numpy as np
import pytest

from tts_inference_tpu import config as jcfg
from tts_inference_tpu import protocol as jP
from tts_inference_tpu.utils import audio as jaudio
from tts_inference_tpu.utils import tokenizer as jtok
from tts_inference_tpu_torch import config as tcfg
from tts_inference_tpu_torch import protocol as tP
from tts_inference_tpu_torch.utils import audio as taudio
from tts_inference_tpu_torch.utils import timing as ttiming
from tts_inference_tpu_torch.utils import tokenizer as ttok

from tests.torch_port_helpers import port_config


def test_protocol_constants_equal():
    names = [n for n in dir(jP) if n.isupper()]
    assert len(names) >= 15
    for n in names:
        assert getattr(tP, n) == getattr(jP, n), n


def _token_stream(seed, n_frames):
    rng = np.random.default_rng(seed)
    toks = [int(rng.integers(0, 128000)) for _ in range(3)] + [jP.TOKEN_SOS]
    for _ in range(n_frames):
        for p in range(jP.FRAME_SIZE):
            toks.append(jP.TOKEN_AUDIO_BASE + jP.POSITION_OFFSETS[p]
                        + int(rng.integers(0, jP.CODEBOOK_SIZE)))
    toks.insert(9, 77)                       # a stray text token mid-speech
    return toks + [jP.TOKEN_EOS]


@pytest.mark.parametrize("seed,n_frames", [(0, 1), (1, 5), (2, 12)])
def test_protocol_frame_helpers_equal(seed, n_frames):
    toks = _token_stream(seed, n_frames)
    prompt = [300 + i for i in range(seed + 3)]
    for fs in (False, True):
        assert (tP.format_prompt_ids(prompt, force_speech=fs)
                == jP.format_prompt_ids(prompt, force_speech=fs))
    je, te = jP.TokenExtractor(), tP.TokenExtractor()
    jc, tc = je.feed_many(toks), te.feed_many(toks)
    assert tc == jc and len(tc) >= 7 * n_frames - 7
    n = len(jc) // jP.FRAME_SIZE * jP.FRAME_SIZE
    for a, b in zip(tP.deinterleave_frames(tc[:n]),
                    jP.deinterleave_frames(jc[:n])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("make", ["Config", "tiny_config", "ModelConfig.tiny",
                                  "SnacConfig.tiny"])
def test_configs_equal_field_by_field(make):
    def build(mod):
        obj = mod
        for part in make.split("."):
            obj = getattr(obj, part)
        return obj()

    j, t = build(jcfg), build(tcfg)
    assert type(t).__module__ == "tts_inference_tpu_torch.config"
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [f.name for f in dataclasses.fields(t)] == [
        f.name for f in dataclasses.fields(j)]
    assert port_config(j) == t
    if make == "Config":
        assert t.engine.max_seq_len == j.engine.max_seq_len == 4608
        assert t.snac.samples_per_frame == j.snac.samples_per_frame


@pytest.mark.parametrize("base,max_seq", [((256, 512, 1024, 2048, 4096), 4608),
                                          ((256, 512), 12160), ((64,), 64)])
def test_extended_kv_buckets_equal(base, max_seq):
    assert (tcfg.extended_kv_buckets(base, max_seq)
            == jcfg.extended_kv_buckets(base, max_seq))


def test_audio_helpers_equal(tmp_path):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(5000) * 0.7).astype(np.float32)
    x[:4] = [1.5, -1.5, 1.0, -1.0]           # clipping
    pcm = jaudio.pcm16_bytes(x)
    assert taudio.pcm16_bytes(x) == pcm
    assert taudio.wav_bytes(pcm) == jaudio.wav_bytes(pcm)
    assert taudio.duration_s(pcm) == jaudio.duration_s(pcm)
    taudio.write_wav(str(tmp_path / "t.wav"), pcm)
    jaudio.write_wav(str(tmp_path / "j.wav"), pcm)
    assert ((tmp_path / "t.wav").read_bytes()
            == (tmp_path / "j.wav").read_bytes())


def test_byte_tokenizer_equal():
    text = "tara: héllo wörld — 日本"
    j, t = jtok.ByteTokenizer(), ttok.ByteTokenizer()
    ids = j.encode(text)
    assert t.encode(text) == ids
    assert t.decode(ids) == j.decode(ids) == text
    assert isinstance(ttok.load_tokenizer(None), ttok.ByteTokenizer)


def test_phase_timer_equal():
    from tts_inference_tpu.utils import timing as jtiming

    t = ttiming.PhaseTimer()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    t.push("chunk_ms", 1.5)
    assert t.mark("first") == t.mark("first")
    d = t.as_dict()
    assert set(d) == {"a", "first", "chunk_ms"} and d["chunk_ms"] == [1.5]
    j = jtiming.PhaseTimer()
    with j.phase("a"):
        pass
    j.push("chunk_ms", 1.5)
    j.mark("first")
    assert set(j.as_dict()) == set(d)
