"""The plain references against the port at a tiny size on the CPU: the
decoder's logits (prefill through the port's cache), reached through the
configuration's family, and the vocoder's whole-utterance decode."""

import numpy as np
import torch

from ttsbench import families, weights
from ttsbench.reference import protocol as P
from ttsbench.reference import snac as ref_snac
from ttsbench.tests.tiny import TINY_MODEL, TINY_OPEN

LLAMA = families.of(TINY_MODEL)


def test_prompt_envelope_matches_the_port():
    from tts_inference_tpu_torch import protocol
    from tts_inference_tpu_torch.utils.tokenizer import ByteTokenizer

    ids = ByteTokenizer().encode(protocol.format_prompt_text("hi there",
                                                             "tara"))
    assert P.prompt_ids("hi there", "tara") == \
        protocol.format_prompt_ids(ids, force_speech=True)


def test_decoder_logits_match_the_port():
    from tts_inference_tpu_torch.models import llama

    cfg = LLAMA.port_config(TINY_MODEL, TINY_OPEN).model
    params = LLAMA.make_weights(TINY_MODEL, 5, "cpu")
    ids = P.prompt_ids("a short line", "tara") + list(
        range(P.AUDIO_BASE, P.AUDIO_BASE + 40 * 97, 97))
    t = len(ids)
    cache = llama.init_kv_cache(cfg, 1, 128, dtype=torch.float32)
    hidden, _ = llama.forward(params, cfg, torch.tensor([ids]), cache,
                              torch.zeros(1, dtype=torch.int32),
                              torch.tensor([t], dtype=torch.int32))
    lo, hi = P.AUDIO_RANGE
    got = llama.compute_logits(params, cfg, hidden[0], P.HEAD_BASE)
    got = got[:, lo - P.HEAD_BASE: hi - P.HEAD_BASE]
    want = LLAMA.logits(params, TINY_MODEL, ids, 0, lo, hi)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() < 1e-4


def test_untied_head_matches_the_port():
    from tts_inference_tpu_torch.models import llama

    model = dict(TINY_MODEL, tie_word_embeddings=False)
    cfg = LLAMA.port_config(model, TINY_OPEN).model
    params = LLAMA.make_weights(model, 6, "cpu")
    assert "lm_head" in params
    ids = P.prompt_ids("untied", "tara")
    cache = llama.init_kv_cache(cfg, 1, 64, dtype=torch.float32)
    hidden, _ = llama.forward(params, cfg, torch.tensor([ids]), cache,
                              torch.zeros(1, dtype=torch.int32),
                              torch.tensor([len(ids)], dtype=torch.int32))
    lo, hi = P.AUDIO_RANGE
    got = llama.compute_logits(params, cfg, hidden[0], lo)[:, : hi - lo]
    want = LLAMA.logits(params, model, ids, 0, lo, hi)
    assert (got - want).abs().max().item() < 1e-4


def test_vocoder_matches_the_port():
    from tts_inference_tpu_torch.config import SnacConfig
    from tts_inference_tpu_torch.models.snac import SnacDecoder

    snac = weights.make_snac(3, "cpu")
    rng = np.random.default_rng(0)
    toks = [P.AUDIO_BASE + p * P.CODEBOOK + int(rng.integers(P.CODEBOOK))
            for _ in range(5) for p in range(P.FRAME)]
    layers = P.layers_of(toks)
    got = SnacDecoder(snac, SnacConfig()).decode_frames(*layers,
                                                        noise_seed=7)
    want = ref_snac.decode(snac, layers, noise_seed=7).numpy()
    assert got.shape == want.shape == (5 * 2048,)
    assert np.abs(got - want).max() < 1e-5
    assert np.abs(ref_snac.pcm16(torch.from_numpy(got)).astype(int)
                  - ref_snac.pcm16(torch.from_numpy(want))).max() <= 1
