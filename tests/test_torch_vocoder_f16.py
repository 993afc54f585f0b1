"""PyTorch port, the float16 vocoder (``SnacConfig.dtype="float16"``) and the
16-bit K6 wrapper's plan, on the CPU: K6's plain version in float16 against
the JAX package's Pallas kernel (interpret mode) and its XLA unit; the
port's float16 decode against the JAX package's float16 and f32 decodes on
the same weights, codes and noise; windowed against batch decode in
float16; which path (the copy engine or the block's gather) the wrapper
gives x and the weight at each layout, stride and offset the kernel phase
of ``chip_smoke.py`` uses, and the plan of its serve shapes. Inputs are
numpy from fixed seeds."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tts_inference_tpu import protocol as P
from tts_inference_tpu.config import SnacConfig, StreamConfig
from tts_inference_tpu.models import snac as js
from tts_inference_tpu.ops.pallas.vocoder import (
    fused_residual_unit as j_fused_unit)
from tts_inference_tpu_torch import weights as W
from tts_inference_tpu_torch.models import snac as ts
from tts_inference_tpu_torch.ops import vocoder as tvoc
from tts_inference_tpu_torch.streaming.lookahead import \
    LookaheadStreamingDecoder
from tts_inference_tpu_torch.tools import vocoder_dtype_fidelity as tvdf

from tests.test_torch_kernels import torch_unit, unit_params
from tests.torch_port_helpers import (interleaved_codes, numpy_snac_tree,
                                      port_config, random_codes, to_jax)

TINY_SNAC = SnacConfig.tiny()
F16_SNAC = dataclasses.replace(TINY_SNAC, dtype="float16")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its runtimes run beside
    other files' servers, which wait on starved OpenMP threads when all
    cores are taken."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f16_step(want: np.ndarray) -> float:
    """One float16 step of the largest magnitude in `want` (a value in
    [2^e, 2^(e+1)) has steps of 2^(e-10))."""
    return 2.0 ** (math.floor(math.log2(float(np.abs(want).max()))) - 10)


def _f16_tree(tree):
    if isinstance(tree, dict):
        return {k: _f16_tree(v) for k, v in tree.items()}
    return tree.half()


# -- K6's plain version in float16 --------------------------------------------


@pytest.mark.parametrize("dil", [1, 3, 9])
def test_k6_f16_plain_matches_jax(dil):
    """In float16 the plain version (torch's float16 operations, each
    rounding) is within two float16 steps of the largest output of the
    Pallas kernel in interpret mode and of the JAX package's XLA unit on the
    same float16 inputs (measured: 0.5–1 step), with per-row valid lengths;
    rows past their length are zero."""
    rng = np.random.default_rng(dil)
    b, t, c = 2, 128, 64
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    valid = np.array([t, 77], np.int32)
    x[1, 77:] = 0.0
    p = unit_params(c, seed=10 + dil)
    x16 = jnp.asarray(x, jnp.float16)
    jp = {k: (jnp.asarray(v, jnp.float16) if not isinstance(v, dict)
              else {kk: jnp.asarray(vv, jnp.float16) for kk, vv in v.items()})
          for k, v in p.items()}
    jv = jnp.asarray(valid)
    want_kernel = np.asarray(j_fused_unit(x16, jp, dil, valid=jv,
                                          interpret=True)).astype(np.float32)
    want_xla = np.asarray(js._residual_unit(x16, jp, dil, groups=c,
                                            valid=jv)).astype(np.float32)
    n16 = tvoc.launches_f16.count
    got = tvoc.fused_residual_unit(torch.from_numpy(x).half(),
                                   _f16_tree(torch_unit(p)), dil,
                                   torch.from_numpy(valid))
    assert got.dtype == torch.float16
    assert tvoc.launches_f16.count == n16      # the CPU launches nothing
    got = got.float().numpy()
    for want in (want_kernel, want_xla):
        assert np.abs(got - want).max() <= 2 * f16_step(want)
    assert not got[1, 77:].any()


# -- the float16 decode ---------------------------------------------------------


@pytest.fixture(scope="module")
def snac_pair():
    tree = numpy_snac_tree(TINY_SNAC, seed=1)
    return to_jax(tree), W.snac_params_from_jax(tree)


DECODE_NOISE = dict(noise_seed=[3, 4], latent_offset=[0, 8],
                    valid_latent=[24, 17])


@pytest.fixture(scope="module")
def jax_decodes(snac_pair):
    """The JAX package's f32 and float16 decodes of the codes of
    ``test_decode_codes_f16_matches_jax``, made once (~20 s together)."""
    jp, _ = snac_pair
    codes = random_codes(np.random.default_rng(5), TINY_SNAC, 6, batch=2)
    kw = dict(noise_seed=jnp.asarray(DECODE_NOISE["noise_seed"], jnp.uint32),
              latent_offset=jnp.asarray(DECODE_NOISE["latent_offset"],
                                        jnp.uint32),
              valid_latent=jnp.asarray(DECODE_NOISE["valid_latent"],
                                       jnp.int32))
    jcodes = [jnp.asarray(c) for c in codes]
    j32 = np.asarray(js.decode_codes(jp, TINY_SNAC, jcodes, **kw))
    jdec = js.SnacDecoder(jp, F16_SNAC)
    j16 = np.asarray(js.decode_codes(jdec.params, F16_SNAC, jcodes, **kw))
    return codes, j32, j16


def test_decode_codes_f16_matches_jax(snac_pair, jax_decodes):
    """The port's float16 decode against the JAX package's, on the same
    weights, codes and noise (before the 16-bit body had a float16 instance,
    the port's wrapper raised at the first residual unit). Both round every
    conv output to float16 at different places, so each is one realisation
    of float16 rounding noise: the port's distance to the JAX float16
    decode is measured against JAX's own f32-vs-float16 distance (1.02× it;
    bound 1.5×, as for bf16), and the port's distance to the JAX f32 decode
    must be no larger than JAX's own float16 decode's (0.96×; bound 1.25×).
    The decode casts every f32 leaf once, keeps f32 PCM, and passes the
    fidelity tool's four thresholds against the JAX f32 decode."""
    _, tp = snac_pair
    codes, j32, j16 = jax_decodes
    tdec = ts.SnacDecoder(tp, port_config(F16_SNAC))
    assert tdec.params["decoder"]["out_conv"]["w"].dtype == torch.float16
    assert tdec.params["quantizer"][0]["codebook"].dtype == torch.float16
    kw = dict(noise_seed=torch.tensor(DECODE_NOISE["noise_seed"]),
              latent_offset=torch.tensor(DECODE_NOISE["latent_offset"]),
              valid_latent=torch.tensor(DECODE_NOISE["valid_latent"],
                                        dtype=torch.int32))
    t16 = ts.decode_codes(tdec.params, tdec.cfg,
                          [torch.from_numpy(c) for c in codes], **kw)
    assert t16.dtype == torch.float32
    t16 = t16.numpy()
    assert np.isfinite(t16).all()
    jax_own = np.linalg.norm(j16 - j32)
    assert jax_own > 0
    assert np.linalg.norm(t16 - j16) <= 1.5 * jax_own
    assert np.linalg.norm(t16 - j32) <= 1.25 * jax_own
    assert tvdf.fidelity(j32, t16)["pass"]


def test_windowed_decode_equals_batch_decode_f16(snac_pair):
    """Inside the port's float16 path, windowed streaming decode reproduces
    one batch decode on the CPU within 1 PCM16 LSB (the f32 path's CPU
    bound; measured 0). Torch's CPU float16 transposed convolution alone
    rounds by the input's length and put windows 8 LSB from the batch
    decode; the decoder takes it as a zero-stuffed convolution
    (``models/snac.py::_upsample``)."""
    _, tp = snac_pair
    dec = ts.SnacDecoder(tp, port_config(F16_SNAC),
                         frame_buckets=(8, 16, 32, 64))
    rng = np.random.default_rng(6)
    codes = interleaved_codes(rng, TINY_SNAC, 40)
    l1, l2, l3 = P.deinterleave_frames(np.asarray(codes, np.int32))
    full = dec.decode_frames(l1, l2, l3, noise_seed=7)
    la = LookaheadStreamingDecoder(dec, port_config(StreamConfig()),
                                   noise_seed=7)
    chunks = []
    for i in range(0, len(codes), P.FRAME_SIZE):
        la.feed(codes[i:i + P.FRAME_SIZE])
        out = la.poll()
        if out is not None:
            chunks.append(out)
    chunks.append(la.flush())
    got = np.concatenate([c for c in chunks if c is not None])
    assert got.shape == full.shape
    pcm = lambda a: ts.to_pcm16(torch.from_numpy(a)).numpy().astype(int)  # noqa: E731
    assert np.abs(pcm(got) - pcm(full)).max() <= 1


# -- the 16-bit wrapper's plan ---------------------------------------------------


def _x_view(b, t, c, layout, dtype=torch.bfloat16):
    """x as the kernel phase builds it: the decoder's channel-first storage
    viewed (B, T, C), the same starting one element in, or channel-last."""
    if layout == "channel-first":
        return torch.zeros(b, c, t, dtype=dtype).transpose(1, 2)
    if layout == "offset":
        return torch.zeros(b, c, t + 1, dtype=dtype)[:, :, 1:].transpose(1, 2)
    return torch.zeros(b, t, c, dtype=dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """A view of `t`'s storage copy whose first element lies on 16 bytes
    (the CPU allocator gives no such promise; the card's does)."""
    n = t.numel()
    buf = torch.zeros(n + 8, dtype=t.dtype)
    off = (-buf.data_ptr() % 16) // t.element_size()
    return buf[off:off + n].view(t.shape)


@pytest.mark.parametrize("c,t,layout,x_tma,w_tma", [
    # the serve shapes: channel-first, T a multiple of 8, C the tile's
    (512, 512, "channel-first", True, True),
    (256, 4096, "channel-first", True, True),
    (128, 16384, "channel-first", True, True),
    (64, 32768, "channel-first", True, True),
    (512, 256, "channel-first", True, True),     # the first chunk at batch 1
    # the edges: T no multiple of 8, one element in, channel-last, fewer
    # channels than the tile (the weight too: no whole box, or c % 8)
    (128, 100, "channel-first", False, True),
    (256, 256, "offset", False, True),
    (512, 96, "channel-last", False, True),
    (64, 700, "channel-last", False, True),
    (100, 260, "channel-first", False, False),
    (300, 70, "channel-first", False, False),
    (32, 512, "channel-first", False, False),
    (7, 64, "channel-first", False, False),
    (64, 20, "channel-first", False, True),      # T under one box
])
def test_paths16_follow_the_layout(c, t, layout, x_tma, w_tma):
    """``paths16`` gives x to the copy engine only where a tensor map
    describes it (channel-first, 16-byte start and pitches, whole boxes of
    channels, T of a box at least) and the weight where its rows are whole
    16-byte boxes; everything else is gathered by the block."""
    x = _x_view(3, t, c, layout)
    if layout != "offset":
        x = _aligned(x.transpose(1, 2).contiguous()).transpose(1, 2) \
            if layout == "channel-first" else _aligned(x.contiguous())
    else:
        full = _aligned(torch.zeros(3, c, t + 8, dtype=torch.bfloat16))
        x = full[:, :, 1:t + 1].transpose(1, 2)
    w = _aligned(torch.zeros(c, c, 1, dtype=torch.bfloat16))
    assert tvoc.paths16(x, w) == (x_tma, w_tma)
    # a weight that starts off 16 bytes is always gathered
    off = _aligned(torch.zeros(c * c + 1, dtype=torch.bfloat16))[1:]
    assert tvoc.paths16(x, off.view(c, c, 1)) == (x_tma, False)


@pytest.mark.parametrize("b,frames", [(8, 16), (1, 8)])
def test_plan16_fills_the_card(b, frames):
    """At the serve shapes (the 12 units of an 8-row, 16-frame call; the
    first chunk at batch 1) the plan's segments are whole multiples of 32
    steps, the grid fits one block an SM of a 132-SM card and splits C 512's
    tiles in two, and every (row, tile) item has a block: at batch 8 every
    width fills at least 128 SMs."""
    for c, t_frame in ((512, 32), (256, 256), (128, 1024), (64, 2048)):
        t = frames * t_frame
        seg, blocks = tvoc.plan16(b, t, c, 132)
        s, split = tvoc.SEGMENTS16[c], tvoc.SPLIT16[c]
        items = b * -(-t // (s * seg))
        assert seg % 32 == 0 and blocks % split == 0
        assert blocks <= 132 and blocks // split <= items
        if b == 8:
            assert blocks >= 128
