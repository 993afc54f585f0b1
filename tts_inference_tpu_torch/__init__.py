"""tts_inference_tpu_torch — the PyTorch/CUDA port of tts_inference_tpu.

The JAX package ``tts_inference_tpu`` stays the reference; this package is
its counterpart for one NVIDIA H100, module for module and with the same
public names:

    ops/decode_attention.py   K1 decode attention (csrc/decode_attention.cu)
    ops/paged_attention.py    K3a / K3b paged decode attention, bf16 or int8
    ops/paged_attention_int4.py  K5, int4 pools (csrc/paged_attention.cu)
    ops/int4_matmul.py        K4 int4 and K2 int8 weight-only matmuls
                              (csrc/quant_matmul.cu)
    ops/vocoder.py            K6 fused SNAC residual unit (csrc/vocoder.cu)
    ops/sampling.py           on-device sampling chain
    models/llama.py, quant.py the Orpheus-3B decoder; int8 / int4 weights
    models/snac.py            SNAC 24 kHz vocoder (f32)
    weights.py                JAX-pytree import + seeded random init
    engine/                   EngineCore / GenerationEngine / Scheduler
    streaming/                lookahead window decoder, TTSPipeline
    protocol.py, config.py, utils/   the port's own copies of the token
                              protocol, the config tree and the host helpers
    runtime.py, serving/, cli.py, tools/

It imports torch, never jax, and nothing of the JAX package: only the tests
import both. Its entry points run on cuda unless the caller asks for the
CPU.
"""

__version__ = "0.1.0"
