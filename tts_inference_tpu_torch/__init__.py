"""tts_inference_tpu_torch — the PyTorch/CUDA port of tts_inference_tpu.

The JAX package ``tts_inference_tpu`` stays the reference; this package is
its counterpart for one NVIDIA H100, module for module and with the same
public names:

    ops/decode_attention.py   K1 decode attention (csrc/decode_attention.cu)
    ops/vocoder.py            K6 fused SNAC residual unit (csrc/vocoder.cu)
    ops/sampling.py           on-device sampling chain
    models/llama.py, quant.py the Orpheus-3B decoder (dense bf16 path)
    models/snac.py            SNAC 24 kHz vocoder (f32)
    weights.py                JAX-pytree import + seeded random init
    engine/                   EngineCore / GenerationEngine / Scheduler
    streaming/                lookahead window decoder, TTSPipeline
    runtime.py, serving/, cli.py

It imports torch and never jax; of the JAX package it reuses only the
jax-free modules (protocol, config, utils.audio, utils.tokenizer, the
``PhaseTimer`` of utils.timing and the aiohttp server class).
"""

__version__ = "0.1.0"
