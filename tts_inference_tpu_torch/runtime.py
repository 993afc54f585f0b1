"""Runtime assembly: config + weights → ready TTSPipeline.

Port of ``tts_inference_tpu/runtime.py`` without checkpoint loading, the XLA
cache or ``aot-compile``: the weights are either seeded random ones, made on
the target device, or the JAX package's parameter pytrees (numpy leaves)
passed in — how the tests give both packages the same model.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import torch

from tts_inference_tpu_torch import protocol
from tts_inference_tpu_torch.config import Config
from tts_inference_tpu_torch.utils.tokenizer import ByteTokenizer
from tts_inference_tpu_torch import weights
from tts_inference_tpu_torch.engine.engine import GenerationEngine
from tts_inference_tpu_torch.models.quant import quantize_llama_params
from tts_inference_tpu_torch.models.snac import SnacDecoder
from tts_inference_tpu_torch.streaming.pipeline import TTSPipeline


def default_device() -> torch.device:
    """The card. The port serves from the CPU only when the caller asks for
    it (``device="cpu"``, ``--device cpu``): a machine without a working
    CUDA device is an error, never a quiet change of device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: tts_inference_tpu_torch runs on cuda by "
            "default; pass device='cpu' (--device cpu) to run on the CPU")
    return torch.device("cuda")


@dataclasses.dataclass
class Runtime:
    config: Config
    pipeline: TTSPipeline
    engine: GenerationEngine
    vocoder: SnacDecoder
    tokenizer: object
    load_timings: dict
    device: torch.device

    @classmethod
    def create(cls, config: Optional[Config] = None, *, seed: int = 0,
               device=None, warmup: bool = False,
               llama_tree: Optional[Dict] = None,
               snac_tree: Optional[Dict] = None, quantize: bool = False,
               weight_bits: int = 8) -> "Runtime":
        """Random weights from `seed` (LM: seed, vocoder: seed + 1, like the
        JAX package), or the JAX pytrees `llama_tree` / `snac_tree`. With
        `quantize` the LM weights are quantized on the device after init or
        import: weight_bits 8 = per-channel int8 everywhere, 4 = per-group
        int4 layer linears with the embedding and the head in int8."""
        config = config or Config()
        dev = torch.device(device) if device is not None else default_device()
        timings = {}

        t0 = time.perf_counter()
        params = (weights.llama_params_from_jax(llama_tree, dev)
                  if llama_tree is not None
                  else weights.init_llama_params(config.model, seed, dev))
        if quantize:
            # layer by layer, dropping each full-precision weight as it goes
            params = quantize_llama_params(params, bits=weight_bits,
                                           free_source=True)
        timings["load_model_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        vparams = (weights.snac_params_from_jax(snac_tree, dev)
                   if snac_tree is not None
                   else weights.init_snac_params(config.snac, seed + 1, dev))
        vocoder = SnacDecoder(vparams, config.snac)
        timings["load_snac_s"] = time.perf_counter() - t0
        tokenizer = ByteTokenizer()

        # first-launch burst sizes: tokens for the first stable chunk
        s = config.stream
        bursts = {(s.first_chunk_frames + s.lookahead_frames)
                  * protocol.FRAME_SIZE}
        if s.first_chunk_lookahead is not None:
            bursts.add((s.first_chunk_frames + s.first_chunk_lookahead)
                       * protocol.FRAME_SIZE)
        engine = GenerationEngine(params, config.model, config.engine,
                                  eos_id=protocol.TOKEN_EOS, seed=seed,
                                  device=dev, first_bursts=sorted(bursts))
        pipeline = TTSPipeline(engine, vocoder, tokenizer, config)
        if warmup:
            t0 = time.perf_counter()
            info = engine.warmup()
            timings["warmup_s"] = time.perf_counter() - t0
            # the graph census as the JAX package reports it: ms → s, the
            # census itself in ms
            timings.update({
                k: (v / 1000.0
                    if isinstance(v, (int, float)) and k != "graphs_compiled"
                    else v)
                for k, v in info.items()})
        return cls(config, pipeline, engine, vocoder, tokenizer, timings,
                   dev)
