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

from tts_inference_tpu import protocol
from tts_inference_tpu.config import Config
from tts_inference_tpu.utils.tokenizer import ByteTokenizer
from tts_inference_tpu_torch import weights
from tts_inference_tpu_torch.engine.engine import GenerationEngine
from tts_inference_tpu_torch.models.snac import SnacDecoder
from tts_inference_tpu_torch.streaming.pipeline import TTSPipeline


def default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


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
               snac_tree: Optional[Dict] = None) -> "Runtime":
        """Random weights from `seed` (LM: seed, vocoder: seed + 1, like the
        JAX package), or the JAX pytrees `llama_tree` / `snac_tree`."""
        config = config or Config()
        dev = torch.device(device) if device is not None else default_device()
        timings = {}

        t0 = time.perf_counter()
        params = (weights.llama_params_from_jax(llama_tree, dev)
                  if llama_tree is not None
                  else weights.init_llama_params(config.model, seed, dev))
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
            engine.warmup()
            timings["warmup_s"] = time.perf_counter() - t0
        return cls(config, pipeline, engine, vocoder, tokenizer, timings,
                   dev)
