"""Runtime assembly: config + checkpoints → ready TTSPipeline.

Port of ``tts_inference_tpu/runtime.py`` without the XLA cache or
``aot-compile`` (CUDA-graph capture at warmup takes their place). The LM
comes from an HF checkpoint dir (optionally with a LoRA adapter merged), a
pre-quantized dir written by ``cli quantize`` (``params.safetensors``), or
seeded random weights made on the target device; the vocoder from a SNAC
dir or seeded random weights (a SNAC dir's ``config.json`` gives the
geometry; the compute dtype, ``--vocoder-bf16``, stays the caller's); the
tokenizer from the tokenizer dir, else the model dir when it holds one, else
``ByteTokenizer``. The warmup captures the engine's graphs and the
single-stream pipeline's vocoder graphs. The tests can also
pass the JAX package's parameter pytrees (numpy leaves) as ``llama_tree`` /
``snac_tree``.

Under a (dp, tp) mesh (``config.mesh`` of more than one device, or a
``mesh`` from ``parallel.mesh``) the LM is loaded whole where it is read —
a checkpoint on the host, seeded random weights on this rank's device, so
that a seed gives the same weights as on one card — quantized there when
asked, and cut to this rank's shard (``weights.shard_params``); the
single-stream engine pads its batch to dp. The process group must be up
(``parallel.multihost.init_multihost``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional, Tuple

import torch

from tts_inference_tpu_torch import protocol
from tts_inference_tpu_torch.config import Config, ModelConfig
from tts_inference_tpu_torch.utils.tokenizer import (ByteTokenizer,
                                                     load_tokenizer)
from tts_inference_tpu_torch import weights
from tts_inference_tpu_torch.engine.engine import GenerationEngine
from tts_inference_tpu_torch.models.quant import quantize_llama_params
from tts_inference_tpu_torch.models.snac import SnacDecoder
from tts_inference_tpu_torch.streaming.lookahead import max_window_frames
from tts_inference_tpu_torch.streaming.pipeline import (TTSPipeline,
                                                        first_chunk_geometry,
                                                        warmup_first_chunks)


def default_device() -> torch.device:
    """The card. The port serves from the CPU only when the caller asks for
    it (``device="cpu"``, ``--device cpu``): a machine without a working
    CUDA device is an error, never a quiet change of device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: tts_inference_tpu_torch runs on cuda by "
            "default; pass device='cpu' (--device cpu) to run on the CPU")
    return torch.device("cuda")


def load_model(config: Config, dev: torch.device, *,
               model_path: Optional[str] = None,
               lora_path: Optional[str] = None, seed: int = 0,
               llama_tree: Optional[Dict] = None, quantize: bool = False,
               weight_bits: int = 8) -> Tuple[Dict, Config]:
    """The LM's parameters on `dev` and the config they imply, with the JAX
    package's precedence: a pre-quantized dir (``cli quantize`` output)
    brings its own dims and is never quantized again; an HF dir's
    config.json wins over `config.model` (``use_pallas_attention`` carries
    over); else the JAX pytree `llama_tree`, else seeded random weights.
    With `quantize` the weights are quantized on the device, layer by
    layer."""
    from tts_inference_tpu_torch.training import checkpoint

    if model_path and os.path.exists(os.path.join(model_path, "params")):
        raise ValueError(
            f"{model_path} is an orbax checkpoint of the JAX package; the "
            "port reads its own params.safetensors (ROADMAP.md Queue 3)")
    if model_path and checkpoint.is_checkpoint(model_path):
        from tts_inference_tpu_torch.models.quant import from_plain

        params, meta = checkpoint.restore_params(model_path, dev)
        if meta.get("model_config"):
            # the checkpoint carries its own dims; only performance knobs
            # carry over from the passed config
            mc = ModelConfig(**{
                k: v for k, v in meta["model_config"].items()
                if k in ModelConfig.__dataclass_fields__})
            mc = dataclasses.replace(
                mc, use_pallas_attention=config.model.use_pallas_attention)
            config = dataclasses.replace(config, model=mc)
        elif meta.get("vocab_size"):
            config = dataclasses.replace(config, model=dataclasses.replace(
                config.model, vocab_size=int(meta["vocab_size"])))
        if meta.get("quantized"):
            params = from_plain(params)
            quantize = False
    elif model_path:
        from tts_inference_tpu_torch.models.llama import param_dtype
        from tts_inference_tpu_torch.models.loader import \
            load_llama_checkpoint

        has_hf_cfg = os.path.exists(os.path.join(model_path, "config.json"))
        params, model_cfg = load_llama_checkpoint(
            model_path, None if has_hf_cfg else config.model,
            lora_path=lora_path,
            dtype=None if has_hf_cfg else param_dtype(config.model),
            device=dev)
        if has_hf_cfg:
            model_cfg = dataclasses.replace(
                model_cfg,
                use_pallas_attention=config.model.use_pallas_attention)
        config = dataclasses.replace(config, model=model_cfg)
    elif llama_tree is not None:
        params = weights.llama_params_from_jax(llama_tree, dev)
    else:
        params = weights.init_llama_params(config.model, seed, dev)
    if quantize:
        # layer by layer, dropping each full-precision weight as it goes
        params = quantize_llama_params(params, bits=weight_bits,
                                       free_source=True)
    return params, config


TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json")


def model_tokenizer(model_path: Optional[str] = None,
                    tokenizer_path: Optional[str] = None):
    """The tokenizer of `tokenizer_path`, else of the model dir when it
    holds one, else ``ByteTokenizer``."""
    tok_dir = tokenizer_path
    if tok_dir is None and model_path and any(
            os.path.exists(os.path.join(model_path, f))
            for f in TOKENIZER_FILES):
        tok_dir = model_path
    return load_tokenizer(tok_dir) if tok_dir else ByteTokenizer()


@dataclasses.dataclass
class Runtime:
    config: Config
    pipeline: TTSPipeline
    engine: GenerationEngine
    vocoder: SnacDecoder
    tokenizer: object
    load_timings: dict
    device: torch.device
    mesh: object = None   # parallel.mesh.Mesh when serving sharded

    @classmethod
    def create(cls, config: Optional[Config] = None, *,
               model_path: Optional[str] = None,
               snac_path: Optional[str] = None,
               lora_path: Optional[str] = None,
               tokenizer_path: Optional[str] = None,
               seed: int = 0, device=None, warmup: bool = False,
               llama_tree: Optional[Dict] = None,
               snac_tree: Optional[Dict] = None, quantize: bool = False,
               weight_bits: int = 8, mesh=None) -> "Runtime":
        """Checkpoint dirs, or random weights from `seed` (LM: seed,
        vocoder: seed + 1, like the JAX package), or the JAX pytrees
        `llama_tree` / `snac_tree`. With `quantize` the LM weights are
        quantized on the device after loading (unless the checkpoint is
        pre-quantized): weight_bits 8 = per-channel int8 everywhere, 4 =
        per-group int4 layer linears with the embedding and the head in
        int8."""
        config = config or Config()
        dev = torch.device(device) if device is not None else default_device()
        timings = {}
        if mesh is None and config.mesh.num_devices > 1:
            from tts_inference_tpu_torch.parallel import mesh as M

            mesh = M.make_mesh(config.mesh, device=dev)

        t0 = time.perf_counter()
        # sharded: a checkpoint (or a JAX tree) whole on the host, then this
        # rank's block of each tensor to the device
        src = dev if mesh is None or not (model_path or llama_tree) \
            else torch.device("cpu")
        params, config = load_model(
            config, src, model_path=model_path, lora_path=lora_path,
            seed=seed, llama_tree=llama_tree, quantize=quantize,
            weight_bits=weight_bits)
        if mesh is not None:
            params = weights.shard_params(params, config.model, mesh)
        timings["load_model_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        if snac_path:
            from tts_inference_tpu_torch.models.loader import \
                load_snac_checkpoint

            # as with the LM: the checkpoint's own config.json wins
            snac_has_cfg = os.path.exists(
                os.path.join(snac_path, "config.json"))
            vparams, snac_cfg = load_snac_checkpoint(
                snac_path, None if snac_has_cfg else config.snac, dev)
            # the geometry is the checkpoint's; the compute dtype and the
            # kernel switch are run choices and stay the caller's (the JAX
            # package drops them here: ROADMAP.md Queue 3)
            snac_cfg = dataclasses.replace(
                snac_cfg, dtype=config.snac.dtype,
                use_pallas=config.snac.use_pallas)
            config = dataclasses.replace(config, snac=snac_cfg)
        elif snac_tree is not None:
            vparams = weights.snac_params_from_jax(snac_tree, dev)
        else:
            vparams = weights.init_snac_params(config.snac, seed + 1, dev)
        # graphs for every frame bucket a streaming window can take
        vocoder = SnacDecoder(vparams, config.snac)
        vocoder.graph_max_frames = vocoder.bucket_frames(max_window_frames(
            config.stream, config.engine.decode_steps_per_call))
        timings["load_snac_s"] = time.perf_counter() - t0
        timings["snac_dtype"] = config.snac.dtype

        t0 = time.perf_counter()
        tokenizer = model_tokenizer(model_path, tokenizer_path)
        timings["load_tokenizer_s"] = time.perf_counter() - t0

        # first-launch burst sizes: tokens for the first stable chunk
        s = config.stream
        bursts = {(s.first_chunk_frames + s.lookahead_frames)
                  * protocol.FRAME_SIZE}
        if s.first_chunk_lookahead is not None:
            bursts.add((s.first_chunk_frames + s.first_chunk_lookahead)
                       * protocol.FRAME_SIZE)
        engine = GenerationEngine(
            params, config.model, config.engine, eos_id=protocol.TOKEN_EOS,
            seed=seed, device=dev, first_bursts=sorted(bursts), mesh=mesh,
            graphs=mesh is None or not mesh.gather_by_sum)
        pipeline = TTSPipeline(engine, vocoder, tokenizer, config)
        rt = cls(config, pipeline, engine, vocoder, tokenizer, timings, dev,
                 mesh)
        if warmup:
            rt.warmup()
        return rt

    def warmup(self) -> None:
        """Capture the engine's graphs and the single-stream pipeline's
        vocoder graphs (one window per call, and the fused first chunk of
        the default stream); their census (ms) and the time into
        ``load_timings``. Under a mesh the engine's core must be mirrored
        to the other ranks first (``parallel/lockstep.py``)."""
        t0 = time.perf_counter()
        info = self.engine.warmup()
        with torch.no_grad():
            self.vocoder.warmup_graphs(1)
            warmup_first_chunks(self.vocoder, 1, [first_chunk_geometry(
                self.config.stream, self.config.snac.samples_per_frame)],
                self.device)
        info.update(self.vocoder.census())
        self.load_timings["warmup_s"] = time.perf_counter() - t0
        self.load_timings.update(info)

    def write_build_info(self, path: str, **extra) -> None:
        """build_info.json: the configs, the device and the boot timings
        (and `extra`'s keys)."""
        write_build_info(path, self.config, self.device, self.load_timings,
                         **extra)


def write_build_info(path: str, config: Config, device: torch.device,
                     load_timings: dict, **extra) -> None:
    """build_info.json of a runtime of `config` on `device`, with `extra`'s
    keys beside the configs and the timings."""
    info = {
        "framework": "tts_inference_tpu_torch",
        "backend": device.type,
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "model": dataclasses.asdict(config.model),
        "engine": dataclasses.asdict(config.engine),
        "snac": dataclasses.asdict(config.snac),
        "load_timings": load_timings,
        **extra,
    }
    with open(path, "w") as f:
        json.dump(info, f, indent=2, default=str)


def create_tiny_runtime(seed: int = 0, warmup: bool = False,
                        device=None) -> Runtime:
    """Tiny random-weight runtime (tests, smoke runs, ``cli --tiny``); on
    cuda unless `device` says otherwise."""
    from tts_inference_tpu_torch.config import tiny_config

    return Runtime.create(tiny_config(), seed=seed, warmup=warmup,
                          device=device)
