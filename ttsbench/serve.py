"""The system under test, assembled from a configuration: the port's
runtime over the benchmark's weights, its continuous-batching scheduler,
and its own aiohttp server on a localhost port, in this process.

From the port the benchmark takes only this assembly's public pieces, the
finished requests' token streams (what the timed path produced, judged by
the reference afterwards) and, in a traced run, the arguments of each
engine and vocoder launch (spans recorded around the calls, here)."""

from __future__ import annotations

import asyncio
import dataclasses
import socket
import threading
import time
from typing import Dict, List, Optional

import torch

from ttsbench import families


def _kv_label(ec) -> str:
    kind = "paged" if ec.paged_kv else "dense"
    prec = ("int8" if ec.kv_cache_int8 else
            "int4" if ec.kv_cache_int4 else "bfloat16")
    return f"{kind} {prec}"


def _fields(cls, block: Dict, what: str) -> Dict:
    """`block`'s keys as `cls`'s fields (lists as tuples); a key that is no
    field of `cls` is refused."""
    names = {f.name for f in dataclasses.fields(cls)}
    bad = sorted(set(block) - names)
    if bad:
        raise ValueError(f"{what}: {bad} are not {cls.__name__} fields")
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in block.items()}


def assemble_config(mc, model: Dict, mix: Dict):
    """The port's `Config` around a family's `ModelConfig` (`mc`): every
    key of the model's and the mix's `engine` blocks (the mix's win) and
    of the model's `snac` block, passed to the port's dataclass field of
    the same name. `kv_cache` names the cache those fields give ("dense
    bfloat16", "paged int8", ...) and must agree with them."""
    from tts_inference_tpu_torch.config import (Config, EngineConfig,
                                                SnacConfig)

    eng = dict(model["engine"], **mix["engine"])
    label = eng.pop("kv_cache", "dense bfloat16")
    ec = EngineConfig(**_fields(EngineConfig, eng, "engine"))
    if _kv_label(ec) != label:
        raise ValueError(f"kv_cache {label!r}: the engine fields give "
                         f"{_kv_label(ec)!r}")
    sc = SnacConfig(**_fields(SnacConfig, model.get("snac", {}), "snac"))
    return Config(model=mc, snac=sc, engine=ec)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class LaunchLog:
    """Spans of the engine's launches and the vocoder's calls, recorded
    around the port's launch functions while `on`: host time (ns since
    the epoch, the profiler's clock), the launch's kind ("decode",
    "vocoder", or the engine key's first item, as "admission" or
    "resume"), and, for what the metrics read, what sets the work — a
    decode's steps, window, the slots' lengths and the active mask (copied
    on the launch's stream just before it into rows of a pinned buffer
    made at set-up), a vocoder call's rows and valid latent lengths. Every
    launch goes through `lock`, which the profiler's start and stop take:
    stopping CUPTI while another thread replays a graph can deadlock the
    process. So the spans are in launch order, and a launch's runtime
    calls come after its span and before the next span."""

    ROWS = 8192

    def __init__(self, core, vocoder):
        self.on = False
        self.lock = threading.Lock()
        self.spans: List[dict] = []
        b, dev = core.batch, core.device
        pin = dev.type == "cuda"
        self._len = torch.zeros((self.ROWS, b), dtype=torch.int32,
                                pin_memory=pin)
        self._act = torch.zeros((self.ROWS, b), dtype=torch.bool,
                                pin_memory=pin)
        self._rows = 0
        launch, run = core._launch, vocoder.run

        def _launch(key, kind=None, **inputs):
            with self.lock:
                if self.on:
                    span = {"t": time.time_ns(), "kind": str(key[0])}
                    i = self._rows
                    if key[0] == "decode" and i < self.ROWS:
                        self._rows += 1
                        self._len[i].copy_(core.cache.lengths,
                                           non_blocking=True)
                        act = inputs.get("active")
                        if act is None:
                            self._act[i].fill_(True)
                        else:
                            self._act[i].copy_(torch.as_tensor(act),
                                               non_blocking=True)
                        span.update(n=int(key[1]), window=int(key[2]),
                                    row=i)
                    elif key[0] == "decode":
                        span["kind"] = "decode_unrecorded"
                    self.spans.append(span)
                return launch(key, kind, **inputs)

        def _run(key, body, **inputs):
            with self.lock:
                if self.on:
                    if key[0] == "decode":
                        nb = key[2]
                        valid = inputs["packed"][:, 7 * nb + 2].tolist()
                    else:   # ("first_chunk", batch, n_codes, nf, emit)
                        valid = [key[3] * 4] * key[1]
                    self.spans.append({"t": time.time_ns(),
                                       "kind": "vocoder", "key": key,
                                       "valid_latent": valid})
                return run(key, body, **inputs)

        core._launch = _launch
        vocoder.run = _run

    @property
    def decodes(self) -> List[dict]:
        return [s for s in self.spans if "row" in s]

    @property
    def vocodes(self) -> List[dict]:
        return [s for s in self.spans if s["kind"] == "vocoder"]

    def finish(self) -> None:
        """The recorded lengths and masks as host lists (after a
        synchronize)."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        for r in self.decodes:
            r["lengths"] = self._len[r["row"]].tolist()
            r["active"] = self._act[r["row"]].tolist()


@dataclasses.dataclass
class System:
    runtime: object
    scheduler: object
    served: Dict[str, dict]
    port: int = 0
    loop: Optional[asyncio.AbstractEventLoop] = None
    thread: Optional[threading.Thread] = None
    runner: object = None
    log: Optional[LaunchLog] = None

    def start(self) -> None:
        """Start the scheduler's threads and the server's event loop."""
        from aiohttp import web

        from tts_inference_tpu_torch.serving.app import create_app

        self.scheduler.start()
        self.port = free_port()
        self.loop = asyncio.new_event_loop()
        ready = threading.Event()

        def serve():
            asyncio.set_event_loop(self.loop)
            self.runner = web.AppRunner(
                create_app(self.runtime, self.scheduler))
            self.loop.run_until_complete(self.runner.setup())
            site = web.TCPSite(self.runner, "127.0.0.1", self.port)
            self.loop.run_until_complete(site.start())
            ready.set()
            self.loop.run_forever()
            self.loop.run_until_complete(self.runner.cleanup())

        self.thread = threading.Thread(target=serve, name="ttsbench-server",
                                       daemon=True)
        self.thread.start()
        if not ready.wait(60):
            raise RuntimeError("the server did not start")

    def stop(self) -> None:
        if self.loop is not None:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(30)
        self.scheduler.stop()


def build(model: Dict, mix: Dict, params, snac, device, seed: int,
          control: Optional[Dict] = None, log_launches: bool = False
          ) -> System:
    """The port's runtime and scheduler over the given weights (the
    family's `control_params` of them for the `quantize` control), warmed
    up on the cell's own shapes: the scheduler's decode windows, prompt
    buckets and vocoder buckets (the single-stream engine, which no
    request of the benchmark reaches, is built and not warmed)."""
    from tts_inference_tpu_torch import protocol
    from tts_inference_tpu_torch.engine.engine import GenerationEngine
    from tts_inference_tpu_torch.engine.scheduler import Scheduler
    from tts_inference_tpu_torch.models.snac import SnacDecoder
    from tts_inference_tpu_torch.runtime import Runtime
    from tts_inference_tpu_torch.streaming.lookahead import \
        max_window_frames
    from tts_inference_tpu_torch.streaming.pipeline import TTSPipeline
    from tts_inference_tpu_torch.utils.tokenizer import ByteTokenizer

    family = families.of(model)
    config = family.port_config(model, mix)
    if control and control.get("quantize"):
        params = family.control_params(params)
    vocoder = SnacDecoder(snac, config.snac)
    vocoder.graph_max_frames = vocoder.bucket_frames(max_window_frames(
        config.stream, config.engine.decode_steps_per_call))
    s = config.stream
    engine = GenerationEngine(
        params, config.model, config.engine, eos_id=protocol.TOKEN_EOS,
        seed=seed, device=device,
        first_bursts=[(s.first_chunk_frames + s.lookahead_frames)
                      * protocol.FRAME_SIZE])
    tokenizer = ByteTokenizer()
    runtime = Runtime(config, TTSPipeline(engine, vocoder, tokenizer, config),
                      engine, vocoder, tokenizer, {}, torch.device(device))
    served: Dict[str, dict] = {}

    class Recording(Scheduler):
        def _release(self, slot):
            st = self.slots[slot]
            if st is not None:
                served[st.req.text] = {"prompt": list(st.prompt_ids),
                                       "tokens": list(st.token_ids)}
            super()._release(slot)

    scheduler = Recording(params, config, vocoder, tokenizer, seed=seed,
                          device=device)
    scheduler.warmup()
    system = System(runtime, scheduler, served)
    if log_launches:
        system.log = LaunchLog(scheduler.core, vocoder)
    return system
