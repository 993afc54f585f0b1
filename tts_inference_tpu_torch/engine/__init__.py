"""Generation engines, the JAX package's registry of backends over one
compute core:

- ``engine.GenerationEngine``: one stream, lowest latency;
- ``scheduler.Scheduler``: continuous batching over fixed slots.
"""

from tts_inference_tpu_torch.engine.engine import EngineCore, GenerationEngine
from tts_inference_tpu_torch.engine.scheduler import Scheduler, TTSRequest

BACKENDS = {
    "single": GenerationEngine,
    "scheduler": Scheduler,
}

__all__ = ["EngineCore", "GenerationEngine", "Scheduler", "TTSRequest",
           "BACKENDS"]
