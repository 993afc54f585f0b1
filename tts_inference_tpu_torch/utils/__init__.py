"""Host-side helpers of the port: audio, tokenizer, timing, host copies."""

from tts_inference_tpu_torch.utils.host_copy import (HostCopy, copy_async,
                                                     to_numpy)

__all__ = ["HostCopy", "copy_async", "to_numpy"]
