"""`decode_step_ms.readaloud`: see `ttsbench.readers.decode_step_ms`."""

from ttsbench.readers import decode_step_ms as read  # noqa: F401
