"""`queue_wait_ms.agent`: see `ttsbench.spans.queue_wait_ms`."""

from ttsbench.spans import queue_wait_ms as read  # noqa: F401
