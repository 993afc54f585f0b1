"""`server_ttft_ms.agent`: see `ttsbench.readers.server_ttft_ms`."""

from ttsbench.readers import server_ttft_ms as read  # noqa: F401
