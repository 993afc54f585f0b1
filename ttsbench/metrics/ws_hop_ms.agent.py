"""`ws_hop_ms.agent`: see `ttsbench.readers.ws_hop_ms`."""

from ttsbench.readers import ws_hop_ms as read  # noqa: F401
