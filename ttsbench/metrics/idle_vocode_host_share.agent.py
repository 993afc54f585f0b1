"""`idle_vocode_host_share.agent`: see `ttsbench.spans.idle_vocode_host_share`."""

from ttsbench.spans import idle_vocode_host_share as read  # noqa: F401
