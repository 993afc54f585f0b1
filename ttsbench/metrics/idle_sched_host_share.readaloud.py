"""`idle_sched_host_share.readaloud`: see `ttsbench.spans.idle_sched_host_share`."""

from ttsbench.spans import idle_sched_host_share as read  # noqa: F401
