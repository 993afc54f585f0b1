"""`sched_host_ms_per_tick.readaloud`: see `ttsbench.readers.sched_host_ms_per_tick`."""

from ttsbench.readers import sched_host_ms_per_tick as read  # noqa: F401
