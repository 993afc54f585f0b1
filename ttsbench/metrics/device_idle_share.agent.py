"""`device_idle_share.agent`: see `ttsbench.readers.device_idle_share`."""

from ttsbench.readers import device_idle_share as read  # noqa: F401
