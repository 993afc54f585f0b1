"""`step_mfu.agent`: see `ttsbench.readers.step_mfu`."""

from ttsbench.readers import step_mfu as read  # noqa: F401
