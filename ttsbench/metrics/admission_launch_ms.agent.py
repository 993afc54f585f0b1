"""`admission_launch_ms.agent`: see `ttsbench.spans.admission_launch_ms`."""

from ttsbench.spans import admission_launch_ms as read  # noqa: F401
