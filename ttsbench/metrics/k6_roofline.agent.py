"""`k6_roofline.agent`: see `ttsbench.readers.k6_roofline`."""

from ttsbench.readers import k6_roofline as read  # noqa: F401
