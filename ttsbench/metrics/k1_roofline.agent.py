"""`k1_roofline.agent`: see `ttsbench.readers.k1_roofline`."""

from ttsbench.readers import k1_roofline as read  # noqa: F401
