"""`k1_roofline.readaloud`: see `ttsbench.readers.k1_roofline`."""

from ttsbench.readers import k1_roofline as read  # noqa: F401
