"""`vocode_ms_per_audio_s.readaloud`: see `ttsbench.readers.vocode_ms_per_audio_s`."""

from ttsbench.readers import vocode_ms_per_audio_s as read  # noqa: F401
