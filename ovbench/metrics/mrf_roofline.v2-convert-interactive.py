"""`mrf_roofline` of the cell v2-convert-interactive, which reports `audio_s_per_s.v2-convert-interactive`
in place of `audio_s_per_s`."""

from ovbench.metrics.mrf_roofline import read  # noqa: F401
