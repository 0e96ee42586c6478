"""`graph_captures` of the cell v2-convert-interactive, which reports `p95_ms.v2-convert-interactive`
in place of `p95_ms`."""

from ovbench.metrics.graph_captures import read  # noqa: F401
