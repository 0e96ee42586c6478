"""`p95_ms` of the cell v2-convert-interactive alone, under a bound of its own: its runs
spread about twice as widely as the other cells' (PERF.md §2)."""

from ovbench.metrics.p95_ms import read  # noqa: F401
