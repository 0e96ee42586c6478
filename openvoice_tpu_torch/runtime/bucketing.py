"""Length bucketing (the port's copy of ``openvoice_tpu/runtime/bucketing.py``).

A clip's frame count is rounded up to a bucket so that the set of shapes the
device sees stays small; masks make the padded frames inert, so the result
equals the exact-length computation.  The port keeps the JAX package's
buckets so both packages pad a clip to the same length and draw the same
noise for it.
"""

from __future__ import annotations

import math
from typing import Sequence

DEFAULT_BUCKETS: tuple[int, ...] = (64, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)


def round_up_to_bucket(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS, growth: float = 1.5) -> int:
    """Smallest bucket ≥ n; beyond the table, grow geometrically (×growth
    rounded to a multiple of 128)."""
    for b in buckets:
        if n <= b:
            return b
    b = buckets[-1]
    while b < n:
        b = int(math.ceil(b * growth / 128.0)) * 128
    return b
