"""Length bucketing (the port's copy of ``openvoice_tpu/runtime/bucketing.py``).

A clip's frame count is rounded up to a bucket so that the set of shapes the
device sees stays small; masks make the padded frames inert, so the result
equals the exact-length computation.  The port keeps the JAX package's
tables and its planner's constants, so that both packages pad a clip to the
same length, draw the same noise for it and plan the same batch groups.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

DEFAULT_BUCKETS: tuple[int, ...] = (64, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)

# the batch planner's finer table: rounding waste is bounded by the step
# ratio, at most 20 % above 512 frames and 12.5 % above 1024; below 512 the
# absolute waste is at most 64 frames.  More buckets mean more distinct
# shapes, so it is for long-running batch consumers (the serving batcher);
# one-off API calls keep DEFAULT_BUCKETS.
FINE_BUCKETS: tuple[int, ...] = (
    tuple(range(128, 513, 64)) + tuple(range(640, 2049, 128)) + tuple(range(2304, 4097, 256))
)


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


def pad_to_bucket(arr: np.ndarray, axis: int, buckets: Sequence[int] = DEFAULT_BUCKETS):
    """Zero-pad `arr` along `axis` up to its bucket; returns (padded, orig_len)."""
    n = arr.shape[axis]
    b = round_up_to_bucket(n, buckets)
    if b == n:
        return arr, n
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, b - n)
    return np.pad(np.asarray(arr), pad), n


def allowed_batch_sizes(max_batch: int) -> tuple[int, ...]:
    """Batch sizes the planner may emit for a cap: powers of 2 below
    max_batch, then max_batch itself."""
    sizes = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return tuple(sizes)


def plan_groups(
    lengths: Sequence[int],
    *,
    max_batch: int = 8,
    batch_sizes: Sequence[int] | None = None,
    fixed_cost_frames: int = 96,
    buckets: Sequence[int] = FINE_BUCKETS,
) -> list[tuple[list[int], int, int]]:
    """Cost-optimal partition of utterances into padded batch groups.

    A group's device time is taken as proportional to
    ``padded_batch · bucket(max_len)``, plus a fixed cost per dispatch, so
    the planner minimises

        Σ_groups  padded_batch · bucket(max_len) + fixed_cost_frames

    by dynamic programming over the length-sorted order (optimal groups are
    contiguous there, since a group's cost depends only on its longest
    member and its size).  Batch sizes are restricted to `batch_sizes`
    (default `allowed_batch_sizes(max_batch)`); a group is padded up to the
    next allowed size with rows of length 0.

    Returns [(indices_into_lengths, bucket, padded_batch), ...].
    `fixed_cost_frames` is the JAX package's constant (96 single-utterance
    frames a dispatch), kept so that both packages plan the same groups.
    """
    n = len(lengths)
    if n == 0:
        return []
    if batch_sizes is None:
        allowed = list(allowed_batch_sizes(max_batch))
    else:
        allowed = sorted(b for b in batch_sizes if b <= max_batch) or [max_batch]
    order = sorted(range(n), key=lambda i: lengths[i])

    def row_pad(k: int) -> int:
        for b in allowed:
            if b >= k:
                return b
        raise ValueError(f"group size {k} exceeds largest allowed batch {allowed[-1]}")

    max_k = min(allowed[-1], n)
    # DP over the sorted prefix: cost[i] = min over the last group's size k
    cost = [math.inf] * (n + 1)
    cut = [0] * (n + 1)
    cost[0] = 0.0
    for i in range(1, n + 1):
        bk = round_up_to_bucket(lengths[order[i - 1]], buckets)
        for k in range(1, min(max_k, i) + 1):
            c = cost[i - k] + row_pad(k) * bk + fixed_cost_frames
            if c < cost[i]:
                cost[i] = c
                cut[i] = k
    groups: list[tuple[list[int], int, int]] = []
    i = n
    while i > 0:
        k = cut[i]
        idx = [order[j] for j in range(i - k, i)]
        bk = round_up_to_bucket(lengths[order[i - 1]], buckets)
        groups.append((idx, bk, row_pad(k)))
        i -= k
    groups.reverse()
    return groups
