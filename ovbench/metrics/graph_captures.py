"""CUDA graphs captured during the window, over every graph cache the
cell's entry uses (runtime/graphs.py ``GraphCache.captures``).  Set-up warms
every shape of the cell, so this reads 0; a capture in the window is a
stall of a full device synchronisation."""


def read(ctx) -> float | None:
    return float(ctx.captures)
