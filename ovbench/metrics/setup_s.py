"""Seconds from the process's start to the window's: the program's build
(first run of a checkout), the weights, the warm-up of every shape the cell
uses (the CUDA graphs' captures).  Host clock."""


def read(ctx) -> float | None:
    return ctx.setup_s
