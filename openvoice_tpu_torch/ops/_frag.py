"""What the wrappers of the tensor-core kernels share: the weight layout the
kernels read (``csrc/mma_tile.cuh``), input checks, window sizing, and the
column plan of the cluster kernels (``csrc/wn_cluster.cuh``).

The kernels multiply with ``mma.sync.m16n8k16`` and read the B operand, the
weights, straight from device memory.  `pack_frag` lays a ``[K, N]`` matrix
out so that each lane of a warp finds the two registers it feeds to one
instruction as one 8-byte word, and a warp's 32 words are one contiguous
256-byte line: for k-tile ``kt`` (16 rows) and column tile ``nt`` (8 columns),
lane ``l = 4·g + t`` holds ``W[16·kt + 2t + {0, 1, 8, 9}, 8·nt + g]``.
"""

from __future__ import annotations

import ctypes

import torch

SMEM_MAX = 232_448      # bytes of shared memory one block may ask for on sm_90
GRID_MAX_Y = 65_535     # the batch rides on gridDim.y
TILE_ROWS = 32          # rows of one warp tile (MT · 16 in csrc/mma_tile.cuh)


def frag_ok(k: int, n: int) -> bool:
    """Whether a [k, n] matrix has a fragment layout."""
    return k % 16 == 0 and n % 8 == 0


def pack_frag(w: torch.Tensor) -> torch.Tensor:
    """[..., K, N] → [..., K/16, N/8, 32, 4] bfloat16, contiguous, in the
    order the kernels' B fragments are loaded."""
    *lead, k, n = w.shape
    if not frag_ok(k, n):
        raise ValueError(f"fragment layout needs K % 16 == 0 and N % 8 == 0, got [{k}, {n}]")
    # k = 16·kt + 8·half + 2·t + pair,  n = 8·nt + g
    v = w.to(torch.bfloat16).reshape(*lead, k // 16, 2, 4, 2, n // 8, 8)
    d = len(lead)
    v = v.permute(*range(d), d, d + 4, d + 5, d + 2, d + 1, d + 3)  # kt, nt, g, t, half, pair
    return v.reshape(*lead, k // 16, n // 8, 32, 4).contiguous()


def maybe_frag(w: torch.Tensor) -> torch.Tensor | None:
    """The fragment layout of `w`, or None where its shape has none (the
    kernel then refuses the weights; the plain version does not need it)."""
    return pack_frag(w) if frag_ok(w.shape[-2], w.shape[-1]) else None


def check_bf16(name: str, x: torch.Tensor, shape: tuple | None = None) -> None:
    """What every kernel asks of a tensor it reads or writes."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous tensor")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes 16-byte aligned storage")


def check_lengths(lengths: torch.Tensor, batch: int, device: torch.device) -> torch.Tensor:
    """[B] true lengths as contiguous int32 on `device`."""
    if lengths.dim() != 1 or lengths.shape[0] != batch:
        raise ValueError(f"lengths must be [{batch}], got {tuple(lengths.shape)}")
    if lengths.dtype.is_floating_point or lengths.dtype == torch.bool:
        raise TypeError(f"lengths must be integers, got {lengths.dtype}")
    if lengths.device != device:
        raise ValueError(f"lengths on {lengths.device}, activations on {device}")
    return lengths.to(torch.int32).contiguous()


def length_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """[B] → float32 [B, T, 1]: 1 where the position is below the length."""
    return (torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]).float()[..., None]


_WINDOWS: dict[tuple, tuple[int, int]] = {}


def window(key: tuple, halo: int, t: int, tile_target: int, smem_bytes,
           multiples: tuple[int, ...] = (TILE_ROWS,)) -> tuple[int, int]:
    """(rows, tile) of a block's time window: `tile` kept rows plus `halo`
    recomputed rows a side.  Rows are a multiple of the first of `multiples`
    that allows a window at all (the preferred one first, the least the kernel
    can take last); the search starts near `tile_target` (or at the whole of a
    short input) and shrinks until `smem_bytes(rows, tile)` fits one block.
    `key` names the kernel and the sizes its shared memory depends on; the
    answer is kept per key."""
    want = min(tile_target, max(t, 1))
    key = (*key, halo, want, multiples)
    if key not in _WINDOWS:
        for step in multiples:
            rows = -(-(want + 2 * halo) // step) * step
            while rows - 2 * halo >= 1 and smem_bytes(rows, rows - 2 * halo) > SMEM_MAX:
                rows -= step
            if rows - 2 * halo >= 1:
                _WINDOWS[key] = (rows, rows - 2 * halo)
                break
        else:
            raise ValueError(f"a window with a {halo}-row halo does not fit in shared memory")
    return _WINDOWS[key]


def chosen_windows() -> dict[tuple, tuple[int, int]]:
    """Every window chosen so far: (kernel, its sizes, halo, tile wanted,
    row multiples) → (rows, tile)."""
    return dict(_WINDOWS)


def cluster_bounds(n_tiles: int, ranks: int) -> list[int]:
    """Rank r of a cluster owns the 8-column tiles [b[r], b[r + 1]) of a
    product with `n_tiles` column tiles: contiguous shares that differ by
    at most one tile.  The kernels take these boundaries as they are."""
    if ranks < 1:
        raise ValueError(f"a cluster has at least one CTA, got {ranks}")
    return [r * n_tiles // ranks for r in range(ranks + 1)]


def cluster_columns(n_out: int, ranks: int, paired: bool = False) -> list[list[int]]:
    """The output columns each rank computes of an `n_out`-wide product.
    `paired`: the product's two halves are split alike, so that column i of
    the first half and column i of the second have one owner (the gate's
    tanh and sigmoid of a channel; a channel's res and skip)."""
    width = n_out // 2 if paired else n_out
    if width % 8:
        raise ValueError(f"columns come in tiles of 8, got {width}")
    bounds = cluster_bounds(width // 8, ranks)
    halves = (0, width) if paired else (0,)
    return [[off + col for off in halves for col in range(8 * bounds[r], 8 * bounds[r + 1])]
            for r in range(ranks)]


_CLUSTERS: dict[tuple, int] = {}


def max_clusters(key: tuple, query) -> int:
    """cudaOccupancyMaxActiveClusters of a cluster launch: how many of its
    clusters the card holds at once.  `query(pointer to int)` asks the
    kernel's library and returns the CUDA error; the answer is kept per `key`
    (the kernel and every size and knob of the launch).  Raises when no
    cluster fits: there is no single-CTA fallback."""
    if key not in _CLUSTERS:
        n = ctypes.c_int(0)
        err = query(ctypes.byref(n))
        if err != 0:
            raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with CUDA error {err} ({key})")
        if n.value < 1:
            raise RuntimeError(f"no cluster of the launch {key} fits on the card")
        _CLUSTERS[key] = n.value
    return _CLUSTERS[key]
