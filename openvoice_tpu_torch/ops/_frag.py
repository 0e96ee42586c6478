"""What the wrappers of the tensor-core kernels share: the weight layout the
kernels read, input checks, window sizing, the host's side of the weight
ring (``csrc/ring.cuh``: `plan_window`, `ring_plan`), and the column plan,
weight streams and launch plan of the cluster kernels
(``csrc/wn_cluster.cuh``).

Every kernel multiplies on Hopper's warpgroup MMA with its B operand, the
weights, in shared memory (``csrc/wgmma.cuh``).  `pack_slabs` lays a conv's
taps out as that operand: slab (tap, k-tile) is the [16, N] tile K-major
(row n holds the tile's 16 K values of output column n, 32 bytes) with the
32-byte swizzle.  The cluster kernels K1 and K2 split every product's
columns over a cluster's CTAs (`cluster_bounds`), and each CTA streams its
columns of all its products, in execution order, as one run of slabs
(`cluster_streams`).
"""

from __future__ import annotations

import ctypes

import torch

SMEM_MAX = 232_448      # bytes of shared memory one block may ask for on sm_90
GRID_MAX_Y = 65_535     # the batch rides on gridDim.y
TILE_M = 64             # rows of one wgmma tile (TILE_M in csrc/ring.cuh)
MAX_STAGES = 32         # ring groups at most (MAX_STAGES in csrc/ring.cuh)
MAX_SEQ = 40            # product entries a launch (MAX_SEQ in csrc/ring.cuh)

# The cluster kernels K1 and K2 (csrc/wn_cluster.cuh) are built as one
# instance, and their launch shape is fixed: four CTAs a cluster, four
# warpgroups a CTA (WN_WARPGROUPS), an item of a wide product (the gate,
# res|skip) a 64-row tile by 48 columns (WN_WIDTH: half a CTA's 96 at H =
# 192), and a window of 64 kept frames at most (128 rows with the shipped
# 32-frame halo: one item a warpgroup a product).  So measured fastest on one
# H100 (PERF.md §6): two warpgroups with all 96 columns took 1-2 % longer at
# B = 1 and 8; two CTAs a cluster took K1 30 % longer and leave K2 no ring
# (its skip sum doubles); 128 kept frames need 192 rows, which K2's shared
# memory does not hold.
CLUSTER_RANKS = 4
CLUSTER_WARPGROUPS = 4
CLUSTER_WIDTH = 48
CLUSTER_TILE = 64
# units of a K1 / K2 stream a ring group moves (WN_GROUP in
# csrc/wn_cluster.cuh): a unit is one slab of a narrow product, 32 bytes a
# column of a CTA's share of H; a wide product's slab is two
CLUSTER_GROUP = 8
CLUSTER_RESERVE = 2 * CLUSTER_GROUP  # units the window leaves the ring at least
# slabs of one batch of K1's and K2's products (BATCH in csrc/wn_cluster.cuh):
# a product's slabs are a multiple of it
CLUSTER_BATCH = 4


def pack_slabs(w: torch.Tensor, multiple: int = 64) -> torch.Tensor | None:
    """[n_taps, C_in, C_out] → the kernels' weight slabs [n_taps, C_in/16,
    C_out, 16] bfloat16: slab (tap, k-tile) is the [16, C_out] B tile of
    ``csrc/wgmma.cuh``, K-major (row n holds the tile's 16 K values of output
    channel n), with the 32-byte swizzle: the 16-byte halves of row n trade
    places where (n / 4) % 2 is 1.  None where C_in or C_out is not a
    multiple of `multiple` (K3 takes C % 64 == 0, K4 C_in and C % 16 == 0,
    K1 and K2 a CTA's columns in whole 8-column tiles; C_in is a multiple of
    16 in every case; the plain versions do not need it)."""
    n_taps, k, n = w.shape
    if k % multiple or n % multiple or k % 16:
        return None
    v = w.to(torch.bfloat16).reshape(n_taps, k // 16, 2, 8, n).permute(0, 1, 4, 2, 3)  # tap, kt, n, half, k8
    swap = ((torch.arange(n, device=w.device) >> 2) & 1).bool()[:, None, None]
    return torch.where(swap, v.flip(-2), v).reshape(n_taps, k // 16, n, 16).contiguous()


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
           multiples: tuple[int, ...] = (TILE_M,)) -> tuple[int, int]:
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


def plan_window(key: tuple, halo: int, t: int, tile_target: int, smem, group: int, reserve: int,
                max_slabs: int | None = None, stream_slabs: int = 0) -> tuple[int, int, int]:
    """(rows, tile, stages) of a launch that streams its weights through the
    ring: the block's window of `tile` kept rows and `halo` a side, and its
    weight ring of `stages` groups of `group` slabs.  The window is a
    multiple of 64 rows, the largest (up to `tile_target` kept rows) that
    fits beside a ring of `reserve` slabs (one group at least); the whole
    stream of `stream_slabs` then stays resident if it fits beside that
    window (stages 0), else the ring takes as many groups as fit, up to
    `max_slabs` slabs and MAX_STAGES groups.  smem(rows, ring slabs, stages)
    is the kernel's shared memory; `key` names the kernel and the sizes it
    depends on."""
    reserve = max(1, reserve // group)
    most = min(MAX_STAGES, (max_slabs or MAX_STAGES * group) // group)
    rows, tile = window((*key, group, reserve), halo, t, tile_target,
                        lambda r, _tile: smem(r, reserve * group, reserve), multiples=(TILE_M,))
    if stream_slabs and smem(rows, stream_slabs, 0) <= SMEM_MAX:
        return rows, tile, 0
    stages = reserve
    while stages < most and smem(rows, (stages + 1) * group, stages + 1) <= SMEM_MAX:
        stages += 1
    return rows, tile, stages


def ring_plan(entries, group: int, warpgroups: int, parts: int = 1) -> ctypes.Array:
    """The ring plan of a K1-K4 launch as the kernels' int32 table
    (csrc/ring.cuh's RingPlan, which `make_plan` checks): for each
    product entry (first row, 64-row tiles, slabs a round), in execution
    order, first, tiles, slabs a round, its first slab in the stream and the
    ring groups of the entries up to it.  A round gives each warpgroup one
    item, a tile's N-column part (`parts` a tile), and moves ceil(slabs /
    group) groups; every warp walks every group of every round."""
    flat, slabs, groups = [], 0, 0
    for first, count, steps in entries:
        groups += -(-count * parts // warpgroups) * -(-steps // group)
        flat += [first, count, steps, slabs, groups]
        slabs += steps
    return (ctypes.c_int * len(flat))(*flat)


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


def share_columns(halves: tuple[int, ...], tiles: range) -> list[int]:
    """A CTA's columns of one product in the order its stream holds them:
    for each of its 8-column tiles, that tile of each half (at the column
    offsets `halves`), side by side.  A gate's (0, H): a channel tile's tanh
    then its sigmoid columns; res|skip's (0, H): its res then its skip
    columns; the last layer's (H,): its skip columns; pre's and post's (0,)."""
    return [off + 8 * i + j for i in tiles for off in halves for j in range(8)]


def cluster_streams(products, ranks: int) -> tuple[torch.Tensor, tuple[int, ...]] | None:
    """The weights of a cluster kernel's products as one stream of slabs
    (`pack_slabs`) a rank.  `products`, in execution order: (w [taps, K, N],
    halves, n_tiles), rank r's columns `share_columns(halves, its tiles)` of
    `cluster_bounds(n_tiles, ranks)`.  Returns (streams [ranks, stream
    elements] bfloat16, the units of each product: taps × K/16 × its halves),
    a unit being 16 × 8 × share elements; None where the kernels take no such
    split (K % 16, slabs a product not a multiple of CLUSTER_BATCH, or shares
    of unequal width)."""
    shares = set()
    for w, halves, n_tiles in products:
        bounds = cluster_bounds(n_tiles, ranks)
        shares |= {b - a for a, b in zip(bounds, bounds[1:])}
        if w.shape[1] % 16 or w.shape[0] * (w.shape[1] // 16) % CLUSTER_BATCH:
            return None
    if len(shares) != 1 or 0 in shares:
        return None
    streams: list[list[torch.Tensor]] = [[] for _ in range(ranks)]
    units = []
    for w, halves, n_tiles in products:
        bounds = cluster_bounds(n_tiles, ranks)
        for r in range(ranks):
            cols = share_columns(halves, range(bounds[r], bounds[r + 1]))
            streams[r].append(pack_slabs(w[..., cols], 8).reshape(-1))
        units.append(w.shape[0] * (w.shape[1] // 16) * len(halves))
    return torch.stack([torch.cat(s) for s in streams]).contiguous(), tuple(units)


def add_streams(packed: dict, products) -> dict:
    """Each of the CLUSTER_RANKS CTAs' streams of `products`
    (`cluster_streams`) under ``streams`` (None where the sizes have no such
    split), and its units a product under ``stream_units``."""
    made = cluster_streams(products, CLUSTER_RANKS)
    packed["streams"], packed["stream_units"] = made if made is not None else (None, ())
    return packed


def check_streams(packed: dict, n_products: int, device: torch.device) -> int:
    """What the cluster kernels ask of the packed streams (`add_streams`):
    one for each of a cluster's CTAs on `device`, at most MAX_SEQ products.
    Returns a CTA's share of H tiles."""
    if packed["streams"] is None:
        raise ValueError("the kernel needs C % 16 == H % 16 == 0 and equal shares of H and C for each CTA")
    if packed["streams"].shape[0] != CLUSTER_RANKS:
        raise ValueError(f"the weights are packed for {packed['streams'].shape[0]} CTAs a cluster, the kernel "
                         f"runs {CLUSTER_RANKS}: pack them again")
    if len(packed["stream_units"]) != n_products or n_products > MAX_SEQ:
        raise ValueError(f"the kernel takes at most {MAX_SEQ} products a launch, got {n_products}")
    check_bf16("streams", packed["streams"])
    if packed["streams"].device != device:
        raise ValueError(f"streams on {packed['streams'].device}, activations on {device}")
    return packed["streams"].shape[1] // (16 * 8 * sum(packed["stream_units"]))


_CLUSTER_PLANS: dict[tuple, dict] = {}


def cluster_plan(key: tuple, halo: int, t: int, units: tuple[int, ...], share: int, smem,
                 max_stages: int) -> dict:
    """The launch plan of K1 or K2: the window (`rows`, `tile` kept, a
    multiple of 64 rows, the largest up to CLUSTER_TILE kept rows that leaves
    the ring CLUSTER_RESERVE units), the ring (`stages` groups of
    CLUSTER_GROUP units, as many as fit, up to `max_stages`), `parts` (items
    of CLUSTER_WIDTH columns to a CTA's columns of a wide product: a CTA's
    `share` of H tiles, both halves), and `plan`, the ring plan (`ring_plan`)
    over the products of `units` (`add_streams`).  smem(rows, tile, unit
    bytes, ring units, stages) is the kernel's shared memory.  `key` names
    the kernel and its sizes; the plan is kept per key, length wanted and
    ring depth.  Raises where the columns do not split into the built
    instance's items."""
    if 16 * share % CLUSTER_WIDTH:
        raise ValueError(f"a CTA's {16 * share} columns of a wide product do not split into the kernel's "
                         f"{CLUSTER_WIDTH}-column items")
    full = (*key, halo, min(CLUSTER_TILE, max(t, 1)), units, share, max_stages)
    if full not in _CLUSTER_PLANS:
        group, unit_bytes = CLUSTER_GROUP, 256 * share
        rows, tile, stages = plan_window(
            (*key, unit_bytes), halo, t, CLUSTER_TILE,
            lambda r, ring_units, n: smem(r, r - 2 * halo, unit_bytes, ring_units, n), group, CLUSTER_RESERVE,
            max_stages * group)
        parts = 16 * share // CLUSTER_WIDTH
        _CLUSTER_PLANS[full] = {
            "rows": rows, "tile": tile, "stages": stages, "group": group, "parts": parts, "unit_bytes": unit_bytes,
            "smem": smem(rows, tile, unit_bytes, stages * group, stages),
            "plan": ring_plan([(0, rows // TILE_M, u) for u in units], group, CLUSTER_WARPGROUPS, parts)}
    return _CLUSTER_PLANS[full]
