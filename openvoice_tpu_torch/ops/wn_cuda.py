"""K1: a whole WaveNet stack as one hand-written CUDA kernel (``csrc/wn.cu``),
launched as thread-block clusters: each time tile is split over the R CTAs of
one cluster, which share the window through distributed shared memory
(`_frag.cluster_bounds` is the column plan), as K2 does.

Replaces ``openvoice_tpu/ops/wn_pallas.py::fused_wn_stack``; `stack_wn_params`
is the port's packer (its ``stack_wn_params``).  `wn_stack` takes the
activation [B, T, H] in the JAX layout, true frame counts, the packed weights
and the per-layer conditioning [B, L, 2H] (projected once outside), and
returns the masked skip sum [B, T, H].  A CUDA tensor goes to the kernel; a
CPU tensor goes to `wn_stack_plain`, the same function in plain PyTorch with
the kernel's rounding points.  Nothing falls back: wrong inputs, a failed
build, a launch no cluster of which fits on the card, or a failed launch
raise.

``launches`` counts the kernel's launches; it is raised where the kernel is
launched and nowhere else (`ops.count_launch`: a
launch recorded into a CUDA graph counts at each replay).
"""

from __future__ import annotations

import ctypes

import torch

from openvoice_tpu_torch.ops import count_launch, _frag, _nvcc

launches = 0

# CTAs a cluster splits a time tile over, frames a tile keeps (the window
# recomputes L·(K−1)/2 more a side: 32 at the V2 posterior encoder's L 16, K 5)
# and threads a CTA (at most 384: MAX_THREADS in csrc/wn_cluster.cuh).  A
# 64-frame tile is a 128-row window: 16 clusters at T = 1024, one wave of the
# 30 clusters of 4 an H100 holds.  ``python3 chip_smoke.py --sweep wn`` times
# R 2/4/8 × tile 32/64 × 288/384 threads (PERF.md).
_RANKS = 4
_TILE_TARGET = 64
_THREADS = 384

# what the last launch ran: ranks, rows, tile, CTAs, and
# cudaOccupancyMaxActiveClusters for its CTA size
last_launch: dict = {}


def stack_wn_params(wn, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Pack a `nn.wavenet.WN`'s layers for `wn_stack`, once:

    w_in [L, K, H, 2H], b_in [L, 2H], w_rs [L, H, 2H] (the last layer, which
    has H outputs, sits in the skip half beside a zero res half), b_rs
    [L, 2H], in `dtype`; and ``w_in_frag`` / ``w_rs_frag``, the same matrices
    in the kernel's fragment order (None where H has no such layout).
    """
    h = wn.hidden
    with torch.no_grad():
        w_in = torch.stack([layer.weight.permute(2, 1, 0) for layer in wn.in_layers])
        b_in = torch.stack([layer.bias for layer in wn.in_layers])
        w_rs, b_rs = [], []
        for layer in wn.res_skip_layers:
            w, b = layer.weight[:, :, 0].t(), layer.bias  # [H, out], [out]
            if w.shape[1] == h:  # the last layer is skip-only
                w = torch.cat([torch.zeros_like(w), w], dim=1)
                b = torch.cat([torch.zeros_like(b), b])
            w_rs.append(w)
            b_rs.append(b)
        packed = {"w_in": w_in, "b_in": b_in, "w_rs": torch.stack(w_rs), "b_rs": torch.stack(b_rs)}
        packed = {k: v.to(dtype).contiguous() for k, v in packed.items()}
        packed["w_in_frag"] = _frag.maybe_frag(packed["w_in"])
        packed["w_rs_frag"] = _frag.maybe_frag(packed["w_rs"])
    return packed


def wn_layers_plain(xs: torch.Tensor, mask: torch.Tensor, dt: torch.dtype, w_in, b_in, g_all,
                    w_rs, b_rs) -> torch.Tensor:
    """The layers on f32 tensors that hold `dt` values: xs [B, T, H] masked,
    mask [B, T, 1], g_all [B, L, 2H].  Returns the f32 skip sum, unmasked.
    Products are taken in f32; results are rounded to `dt` where the kernel
    rounds."""
    n_layers, k, h, _ = w_in.shape
    pad = (k - 1) // 2
    t = xs.shape[1]
    skip = torch.zeros_like(xs)
    for layer in range(n_layers):
        xp = torch.nn.functional.pad(xs, (0, 0, pad, pad))
        x_in = sum(xp[:, j : j + t] @ w_in[layer, j].float() for j in range(k))
        x_in = x_in + b_in[layer].float() + g_all[:, layer : layer + 1].float()
        acts = (torch.tanh(x_in[..., :h]) * torch.sigmoid(x_in[..., h:])).to(dt).float()
        rs = acts @ w_rs[layer].float() + b_rs[layer].float()
        if layer + 1 < n_layers:
            xs = (xs + rs[..., :h].to(dt).float()).to(dt).float() * mask
        skip = skip + rs[..., h:]
    return skip


def wn_stack_plain(x: torch.Tensor, lengths: torch.Tensor, packed: dict,
                   g_all: torch.Tensor) -> torch.Tensor:
    """`wn_stack` in plain PyTorch, in x's dtype."""
    dt = x.dtype
    mask = _frag.length_mask(lengths, x.shape[1])
    skip = wn_layers_plain(x.float() * mask, mask, dt, packed["w_in"], packed["b_in"], g_all,
                           packed["w_rs"], packed["b_rs"])
    return skip.to(dt) * mask.to(dt)


def live_tiles(length: int, tile: int, t_len: int) -> int:
    """How many of the kernel's time tiles compute at a row's true `length`:
    a tile whose first frame lies at or past it writes zeros and returns."""
    return -(-min(max(length, 0), t_len) // tile)


def _library() -> ctypes.CDLL:
    lib = _nvcc.load("wn")
    lib.wn_stack_bf16.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 11
                                  + [ctypes.c_void_p])
    lib.wn_stack_bf16.restype = ctypes.c_int
    lib.wn_stack_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.wn_stack_smem_bytes.restype = ctypes.c_int
    lib.wn_stack_max_clusters.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    lib.wn_stack_max_clusters.restype = ctypes.c_int
    lib.wn_stack_attributes.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.wn_stack_attributes.restype = ctypes.c_int
    return lib


def kernel_attributes(device: int = 0) -> dict:
    """Registers and spilled bytes a thread of the kernel, as ptxas left them
    (cudaFuncGetAttributes)."""
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    err = _library().wn_stack_attributes(device, ctypes.byref(regs), ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"wn kernel attributes failed with CUDA error {err}")
    return {"registers": regs.value, "spill_bytes": local.value}


def wn_stack(x: torch.Tensor, lengths: torch.Tensor, packed: dict, g_all: torch.Tensor) -> torch.Tensor:
    """x [B, T, H]; lengths [B] true frame counts; packed from
    `stack_wn_params` in x's dtype; g_all [B, L, 2H] conditioning (zeros when
    unconditioned) → the masked skip sum [B, T, H].  Frames past a row's
    length come out exactly 0."""
    if x.dim() != 3:
        raise ValueError(f"wn_stack takes [B, T, H], got {tuple(x.shape)}")
    batch, t, h = x.shape
    n_layers, k = packed["w_in"].shape[:2]
    if packed["w_in"].shape != (n_layers, k, h, 2 * h) or k % 2 == 0:
        raise ValueError(f"packed weights {tuple(packed['w_in'].shape)} do not fit H = {h}")
    if g_all.shape != (batch, n_layers, 2 * h):
        raise ValueError(f"g_all must be [{batch}, {n_layers}, {2 * h}], got {tuple(g_all.shape)}")
    if packed["w_in"].dtype != x.dtype or g_all.dtype != x.dtype:
        raise TypeError(f"x {x.dtype}, weights {packed['w_in'].dtype}, g_all {g_all.dtype} must agree")
    if batch == 0 or t == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("wn_stack takes a contiguous activation")
    if x.device.type == "cpu":
        return wn_stack_plain(x, lengths, packed, g_all)
    if x.device.type != "cuda":
        raise ValueError(f"wn_stack runs on cuda or cpu, not {x.device}")

    _frag.check_bf16("x", x)
    _frag.check_bf16("g_all", g_all)
    if packed["w_in_frag"] is None or h % 16:
        raise ValueError(f"the kernel needs H % 16 == 0, got H = {h}")
    for name in ("w_in_frag", "w_rs_frag", "b_in", "b_rs"):
        _frag.check_bf16(name, packed[name])
        if packed[name].device != x.device:
            raise ValueError(f"{name} on {packed[name].device}, x on {x.device}")
    if batch > _frag.GRID_MAX_Y:
        raise ValueError(f"batch {batch} exceeds the launch grid")
    lengths = _frag.check_lengths(lengths, batch, x.device)

    lib = _library()
    halo = n_layers * (k - 1) // 2
    h_bounds = _frag.cluster_bounds(h // 8, _RANKS)
    skip_cols = 8 * max(b - a for a, b in zip(h_bounds, h_bounds[1:]))
    rows, tile = _frag.window(("wn", h, _RANKS), halo, t, _TILE_TARGET,
                              lambda r, tl: lib.wn_stack_smem_bytes(h, r, tl, skip_cols))
    device = x.device.index or 0
    clusters = _frag.max_clusters(
        ("wn", h, rows, tile, skip_cols, _THREADS, _RANKS, device),
        lambda n: lib.wn_stack_max_clusters(h, rows, tile, skip_cols, _THREADS, _RANKS, device, n))
    out = torch.empty_like(x)
    err = lib.wn_stack_bf16(
        x.data_ptr(), lengths.data_ptr(), packed["w_in_frag"].data_ptr(), packed["b_in"].data_ptr(),
        g_all.data_ptr(), packed["w_rs_frag"].data_ptr(), packed["b_rs"].data_ptr(), out.data_ptr(),
        (ctypes.c_int * len(h_bounds))(*h_bounds), batch, t, h, k, n_layers, rows, tile, skip_cols, _THREADS,
        _RANKS, device, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"wn kernel launch failed with CUDA error {err}")
    count_launch(__name__)
    last_launch.update(ranks=_RANKS, rows=rows, tile=tile, tiles=-(-t // tile),
                       ctas=-(-t // tile) * _RANKS * batch, threads=_THREADS, max_clusters=clusters)
    return out
