"""K1: a whole WaveNet stack as one hand-written CUDA kernel (``csrc/wn.cu``),
launched as thread-block clusters: each time tile is split over the R CTAs of
one cluster, which share the window through distributed shared memory
(`_frag.cluster_bounds` is the column plan), as K2 does.  Every product is a
warpgroup MMA with each CTA's weights streamed through a shared-memory ring
(`_frag.cluster_streams`, `_frag.cluster_plan`).

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

# K1's one knob, the ring's depth in groups at most (as many as fit beside
# the window, up to this; ``python3 chip_smoke.py --sweep wn`` times it,
# PERF.md has the table): a ring of two groups took 40 % longer than one of
# four or more on one H100.  The launch's shape is fixed (`_frag`'s
# CLUSTER_* constants).
_MAX_STAGES = _frag.MAX_STAGES

# what the last launch ran: ranks, rows, tile, CTAs, warpgroups, item
# columns, ring groups and their units, and cudaOccupancyMaxActiveClusters
last_launch: dict = {}


def wn_matrices(wn, dtype: torch.dtype) -> dict:
    """A `nn.wavenet.WN`'s layers as matrices in `dtype`: w_in [L, K, H, 2H],
    b_in [L, 2H], w_rs [L, H, 2H] (the last layer, which has H outputs, sits
    in the skip half beside a zero res half), b_rs [L, 2H]."""
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
        return {k: v.to(dtype).contiguous() for k, v in packed.items()}


def wn_products(w_in: torch.Tensor, w_rs: torch.Tensor) -> list[tuple]:
    """The WaveNet's products in execution order as `_frag.cluster_streams`
    takes them: per layer the gate ([K, H, 2H], tanh and sigmoid halves),
    then res|skip ([1, H, 2H], both halves; the last layer's skip half
    alone)."""
    n_layers, _, h, _ = w_in.shape
    out = []
    for layer in range(n_layers):
        out.append((w_in[layer], (0, h), h // 8))
        out.append((w_rs[layer][None], (0, h) if layer + 1 < n_layers else (h,), h // 8))
    return out


def stack_wn_params(wn, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Pack a `nn.wavenet.WN`'s layers for `wn_stack`, once: `wn_matrices`
    in `dtype`, and (`_frag.add_streams`) each CTA's weights as the kernel
    streams them, in bfloat16."""
    with torch.no_grad():
        packed = wn_matrices(wn, dtype)
        return _frag.add_streams(packed, wn_products(packed["w_in"], packed["w_rs"]))


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
    lib.wn_stack_bf16.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_int)] * 3 + [ctypes.c_int] * 11
                                  + [ctypes.c_void_p])
    lib.wn_stack_bf16.restype = ctypes.c_int
    lib.wn_stack_smem_bytes.argtypes = [ctypes.c_int] * 7
    lib.wn_stack_smem_bytes.restype = ctypes.c_int
    lib.wn_stack_max_clusters.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.wn_stack_max_clusters.restype = ctypes.c_int
    lib.wn_stack_attributes.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.wn_stack_attributes.restype = ctypes.c_int
    return lib


def kernel_attributes() -> dict:
    """Registers and spilled bytes a thread of the kernel, as ptxas left
    them (cudaFuncGetAttributes)."""
    out = (ctypes.c_int * 2)()
    err = _library().wn_stack_attributes(out)
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes of K1 failed with CUDA error {err}")
    return {"registers": out[0], "spill_bytes": out[1]}


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
    share = _frag.check_streams(packed, 2 * n_layers, x.device)
    for name in ("b_in", "b_rs"):
        _frag.check_bf16(name, packed[name])
        if packed[name].device != x.device:
            raise ValueError(f"{name} on {packed[name].device}, x on {x.device}")
    if batch > _frag.GRID_MAX_Y:
        raise ValueError(f"batch {batch} exceeds the launch grid")
    lengths = _frag.check_lengths(lengths, batch, x.device)

    lib = _library()
    ranks = _frag.CLUSTER_RANKS
    halo = n_layers * (k - 1) // 2
    bounds = _frag.cluster_bounds(h // 8, ranks)
    skip_cols = 8 * share
    launch = _frag.cluster_plan(("wn", h), halo, t, packed["stream_units"], share,
                                lambda r, tl, ub, n, s: lib.wn_stack_smem_bytes(h, r, tl, skip_cols, ub, n, s),
                                _MAX_STAGES)
    device = x.device.index or 0
    clusters = _frag.max_clusters(("wn", launch["smem"], device),
                                  lambda n: lib.wn_stack_max_clusters(launch["smem"], ranks, device, n))
    rows, tile = launch["rows"], launch["tile"]
    out = torch.empty_like(x)
    c_bounds = (ctypes.c_int * len(bounds))(*bounds)
    err = lib.wn_stack_bf16(
        x.data_ptr(), lengths.data_ptr(), packed["streams"].data_ptr(), packed["b_in"].data_ptr(),
        g_all.data_ptr(), packed["b_rs"].data_ptr(), out.data_ptr(), c_bounds, c_bounds, launch["plan"],
        batch, t, h, k, n_layers, rows, tile, skip_cols, launch["stages"], ranks, device,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"wn kernel launch failed with CUDA error {err}")
    count_launch(__name__)
    last_launch.update(ranks=ranks, rows=rows, tile=tile, tiles=-(-t // tile), ctas=-(-t // tile) * ranks * batch,
                       warpgroups=_frag.CLUSTER_WARPGROUPS, threads=128 * _frag.CLUSTER_WARPGROUPS,
                       width=_frag.CLUSTER_WIDTH, stages=launch["stages"], group=launch["group"],
                       max_clusters=clusters)
    return out
