"""K2: one direction of the coupling flow as one hand-written CUDA kernel
(``csrc/coupling.cu``), launched as thread-block clusters: each time tile
is split over the R CTAs of one cluster, which share the window through
distributed shared memory (`_frag.cluster_bounds` is the column plan).

Replaces ``openvoice_tpu/ops/coupling_pallas.py::fused_coupling_block`` with
its packers (`_exec_order`, `pack_coupling_block`, `coupling_g_stack`).  The
channel Flip between couplings moves no data: coupling s sees the state
through s flips, so its pre matrix reads the right (possibly reversed) half
from the unflipped state and its post matrix scatters the update into the
right lanes; the reverse direction negates post.  A CUDA tensor goes to the
kernel, a CPU tensor to `coupling_block_plain`; nothing falls back.

``launches`` counts the kernel's launches; it is raised where the kernel is
launched and nowhere else (`ops.count_launch`: a
launch recorded into a CUDA graph counts at each replay).
"""

from __future__ import annotations

import ctypes

import torch

from openvoice_tpu_torch.ops import count_launch, _frag, _nvcc
from openvoice_tpu_torch.ops.wn_cuda import stack_wn_params, wn_layers_plain

launches = 0

# CTAs a cluster splits a time tile over, frames a tile keeps (the window
# recomputes S·L·(K−1)/2 more a side), and threads a CTA (at most 384:
# MAX_THREADS in csrc/coupling.cu).  On one H100 (``python3 chip_smoke.py
# --sweep coupling``, PERF.md) a 64-frame tile on 4 CTAs with 12 warps was
# fastest: 16 clusters of 128 rows fit in one wave (30 clusters of 4 fit on
# the card, so 32 of 96 rows take two), and 12 warps hold a CTA's 12 gate
# tiles.
_RANKS = 4
_TILE_TARGET = 64
_THREADS = 384

# what the last launch ran: ranks, rows, tile, CTAs, and
# cudaOccupancyMaxActiveClusters for its CTA size
last_launch: dict = {}


def _exec_order(n_couplings: int, reverse: bool) -> list[tuple[int, int]]:
    """(coupling index, flip parity of the state that coupling sees) in
    execution order.  Forward: coupling c runs after c flips.  Reverse
    (flip⁻¹ then coupling⁻¹, the chain backwards): step s undoes coupling
    n−1−s and sees the state through s+1 flips."""
    if not reverse:
        return [(s, s % 2) for s in range(n_couplings)]
    return [(n_couplings - 1 - s, (s + 1) % 2) for s in range(n_couplings)]


def _couplings(flow) -> list:
    return list(flow.flows[::2])  # odd slots are the parameter-free flips


def pack_coupling_block(flow, *, reverse: bool, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Pack one direction of a `nn.flows.ResidualCouplingBlock`, once.  All
    arrays are indexed by execution step:

      wp [S, C, H]  pre 1×1 lifted to the state's lanes (flip folded in)
      bp [S, H]
      w_in [S, L, K, H, 2H], b_in [S, L, 2H], w_rs [S, L, H, 2H], b_rs [S, L, 2H]
      wq [S, H, C]  post 1×1 scattered to the target lanes, negated for reverse
      bq [S, C]     post bias, same placement and sign

    plus ``*_frag`` copies of the matrices in the kernel's fragment order
    (None where the sizes have no such layout).
    """
    layers = _couplings(flow)
    half = layers[0].half
    c = 2 * half
    hidden = layers[0].enc.hidden
    cols = {k: [] for k in ("wp", "bp", "wq", "bq", "w_in", "b_in", "w_rs", "b_rs")}
    with torch.no_grad():
        for index, parity in _exec_order(len(layers), reverse):
            layer = layers[index]
            pre_w = layer.pre.weight[:, :, 0].t().float()    # [half, H]
            post_w = layer.post.weight[:, :, 0].t().float()  # [H, half]
            post_b = layer.post.bias.float()
            if post_w.shape[1] != half:
                raise ValueError(f"the fused flow needs mean-only couplings: post width "
                                 f"{post_w.shape[1]} != half {half} (coupling {index})")
            m_pre = pre_w.new_zeros(c, hidden)
            m_post = pre_w.new_zeros(hidden, c)
            v_post = pre_w.new_zeros(c)
            if parity == 0:
                # x0 is lanes [0, half); the update lands in lanes [half, c)
                m_pre[:half] = pre_w
                m_post[:, half:] = post_w
                v_post[half:] = post_b
            else:
                # seen through one flip, x0[j] = x[c−1−j]: the reversed upper
                # half; the update lands reversed in the lower half
                idx = torch.arange(half)
                m_pre[c - 1 - idx] = pre_w
                m_post[:, half - 1 - idx] = post_w
                v_post[half - 1 - idx] = post_b
            if reverse:
                m_post, v_post = -m_post, -v_post
            wn = stack_wn_params(layer.enc, torch.float32)
            cols["wp"].append(m_pre)
            cols["bp"].append(layer.pre.bias.float())
            cols["wq"].append(m_post)
            cols["bq"].append(v_post)
            for k in ("w_in", "b_in", "w_rs", "b_rs"):
                cols[k].append(wn[k])
        packed = {k: torch.stack(v).to(dtype).contiguous() for k, v in cols.items()}
        for k in ("wp", "wq", "w_in", "w_rs"):
            packed[f"{k}_frag"] = _frag.maybe_frag(packed[k])
    return packed


def coupling_g_stack(flow, g: torch.Tensor, *, reverse: bool, convs=None) -> torch.Tensor:
    """Each coupling's conditioning 1×1 conv applied to g [B, 1, gin], stacked
    in execution order → [B, S, L, 2H] in g's dtype.  `convs`, when given,
    are the couplings' ``cond_layer``s to use instead of the flow's own (the
    serving mode passes bf16 copies)."""
    layers = _couplings(flow)
    convs = convs if convs is not None else [layer.enc.cond_layer for layer in layers]
    g_t = g.transpose(1, 2)  # [B, gin, 1]
    stacked = []
    for index, _parity in _exec_order(len(layers), reverse):
        enc = layers[index].enc
        n_layers = len(enc.in_layers)
        if convs[index] is None:  # a coupling without conditioning (a checkpoint that lacks it) adds nothing
            stacked.append(g.new_zeros(g.shape[0], n_layers, 2 * enc.hidden))
        else:
            stacked.append(convs[index](g_t).reshape(g.shape[0], n_layers, -1))  # [B, L, 2H]
    return torch.stack(stacked, dim=1).contiguous()


def coupling_block_plain(x: torch.Tensor, lengths: torch.Tensor, packed: dict,
                         g_all: torch.Tensor) -> torch.Tensor:
    """`coupling_block` in plain PyTorch, in x's dtype, with the kernel's
    rounding points; products in f32."""
    dt = x.dtype
    mask = _frag.length_mask(lengths, x.shape[1])
    state = x.float() * mask
    for s in range(packed["wp"].shape[0]):
        h = (state @ packed["wp"][s].float() + packed["bp"][s].float()).to(dt).float() * mask
        skip = wn_layers_plain(h, mask, dt, packed["w_in"][s], packed["b_in"][s], g_all[:, s],
                               packed["w_rs"][s], packed["b_rs"][s])
        m = skip.to(dt).float() * mask
        placed = (m @ packed["wq"][s].float() + packed["bq"][s].float()).to(dt).float()
        state = (state + placed).to(dt).float() * mask
    return state.to(dt)


def _library() -> ctypes.CDLL:
    lib = _nvcc.load("coupling")
    lib.coupling_block_bf16.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.POINTER(ctypes.c_int)] * 2
                                        + [ctypes.c_int] * 13 + [ctypes.c_void_p])
    lib.coupling_block_bf16.restype = ctypes.c_int
    lib.coupling_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.coupling_smem_bytes.restype = ctypes.c_int
    lib.coupling_max_clusters.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    lib.coupling_max_clusters.restype = ctypes.c_int
    return lib


def coupling_block(x: torch.Tensor, lengths: torch.Tensor, packed: dict,
                   g_all: torch.Tensor) -> torch.Tensor:
    """x [B, T, C] flow input; lengths [B] true frame counts; packed from
    `pack_coupling_block` (one direction) in x's dtype; g_all [B, S, L, 2H]
    from `coupling_g_stack` of the same direction → [B, T, C].  Frames past a
    row's length come out exactly 0."""
    if x.dim() != 3:
        raise ValueError(f"coupling_block takes [B, T, C], got {tuple(x.shape)}")
    batch, t, c = x.shape
    n_steps, n_layers, k, h, _ = packed["w_in"].shape
    if packed["wp"].shape != (n_steps, c, h) or k % 2 == 0:
        raise ValueError(f"packed weights {tuple(packed['wp'].shape)} do not fit C = {c}")
    if g_all.shape != (batch, n_steps, n_layers, 2 * h):
        raise ValueError(f"g_all must be [{batch}, {n_steps}, {n_layers}, {2 * h}], got {tuple(g_all.shape)}")
    if packed["wp"].dtype != x.dtype or g_all.dtype != x.dtype:
        raise TypeError(f"x {x.dtype}, weights {packed['wp'].dtype}, g_all {g_all.dtype} must agree")
    if batch == 0 or t == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("coupling_block takes a contiguous activation")
    if x.device.type == "cpu":
        return coupling_block_plain(x, lengths, packed, g_all)
    if x.device.type != "cuda":
        raise ValueError(f"coupling_block runs on cuda or cpu, not {x.device}")

    _frag.check_bf16("x", x)
    _frag.check_bf16("g_all", g_all)
    frags = ("wp_frag", "w_in_frag", "w_rs_frag", "wq_frag")
    if any(packed[name] is None for name in frags) or c % 16 or h % 16:
        raise ValueError(f"the kernel needs C % 16 == 0 and H % 16 == 0, got C = {c}, H = {h}")
    for name in frags + ("bp", "b_in", "b_rs", "bq"):
        _frag.check_bf16(name, packed[name])
        if packed[name].device != x.device:
            raise ValueError(f"{name} on {packed[name].device}, x on {x.device}")
    if batch > _frag.GRID_MAX_Y:
        raise ValueError(f"batch {batch} exceeds the launch grid")
    lengths = _frag.check_lengths(lengths, batch, x.device)

    lib = _library()
    halo = n_steps * n_layers * (k - 1) // 2
    c_bounds, h_bounds = _frag.cluster_bounds(c // 8, _RANKS), _frag.cluster_bounds(h // 8, _RANKS)
    skip_cols = 8 * max(b - a for a, b in zip(h_bounds, h_bounds[1:]))
    rows, tile = _frag.window(("coupling", c, h, _RANKS), halo, t, _TILE_TARGET,
                              lambda r, tl: lib.coupling_smem_bytes(c, h, r, skip_cols))
    device = x.device.index or 0
    clusters = _frag.max_clusters(
        ("coupling", c, h, rows, skip_cols, _THREADS, _RANKS, device),
        lambda n: lib.coupling_max_clusters(c, h, rows, skip_cols, _THREADS, _RANKS, device, n))
    out = torch.empty_like(x)
    err = lib.coupling_block_bf16(
        x.data_ptr(), lengths.data_ptr(), packed["wp_frag"].data_ptr(), packed["bp"].data_ptr(),
        packed["w_in_frag"].data_ptr(), packed["b_in"].data_ptr(), g_all.data_ptr(),
        packed["w_rs_frag"].data_ptr(), packed["b_rs"].data_ptr(), packed["wq_frag"].data_ptr(),
        packed["bq"].data_ptr(), out.data_ptr(),
        (ctypes.c_int * len(c_bounds))(*c_bounds), (ctypes.c_int * len(h_bounds))(*h_bounds),
        batch, t, c, h, k, n_layers, n_steps, rows, tile, skip_cols, _THREADS, _RANKS, device,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"coupling kernel launch failed with CUDA error {err}")
    count_launch(__name__)
    last_launch.update(ranks=_RANKS, rows=rows, tile=tile, ctas=-(-t // tile) * _RANKS * batch,
                       max_clusters=clusters)
    return out
