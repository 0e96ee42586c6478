"""K2: one direction of the coupling flow as one hand-written CUDA kernel
(``csrc/coupling.cu``), launched as thread-block clusters: each time tile
is split over the R CTAs of one cluster, which share the window through
distributed shared memory (`_frag.cluster_bounds` is the column plan).  Its
products, their weight streams and their launch plan are K1's
(`_frag.add_streams`, `_frag.cluster_plan`).

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
from openvoice_tpu_torch.ops.wn_cuda import wn_layers_plain, wn_matrices, wn_products

launches = 0

# K2's one knob, as K1's (wn_cuda; ``python3 chip_smoke.py --sweep
# coupling`` times it; PERF.md has the table): ring groups at most.  The
# window's three buffers and skip sum leave a 128-row window four ring
# groups (the window recomputes S·L·(K−1)/2 frames a side, 32 in V2's flow),
# and two ring groups took 40 % longer.  The launch's shape is fixed
# (`_frag`'s CLUSTER_* constants).
_MAX_STAGES = _frag.MAX_STAGES

# what the last launch ran: ranks, rows, tile, CTAs, warpgroups, item
# columns, ring groups and their units, and cudaOccupancyMaxActiveClusters
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

    plus (`_frag.add_streams`) each CTA's weights as the kernel streams them,
    in bfloat16: per step pre, the WaveNet's products (`wn_cuda.wn_products`),
    post.
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
            wn = wn_matrices(layer.enc, torch.float32)
            cols["wp"].append(m_pre)
            cols["bp"].append(layer.pre.bias.float())
            cols["wq"].append(m_post)
            cols["bq"].append(v_post)
            for k in ("w_in", "b_in", "w_rs", "b_rs"):
                cols[k].append(wn[k])
        packed = {k: torch.stack(v).to(dtype).contiguous() for k, v in cols.items()}
        return _frag.add_streams(packed, coupling_products(packed))


def coupling_products(packed: dict) -> list[tuple]:
    """A direction's products in execution order as `_frag.cluster_streams`
    takes them: per step pre ([1, C, H]), the WaveNet's, post ([1, H, C])."""
    n_steps, _, _, h, _ = packed["w_in"].shape
    c = packed["wp"].shape[1]
    out = []
    for s in range(n_steps):
        out.append((packed["wp"][s][None], (0,), h // 8))
        out += wn_products(packed["w_in"][s], packed["w_rs"][s])
        out.append((packed["wq"][s][None], (0,), c // 8))
    return out


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
    lib.coupling_block_bf16.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.POINTER(ctypes.c_int)] * 3
                                        + [ctypes.c_int] * 13 + [ctypes.c_void_p])
    lib.coupling_block_bf16.restype = ctypes.c_int
    lib.coupling_smem_bytes.argtypes = [ctypes.c_int] * 7
    lib.coupling_smem_bytes.restype = ctypes.c_int
    lib.coupling_max_clusters.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.coupling_max_clusters.restype = ctypes.c_int
    lib.coupling_attributes.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.coupling_attributes.restype = ctypes.c_int
    return lib


def kernel_attributes() -> dict:
    """Registers and spilled bytes a thread of the kernel, as ptxas left
    them (cudaFuncGetAttributes)."""
    out = (ctypes.c_int * 2)()
    err = _library().coupling_attributes(out)
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes of K2 failed with CUDA error {err}")
    return {"registers": out[0], "spill_bytes": out[1]}


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
    share = _frag.check_streams(packed, n_steps * (2 * n_layers + 2), x.device)
    for name in ("bp", "b_in", "b_rs", "bq"):
        _frag.check_bf16(name, packed[name])
        if packed[name].device != x.device:
            raise ValueError(f"{name} on {packed[name].device}, x on {x.device}")
    if batch > _frag.GRID_MAX_Y:
        raise ValueError(f"batch {batch} exceeds the launch grid")
    lengths = _frag.check_lengths(lengths, batch, x.device)

    lib = _library()
    ranks = _frag.CLUSTER_RANKS
    halo = n_steps * n_layers * (k - 1) // 2
    c_bounds, h_bounds = _frag.cluster_bounds(c // 8, ranks), _frag.cluster_bounds(h // 8, ranks)
    skip_cols = 8 * share
    launch = _frag.cluster_plan(
        ("coupling", c, h), halo, t, packed["stream_units"], share,
        lambda r, _tile, ub, n, s: lib.coupling_smem_bytes(c, h, r, skip_cols, ub, n, s), _MAX_STAGES)
    device = x.device.index or 0
    clusters = _frag.max_clusters(("coupling", launch["smem"], device),
                                  lambda n: lib.coupling_max_clusters(launch["smem"], ranks, device, n))
    rows, tile = launch["rows"], launch["tile"]
    out = torch.empty_like(x)
    err = lib.coupling_block_bf16(
        x.data_ptr(), lengths.data_ptr(), packed["streams"].data_ptr(), packed["bp"].data_ptr(),
        packed["b_in"].data_ptr(), g_all.data_ptr(), packed["b_rs"].data_ptr(), packed["bq"].data_ptr(),
        out.data_ptr(), (ctypes.c_int * len(c_bounds))(*c_bounds), (ctypes.c_int * len(h_bounds))(*h_bounds),
        launch["plan"], batch, t, c, h, k, n_layers, n_steps, rows, tile, skip_cols, launch["stages"], ranks,
        device, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"coupling kernel launch failed with CUDA error {err}")
    count_launch(__name__)
    last_launch.update(ranks=ranks, rows=rows, tile=tile, ctas=-(-t // tile) * ranks * batch,
                       warpgroups=_frag.CLUSTER_WARPGROUPS, threads=128 * _frag.CLUSTER_WARPGROUPS,
                       width=_frag.CLUSTER_WIDTH, stages=launch["stages"], group=launch["group"],
                       max_clusters=clusters)
    return out
