"""K4: a decoder stage with its upsample as one hand-written CUDA kernel
(``csrc/tail.cu``).

Replaces ``openvoice_tpu/ops/mrf_pallas.py::fused_tail_stage``: leaky ReLU →
ConvTranspose1d → mask → the MRF stage of K3, and on the last stage leaky
ReLU 0.01 → conv_post → tanh, which gives the audio.  Every product runs on
Hopper's warpgroup MMA with N = C (16, 32 or 64 channels), its weights the
stage's stream of slabs (`pack_stream`) in a shared-memory ring, or resident
where the whole stream fits beside the window.  Each MRF conv runs on the
64-row tiles `tail_tiles` gives, and a tile wholly past the true length
(`live_tiles`) writes its zeros and returns.  A CUDA tensor goes to the
kernel, a CPU tensor to `tail_stage_plain`; nothing falls back.

``launches`` counts the kernel's launches; it is raised where the kernel is
launched and nowhere else (`ops.count_launch`: a
launch recorded into a CUDA graph counts at each replay).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from openvoice_tpu_torch.ops import count_launch, _frag, _nvcc
from openvoice_tpu_torch.ops.mrf_cuda import (
    LRELU_SLOPE, TILE_M, check_stage, check_stage_cuda, conv_tiles, lrelu_plain,
    mrf_branches_plain, stage_halo, stage_weights,
)

launches = 0

POST_SLOPE = 0.01   # the last activation uses torch's default slope
WIDTHS = (16, 32, 64)   # the channel counts csrc/tail.cu has an instance of (N = C)
WARPGROUPS = 4          # warpgroups a block (WARPGROUPS in csrc/tail.cu)
MAX_GROUP = 16          # slabs a ring group at most (MAX_GROUP in csrc/ring.cuh)
# The launch plan (`launch_plan`) follows from what the wrapper sees: C, the
# length, the stage's structure and shared memory (`_frag.plan_window`,
# which K3 shares).  The window is a multiple of 64 rows, the largest (up to
# `_TILE_TARGET` kept rows) that fits beside `_RING_RESERVE` bytes of ring;
# the whole weight stream then stays resident if it fits beside that window
# (C = 16), else the ring takes as many groups of `copy_group(C)` slabs as
# fit, up to `_frag.MAX_STAGES`.  The knobs are the ones ``python3
# chip_smoke.py --sweep tail`` times: the ring's reserve and the tile
# target; PERF.md has the table the defaults came from.
_TILE_TARGET = 640
_RING_RESERVE = 32768
# what the last launch ran: window rows and tile, halo, warpgroups, threads,
# tiles in the grid, shared memory a block, ring groups (0: resident) and
# slabs a group
last_launch: dict = {}
_PLANS: dict[tuple, tuple] = {}


def phase_taps(k_up: int, stride: int, pad_up: int) -> list[tuple[int, list[int]]]:
    """Each output phase f of the transposed conv as (ds0, taps): output row
    m·stride + f takes tap taps[i] from input row m + ds0 − i
    (csrc/tail.cu: taps j0 + i·stride with j0 = (f + p) mod stride,
    ds0 = (f + p) div stride)."""
    out = []
    for f in range(stride):
        j0, ds0 = (f + pad_up) % stride, (f + pad_up) // stride
        out.append((ds0, list(range(j0, k_up, stride))))
    return out


def pack_stream(up_w: torch.Tensor, w: torch.Tensor, stride: int, pad_up: int) -> torch.Tensor | None:
    """The kernel's weight stream [n_slabs, C, 16] bfloat16: for each
    upsample phase (`phase_taps`) its taps' slabs, then every MRF tap's, each
    (tap, k-tile) one slab of `_frag.pack_slabs`'s layout (wgmma's
    swizzled B tile).  up_w [k_up, C_in, C], w [n_taps, C, C].  None where
    the sizes have no such layout (the kernel takes C_in % 16 == 0 and C in
    `WIDTHS`; the plain version does not need it)."""
    c = w.shape[-1]
    if c not in WIDTHS or up_w.shape[1] % 16:
        return None
    order = [j for _, taps in phase_taps(up_w.shape[0], stride, pad_up) for j in taps]
    up = _frag.pack_slabs(up_w[order], 16)
    return torch.cat([up.reshape(-1, c, 16), _frag.pack_slabs(w, 16).reshape(-1, c, 16)]).contiguous()


def copy_group(c: int) -> int:
    """Slabs the ring moves in one copy (csrc/tail.cu's group_of): 16 KB of
    weights (one thread's bulk copies complete one after another, about as
    fast at any size up to 16 KB), 8 slabs at C = 64, 16 below.  A warpgroup
    issues a group's products eight slabs at a time."""
    return min(MAX_GROUP, max(1, 16384 // (32 * c)))


def pack_tail_weights(up, resblocks, conv_post=None, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Pack one stage for `tail_stage`, once: the stage's `ConvTranspose1d`
    `up`, its ResBlock1 branches, and on the last stage `conv_post`.

      up_w [k_up, C_in, C_out]  tap j is the transposed conv's W[:, :, j]
      up_b [C_out], stride, pad_up
      post_w [k_post, C_out] or None
      and the keys of `mrf_cuda.stage_weights`; ``slabs`` is the kernel's
      weight stream (`pack_stream`; None where the sizes have no such
      layout).
    """
    k_up, stride, pad_up = up.kernel_size[0], up.stride[0], up.padding[0]
    if k_up - stride - 2 * pad_up != 0 or up.output_padding[0] != 0 or up.dilation[0] != 1:
        raise ValueError(f"the fused stage needs T_out = T_in·stride: kernel {k_up}, stride {stride}, "
                         f"padding {pad_up}")
    packed = stage_weights(resblocks, dtype)
    with torch.no_grad():
        packed["up_w"] = up.weight.permute(2, 0, 1).to(dtype).contiguous()
        packed["up_b"] = up.bias.to(dtype).contiguous()
        packed["post_w"] = None
        if conv_post is not None:
            if conv_post.bias is not None or conv_post.out_channels != 1:
                raise ValueError("conv_post must have one output channel and no bias")
            packed["post_w"] = conv_post.weight[0].t().to(dtype).contiguous()  # [k_post, C]
    packed["slabs"] = pack_stream(packed["up_w"], packed["w"], stride, pad_up)
    packed["stride"], packed["pad_up"] = stride, pad_up
    return packed


def tail_stage_plain(x: torch.Tensor, lengths: torch.Tensor, packed: dict) -> torch.Tensor:
    """`tail_stage` in plain PyTorch, in x's dtype, with the kernel's
    rounding points; products in f32."""
    dt = x.dtype
    stride = packed["stride"]
    t_out = x.shape[1] * stride
    mask_in = _frag.length_mask(lengths // stride, x.shape[1])
    mask = _frag.length_mask(lengths, t_out)
    xin = lrelu_plain(x.float(), LRELU_SLOPE, dt) * mask_in
    y = F.conv_transpose1d(xin.transpose(1, 2), packed["up_w"].float().permute(1, 2, 0),
                           packed["up_b"].float(), stride=stride, padding=packed["pad_up"])
    x0 = y.transpose(1, 2).to(dt).float() * mask
    mean = mrf_branches_plain(x0, mask, dt, packed)
    if packed["post_w"] is None:
        return mean.to(dt)
    ym = lrelu_plain(mean.to(dt).float(), POST_SLOPE, dt)
    post = packed["post_w"].float()  # [k, C]
    audio = F.conv1d(ym.transpose(1, 2), post.t()[None], padding=(post.shape[0] - 1) // 2)
    return torch.tanh(audio).transpose(1, 2).to(dt)


def _in_margin(k_up: int, stride: int, pad_up: int) -> int:
    """How far, in input samples, an output phase reaches to either side
    (csrc/tail.cu: phase f takes input rows m + (f + p) div u − i)."""
    return max(max(abs(ds0), abs(ds0 - len(taps) + 1)) for ds0, taps in phase_taps(k_up, stride, pad_up))


def tail_halo(kernel_sizes, dilation_sizes, k_post: int, stride: int) -> int:
    """Recomputed rows a side of a window: the branches' reach, plus
    conv_post's on the last stage (k_post > 0), kept a multiple of the
    stride so that windows start on an input sample."""
    halo = stage_halo(kernel_sizes, dilation_sizes) + max(k_post - 1, 0) // 2
    return -(-halo // stride) * stride


def tail_tiles(kernel_sizes, dilation_sizes, halo: int, tile: int, rows: int,
               post_half: int) -> list[tuple[int, int]]:
    """The 64-row tiles (first row, count) each MRF conv computes, in
    execution order: `mrf_cuda.conv_tiles` of the kept rows, which on the
    last stage reach `post_half` rows past the tile a side because conv_post
    reads them."""
    return conv_tiles(kernel_sizes, dilation_sizes, halo - post_half, tile + 2 * post_half, rows)


def live_tiles(len_out: int, tile: int, post_half: int, t_out: int) -> int:
    """How many of a row's tiles the kernel computes: tile i (first sample
    t0 = i·tile) returns at once, with its output all zero, when
    t0 − post_half ≥ len_out; the tiles before it compute."""
    return min(-(-(min(len_out, t_out) + post_half) // tile), -(-t_out // tile))


def launch_plan(cin: int, c: int, t_out: int, k_up: int, stride: int, pad_up: int, k_post: int,
                kernel_sizes, dilation_sizes) -> tuple:
    """(rows, tile, halo, stages, group, ring slabs, plan, smem bytes) of a
    launch: the window and weight ring of the comment above (stages 0: the
    stream is resident, ring slabs then the whole stream's), and
    `_frag.ring_plan` over the upsample's phases (every phase row) and
    `tail_tiles` of that window.  Computed once per sizes and knobs."""
    key = (cin, c, min(_TILE_TARGET, max(t_out, 1)), k_up, stride, pad_up, k_post, kernel_sizes, dilation_sizes,
           _TILE_TARGET, _RING_RESERVE)
    if key not in _PLANS:
        if TILE_M % stride:
            raise ValueError(f"the kernel's 64-row windows take a stride dividing 64, got {stride}")
        lib = _library()
        margin = _in_margin(k_up, stride, pad_up)
        halo = tail_halo(kernel_sizes, dilation_sizes, k_post, stride)
        n_convs = 2 * sum(len(d) for d in dilation_sizes)
        n_slabs = stream_slabs(cin, c, k_up, kernel_sizes, dilation_sizes)

        def smem(rows, slabs, stages):
            return lib.tail_stage_smem_bytes(cin, c, stride, margin, rows, n_convs, slabs, stages)

        group = copy_group(c)
        rows, tile, stages = _frag.plan_window(("tail", cin, c, stride, margin, n_convs), halo, t_out,
                                               _TILE_TARGET, smem, group, _RING_RESERVE // (32 * c),
                                               stream_slabs=n_slabs)
        ring_slabs = stages * group if stages else n_slabs
        phases = [(0, -(-(rows // stride) // TILE_M), len(taps) * (cin // 16))
                  for _, taps in phase_taps(k_up, stride, pad_up)]
        tiles = tail_tiles(kernel_sizes, dilation_sizes, halo, tile, rows, max(k_post - 1, 0) // 2)
        steps = [k * (c // 16) for k, dils in zip(kernel_sizes, dilation_sizes) for _ in range(2 * len(dils))]
        plan = _frag.ring_plan(phases + [(*rng, s) for rng, s in zip(tiles, steps)], group, WARPGROUPS)
        _PLANS[key] = (rows, tile, halo, stages, group, ring_slabs, plan, smem(rows, ring_slabs, stages))
    return _PLANS[key]


def stream_slabs(cin: int, c: int, k_up: int, kernel_sizes, dilation_sizes) -> int:
    """Slabs in the weight stream of a stage (`pack_stream`): each upsample
    tap's C_in/16, each MRF tap's C/16."""
    return k_up * (cin // 16) + sum(2 * k * len(d) for k, d in zip(kernel_sizes, dilation_sizes)) * (c // 16)


def _library() -> ctypes.CDLL:
    lib = _nvcc.load("tail")
    lib.tail_stage_bf16.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.POINTER(ctypes.c_int)] * 3
        + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.tail_stage_bf16.restype = ctypes.c_int
    lib.tail_stage_smem_bytes.argtypes = [ctypes.c_int] * 8
    lib.tail_stage_smem_bytes.restype = ctypes.c_int
    lib.tail_stage_attributes.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.tail_stage_attributes.restype = ctypes.c_int
    return lib


def kernel_attributes(c: int, smem: int, device: int = 0) -> dict:
    """What the kernel instance of C channels takes on the card: registers
    and local (spilled) bytes a thread (cudaFuncGetAttributes), and how many
    of its blocks of `smem` bytes an SM holds
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    out = (ctypes.c_int * 3)()
    err = _library().tail_stage_attributes(c, smem, device, out)
    if err != 0:
        raise RuntimeError(f"tail kernel attributes failed with error {err} (C = {c})")
    return {"registers": out[0], "spill_bytes": out[1], "blocks_per_sm": out[2]}


def tail_stage(x: torch.Tensor, lengths: torch.Tensor, packed: dict) -> torch.Tensor:
    """x [B, T_in, C_in], the input of an upsample stage; lengths [B] true
    OUTPUT sample counts (input lengths · stride); packed from
    `pack_tail_weights` in x's dtype.  With ``post_w`` (the last stage)
    returns the audio [B, T_in·stride, 1]; without, the stage's activations
    [B, T_in·stride, C_out].  Activations past a row's length come out exactly
    0; the audio does from conv_post's reach past it (no mask follows conv_post,
    as in the Pallas kernel)."""
    if x.dim() != 3:
        raise ValueError(f"tail_stage takes [B, T, C], got {tuple(x.shape)}")
    batch, t_in, cin = x.shape
    k_up, cin_w, c = packed["up_w"].shape
    stride, pad_up, post_w = packed["stride"], packed["pad_up"], packed["post_w"]
    if cin_w != cin:
        raise ValueError(f"packed upsample takes {cin_w} channels, x has {cin}")
    check_stage(packed, c, x.dtype)
    if batch == 0 or t_in == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("tail_stage takes a contiguous activation")
    if x.device.type == "cpu":
        return tail_stage_plain(x, lengths, packed)
    if x.device.type != "cuda":
        raise ValueError(f"tail_stage runs on cuda or cpu, not {x.device}")

    _frag.check_bf16("x", x)
    if c not in WIDTHS or cin % 16:
        raise ValueError(f"the kernel takes C in {WIDTHS} and C_in % 16 == 0, got C = {c}, C_in = {cin}")
    ks, dils = check_stage_cuda(packed, c, x.device, "slabs", 16)
    for name in ("up_b",) + (("post_w",) if post_w is not None else ()):
        _frag.check_bf16(name, packed[name])
        if packed[name].device != x.device:
            raise ValueError(f"{name} on {packed[name].device}, x on {x.device}")
    if batch > _frag.GRID_MAX_Y:
        raise ValueError(f"batch {batch} exceeds the launch grid")
    lengths = _frag.check_lengths(lengths, batch, x.device)

    lib = _library()
    k_post = post_w.shape[0] if post_w is not None else 0
    margin = _in_margin(k_up, stride, pad_up)
    t_out = t_in * stride
    rows, tile, halo, stages, group, _, plan, smem = launch_plan(
        cin, c, t_out, k_up, stride, pad_up, k_post, packed["kernel_sizes"], packed["dilation_sizes"])
    if packed["slabs"].shape[0] != stream_slabs(cin, c, k_up, packed["kernel_sizes"], packed["dilation_sizes"]):
        raise ValueError(f"the packed stream has {packed['slabs'].shape[0]} slabs, not this stage's")
    out = torch.empty((batch, t_out, 1 if post_w is not None else c), dtype=x.dtype, device=x.device)
    # where the finished branches' outputs wait for the last one: a tile (and
    # conv_post's reach) a block
    scratch = torch.empty(batch * -(-t_out // tile) * (len(packed["kernel_sizes"]) - 1)
                          * (tile + max(k_post - 1, 0)) * c, dtype=torch.bfloat16, device=x.device)
    device = x.device.index or 0
    err = lib.tail_stage_bf16(
        x.data_ptr(), lengths.data_ptr(), packed["slabs"].data_ptr(), packed["up_b"].data_ptr(),
        packed["b"].data_ptr(), post_w.data_ptr() if post_w is not None else None, out.data_ptr(),
        scratch.data_ptr(), batch, t_in, cin, c, stride, pad_up, margin, k_post,
        len(packed["kernel_sizes"]), len(packed["dilation_sizes"][0]), ks, dils, plan,
        rows, tile, stages, group, device, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"tail kernel launch failed with error {err} (CUDA's, or -1: a launch the kernel "
                           f"cannot take)")
    count_launch(__name__)
    last_launch.update(rows=rows, tile=tile, halo=halo, warpgroups=WARPGROUPS, threads=128 * WARPGROUPS,
                       tiles=-(-t_out // tile), smem=smem, stages=stages, group=group)
    return out
