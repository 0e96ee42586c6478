"""K3: one HiFi-GAN multi-receptive-field stage as one hand-written CUDA
kernel (``csrc/mrf.cu``).

Replaces ``openvoice_tpu/ops/mrf_pallas.py::fused_mrf_stage``: the mean of
the stage's ResBlock1 branches, with masks rebuilt from the true sample
lengths before every conv, the activation read once and written once.  A
CUDA tensor goes to the kernel, a CPU tensor to `mrf_stage_plain`; nothing
falls back.

``launches`` counts the kernel's launches; it is raised where the kernel is
launched and nowhere else (`ops.count_launch`: a
launch recorded into a CUDA graph counts at each replay).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from openvoice_tpu_torch.ops import count_launch, _frag, _nvcc

launches = 0

LRELU_SLOPE = 0.1
MAX_BRANCHES = 4   # MAX_BRANCHES / MAX_PAIRS in csrc/mrf_core.cuh
MAX_PAIRS = 4
TILE_M = _frag.TILE_M  # rows of one wgmma tile (TILE_M in csrc/ring.cuh)
WARPGROUPS = 3     # warpgroups a block (WARPGROUPS in csrc/mrf.cu)
WIDTHS = (256, 128, 64)   # the product widths csrc/mrf.cu has an instance of
# The launch plan (`launch_plan`) follows from what the wrapper sees: C, T,
# the kernel sizes and dilations, and shared memory (`_frag.plan_window`,
# which K4 shares).  A block's window is a multiple of 64 rows, the largest (up to
# `_TILE_TARGET` kept rows) that fits beside a ring of `_RING_RESERVE` slabs
# of 32·C bytes; the ring then takes as many groups of `ring_group` slabs as
# fit beside it, up to `_MAX_STAGES` slabs.  A warpgroup computes one item
# a round, a 64-row tile by `product_width(C)` columns, and each conv covers
# its range with whole tiles placed from the range's first row
# (`conv_tiles`).  At C = 256 the window is 192 rows (72 kept), the ring 4
# slabs in groups of 2, and the tiles compute 2.19x the useful products
# (2.67x if placed at 64-row boundaries, 1.87x at 16-row chunks).  At C =
# 128: 384 rows (264 kept), 8 slabs in groups of 4, 1.32x.  What bounds K3
# on the card is then the products that one warpgroup issues between waits
# on its own, which ptxas asks of A in registers, so that only the other
# warpgroups' products fill the tensor cores while it loads; the ring, whose
# copies wait for the slowest warpgroup; and the epilogues and block
# barriers between convs, which no product overlaps.  The knobs are the ones
# ``python3 chip_smoke.py --sweep mrf`` times (ring depth, tile target);
# PERF.md has the table the defaults came from.
_TILE_TARGET = 4096
_RING_RESERVE = 4  # slabs
_MAX_STAGES = 16   # slabs
# launch plans, kept per sizes and knobs (`launch_plan`)
_PLANS: dict[tuple, tuple] = {}


def conv_reaches(kernel_size: int, dilations) -> list[int]:
    """How far each conv of one branch reads a side, in execution order
    (per dilation d: the dilated conv (k−1)/2·d, then the second conv (k−1)/2)."""
    h = (kernel_size - 1) // 2
    return [r for d in dilations for r in (h * d, h)]


def stage_halo(kernel_sizes, dilation_sizes) -> int:
    """The deepest branch's reach in samples a side: the sum of its convs'."""
    return max(sum(conv_reaches(k, dils)) for k, dils in zip(kernel_sizes, dilation_sizes))


def conv_ranges(kernel_sizes, dilation_sizes, halo: int, tile: int) -> list[tuple[int, int]]:
    """The window rows [lo, hi) on which each conv's output is still read,
    in execution order: the kept rows [halo, halo + tile) widened a side by
    the reaches of the convs after it in its branch.  The least that
    suffices: a row fewer on either side and a kept row goes wrong."""
    ranges = []
    for k, dils in zip(kernel_sizes, dilation_sizes):
        reach = conv_reaches(k, dils)
        for j in range(len(reach)):
            wide = sum(reach[j + 1:])
            ranges.append((halo - wide, halo + tile + wide))
    return ranges


def conv_tiles(kernel_sizes, dilation_sizes, halo: int, tile: int, rows: int) -> list[tuple[int, int]]:
    """`conv_ranges` as the kernel computes them: (first row, count) of the
    64-row tiles that cover each range, placed from the range's first row
    (moved back only as far as the window's end asks).  The last tile may
    reach past the range; those rows hold stale values that no later conv's
    range reads, so they never reach the kept rows."""
    out = []
    for lo, hi in conv_ranges(kernel_sizes, dilation_sizes, halo, tile):
        count = -(-(hi - lo) // TILE_M)
        first = min(lo, rows - count * TILE_M)
        if first < 0:
            raise ValueError(f"rows [{lo}, {hi}) do not fit a {rows}-row window in {TILE_M}-row tiles")
        out.append((first, count))
    return out


def ring_group(width: int) -> int:
    """Slabs of a K3 ring group, which the ring moves in one copy and a
    warpgroup's products take between waits (csrc/mrf.cu's group_of): two at
    256 columns, whose accumulators leave room for two slabs' fragments,
    four below."""
    return 2 if width >= 256 else 4


def product_width(c: int) -> int | None:
    """The columns of one warpgroup's product: the widest instance of the
    kernel (`WIDTHS`) that divides C (as csrc/mrf.cu's width_of); None where
    none does."""
    return next((n for n in WIDTHS if c % n == 0), None)


def launch_plan(c: int, t: int, kernel_sizes, dilation_sizes) -> tuple:
    """(rows, tile, stages, group, width, plan) of a launch at C channels
    and T samples: the window and ring of the comment above, the product
    width, and `_frag.ring_plan` over `conv_tiles` of that window.  Computed once
    per sizes and knobs."""
    key = (c, min(_TILE_TARGET, max(t, 1)), kernel_sizes, dilation_sizes, _RING_RESERVE, _TILE_TARGET, _MAX_STAGES)
    if key not in _PLANS:
        lib = _library()
        width = product_width(c) or TILE_M
        group = ring_group(width)
        halo = stage_halo(kernel_sizes, dilation_sizes)
        rows, tile, stages = _frag.plan_window(
            ("mrf", c), halo, t, _TILE_TARGET, lambda r, slabs, n: lib.mrf_stage_smem_bytes(c, r, slabs, n), group,
            _RING_RESERVE, _MAX_STAGES)
        steps = [k * (c // 16) for k, dils in zip(kernel_sizes, dilation_sizes) for _ in range(2 * len(dils))]
        tiles = conv_tiles(kernel_sizes, dilation_sizes, halo, tile, rows)
        plan = _frag.ring_plan([(*rng, s) for rng, s in zip(tiles, steps)], group, WARPGROUPS, c // width)
        _PLANS[key] = (rows, tile, stages, group, width, plan)
    return _PLANS[key]


def chosen_stages() -> dict[tuple[int, int], int]:
    """The ring slabs of each (C, window rows) planned so far."""
    return {(key[0], plan[0]): plan[2] * plan[3] for key, plan in _PLANS.items()}


def stage_weights(resblocks, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The `nn.hifigan.ResBlock1` branches of one stage, in execution order
    (per branch, per dilation: dilated conv, second conv):

      w [n_taps, C, C]  tap j of a conv as the [C_in, C_out] matrix that
                        multiplies x[t + (j − (k−1)/2)·d]
      b [n_convs, C]
      kernel_sizes, dilation_sizes   the branches' static structure
    """
    taps, biases, kernel_sizes, dilation_sizes = [], [], [], []
    with torch.no_grad():
        for rb in resblocks:
            kernel_sizes.append(rb.convs1[0].kernel_size[0])
            dilation_sizes.append(tuple(c.dilation[0] for c in rb.convs1))
            for c1, c2 in zip(rb.convs1, rb.convs2):
                for conv in (c1, c2):
                    taps.append(conv.weight.permute(2, 1, 0))  # [k, C_in, C_out]
                    biases.append(conv.bias)
        w = torch.cat(taps).to(dtype).contiguous()
        b = torch.stack(biases).to(dtype).contiguous()
    if len({len(d) for d in dilation_sizes}) != 1:
        raise ValueError(f"branches must have equally many conv pairs, got {dilation_sizes}")
    return {"w": w, "b": b, "kernel_sizes": tuple(kernel_sizes), "dilation_sizes": tuple(dilation_sizes)}


def pack_stage_weights(resblocks, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Pack one stage for `mrf_stage`, once: `stage_weights`, and ``w_slabs``,
    w as `_frag.pack_slabs` lays it out for the kernel (None where C has no such
    layout)."""
    packed = stage_weights(resblocks, dtype)
    packed["w_slabs"] = _frag.pack_slabs(packed["w"])
    return packed


def lrelu_plain(x: torch.Tensor, slope: float, dt: torch.dtype) -> torch.Tensor:
    """Leaky ReLU on an f32 tensor of `dt` values as the `dt` graph computes
    it: the slope is a `dt` value and the product is rounded to `dt`."""
    s = torch.tensor(slope, dtype=dt).float()
    return torch.where(x >= 0, x, (x * s).to(dt).float())


def _conv_plain(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor, dilation: int) -> torch.Tensor:
    """'Same' conv of [B, T, C] f32 with taps [k, C_in, C_out], in f32."""
    k = taps.shape[0]
    y = F.conv1d(x.transpose(1, 2), taps.float().permute(2, 1, 0), bias.float(),
                 padding=(k - 1) // 2 * dilation, dilation=dilation)
    return y.transpose(1, 2)


def mrf_branches_plain(x0: torch.Tensor, mask: torch.Tensor, dt: torch.dtype, packed: dict) -> torch.Tensor:
    """The branch chains on f32 tensors of `dt` values: x0 [B, T, C] masked,
    mask [B, T, 1] → the f32 mean of the masked branch outputs, summed in the
    order (b0 + b1) + b2."""
    w, b = packed["w"], packed["b"]
    acc = torch.zeros_like(x0)
    tap = conv = 0
    for k, dils in zip(packed["kernel_sizes"], packed["dilation_sizes"]):
        xb = x0
        for d in dils:
            xt = lrelu_plain(xb, LRELU_SLOPE, dt) * mask
            y = _conv_plain(xt, w[tap : tap + k], b[conv], d)
            xt = lrelu_plain(y.to(dt).float(), LRELU_SLOPE, dt) * mask
            y2 = _conv_plain(xt, w[tap + k : tap + 2 * k], b[conv + 1], 1)
            xb = (xb + y2.to(dt).float()).to(dt).float()
            tap += 2 * k
            conv += 2
        acc = acc + xb * mask
    return acc / len(packed["kernel_sizes"])


def mrf_stage_plain(x: torch.Tensor, lengths: torch.Tensor, packed: dict) -> torch.Tensor:
    """`mrf_stage` in plain PyTorch, in x's dtype, with the kernel's rounding
    points; products in f32."""
    dt = x.dtype
    mask = _frag.length_mask(lengths, x.shape[1])
    return mrf_branches_plain(x.float() * mask, mask, dt, packed).to(dt)


def check_stage(packed: dict, c: int, dtype: torch.dtype) -> None:
    """The packed branches fit C channels and `dtype` (K3 and K4 share this)."""
    n_taps = sum(2 * k * len(d) for k, d in zip(packed["kernel_sizes"], packed["dilation_sizes"]))
    if packed["w"].shape != (n_taps, c, c) or any(k % 2 == 0 for k in packed["kernel_sizes"]):
        raise ValueError(f"packed weights {tuple(packed['w'].shape)} do not fit C = {c}")
    if packed["w"].dtype != dtype:
        raise TypeError(f"activations {dtype}, weights {packed['w'].dtype} must agree")


def check_stage_cuda(packed: dict, c: int, device: torch.device, weights: str, multiple: int):
    """What the kernels ask of the packed branches: the kernel's weight
    layout under the key `weights`, C a multiple of `multiple`.  Returns the
    ctypes arrays (kernel sizes, dilations) of the launch."""
    ks, dils = packed["kernel_sizes"], packed["dilation_sizes"]
    if len(ks) > MAX_BRANCHES or len(dils[0]) > MAX_PAIRS:
        raise ValueError(f"the kernel takes up to {MAX_BRANCHES} branches of {MAX_PAIRS} conv pairs")
    if packed.get(weights) is None or c % multiple:
        raise ValueError(f"the kernel needs C % {multiple} == 0, got C = {c}")
    for name in (weights, "b"):
        _frag.check_bf16(name, packed[name])
        if packed[name].device != device:
            raise ValueError(f"{name} on {packed[name].device}, activations on {device}")
    flat = [d for branch in dils for d in branch]
    return (ctypes.c_int * len(ks))(*ks), (ctypes.c_int * len(flat))(*flat)


def _library() -> ctypes.CDLL:
    lib = _nvcc.load("mrf")
    lib.mrf_stage_bf16.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 3
        + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.mrf_stage_bf16.restype = ctypes.c_int
    lib.mrf_stage_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.mrf_stage_smem_bytes.restype = ctypes.c_int
    lib.mrf_stage_attributes.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.mrf_stage_attributes.restype = ctypes.c_int
    return lib


def kernel_attributes(width: int) -> dict:
    """Registers a thread and local (stack and spilled) bytes of the kernel
    instance of a product width (cudaFuncGetAttributes)."""
    out = (ctypes.c_int * 2)()
    err = _library().mrf_stage_attributes(width, out)
    if err != 0:
        raise RuntimeError(f"no K3 instance of {width} columns ({err})")
    return {"registers": out[0], "spill_bytes": out[1]}


def mrf_stage(x: torch.Tensor, lengths: torch.Tensor, packed: dict) -> torch.Tensor:
    """x [B, T, C]; lengths [B] true sample counts at this stage's rate;
    packed from `pack_stage_weights` in x's dtype → the mean of the branches
    [B, T, C].  Samples past a row's length come out exactly 0."""
    if x.dim() != 3:
        raise ValueError(f"mrf_stage takes [B, T, C], got {tuple(x.shape)}")
    batch, t, c = x.shape
    check_stage(packed, c, x.dtype)
    if batch == 0 or t == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("mrf_stage takes a contiguous activation")
    if x.device.type == "cpu":
        return mrf_stage_plain(x, lengths, packed)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stage runs on cuda or cpu, not {x.device}")

    _frag.check_bf16("x", x)
    ks, dils = check_stage_cuda(packed, c, x.device, "w_slabs", TILE_M)
    if batch > _frag.GRID_MAX_Y:
        raise ValueError(f"batch {batch} exceeds the launch grid")
    lengths = _frag.check_lengths(lengths, batch, x.device)

    lib = _library()
    rows, tile, stages, group, _, plan = launch_plan(c, t, packed["kernel_sizes"], packed["dilation_sizes"])
    out = torch.empty_like(x)
    # where the finished branches' outputs wait for the last one, a tile a block
    scratch = torch.empty(batch * -(-t // tile) * (len(packed["kernel_sizes"]) - 1) * tile * c,
                          dtype=torch.bfloat16, device=x.device)
    err = lib.mrf_stage_bf16(
        x.data_ptr(), lengths.data_ptr(), packed["w_slabs"].data_ptr(), packed["b"].data_ptr(),
        out.data_ptr(), scratch.data_ptr(), batch, t, c,
        len(packed["kernel_sizes"]), len(packed["dilation_sizes"][0]), ks, dils,
        plan, rows, tile, stages, group, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mrf kernel launch failed with CUDA error {err}")
    count_launch(__name__)
    return out
