"""K4: a decoder stage with its upsample as one hand-written CUDA kernel
(``csrc/tail.cu``).

Replaces ``openvoice_tpu/ops/mrf_pallas.py::fused_tail_stage``: leaky ReLU →
ConvTranspose1d → mask → the MRF stage of K3, and on the last stage leaky
ReLU 0.01 → conv_post → tanh, which gives the audio.  Each MRF conv runs on
the window rows `tail_chunks` gives, and a tile wholly past the true length
(`live_tiles`) writes its zeros and returns.  A CUDA tensor goes to the kernel, a CPU tensor
to `tail_stage_plain`; nothing falls back.

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
    LRELU_SLOPE, check_stage, check_stage_cuda, conv_chunks, lrelu_plain, mrf_branches_plain, stage_halo,
    stage_weights,
)

launches = 0

POST_SLOPE = 0.01   # the last activation uses torch's default slope
# the launch's knobs (``python3 chip_smoke.py --sweep tail`` times them):
# threads a block (a multiple of 32 up to 512, the kernel's launch bound,
# which leaves a thread 128 registers), and the samples a block keeps (the
# window grows to it, or to what shared memory holds)
_THREADS = 512
_TILE_TARGET = 328
# what the last launch ran: window rows and tile, halo, threads, tiles in the
# grid, shared memory a block
last_launch: dict = {}
_PLANS: dict[tuple, tuple] = {}


def pack_tail_weights(up, resblocks, conv_post=None, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Pack one stage for `tail_stage`, once: the stage's `ConvTranspose1d`
    `up`, its ResBlock1 branches, and on the last stage `conv_post`.

      up_w [k_up, C_in, C_out]  tap j is the transposed conv's W[:, :, j]
      up_b [C_out], stride, pad_up
      post_w [k_post, C_out] or None
      and the keys of `mrf_cuda.stage_weights`; ``w_frag`` and ``up_w_frag``
      are w and up_w in the kernel's fragment order (None where the sizes
      have no such layout).
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
    packed["w_frag"] = _frag.maybe_frag(packed["w"])
    packed["up_w_frag"] = _frag.maybe_frag(packed["up_w"])
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
    reach = 0
    for f in range(stride):
        j0, ds0 = (f + pad_up) % stride, (f + pad_up) // stride
        n_taps = (k_up - j0 + stride - 1) // stride
        reach = max(reach, abs(ds0), abs(ds0 - (n_taps - 1)))
    return reach


def tail_halo(kernel_sizes, dilation_sizes, k_post: int, stride: int) -> int:
    """Recomputed rows a side of a window: the branches' reach, plus
    conv_post's on the last stage (k_post > 0), kept a multiple of the
    stride so that windows start on an input sample."""
    halo = stage_halo(kernel_sizes, dilation_sizes) + max(k_post - 1, 0) // 2
    return -(-halo // stride) * stride


def tail_chunks(kernel_sizes, dilation_sizes, halo: int, tile: int, rows: int,
                post_half: int) -> list[tuple[int, int]]:
    """The 16-row chunks (first, count) each MRF conv computes, in execution
    order: `mrf_cuda.conv_chunks` of the kept rows, which on the last stage
    reach `post_half` rows past the tile a side because conv_post reads them."""
    return conv_chunks(kernel_sizes, dilation_sizes, halo - post_half, tile + 2 * post_half, rows)


def live_tiles(len_out: int, tile: int, post_half: int, t_out: int) -> int:
    """How many of a row's tiles the kernel computes: tile i (first sample
    t0 = i·tile) returns at once, with its output all zero, when
    t0 − post_half ≥ len_out; the tiles before it compute."""
    return min(-(-(min(len_out, t_out) + post_half) // tile), -(-t_out // tile))


def launch_plan(cin: int, c: int, t_out: int, stride: int, margin: int, k_post: int,
                kernel_sizes, dilation_sizes) -> tuple:
    """(rows, tile, halo, chunks, smem bytes) of a launch: the largest window (up to
    `_TILE_TARGET` kept rows, rows a multiple of 32·stride, which the
    upsample's phases need) that fits one block's shared memory, and
    `tail_chunks` of it as the kernel's ctypes array.  Computed once per
    sizes and knobs."""
    key = (cin, c, min(_TILE_TARGET, max(t_out, 1)), stride, margin, k_post, kernel_sizes, dilation_sizes,
           _TILE_TARGET)
    if key not in _PLANS:
        lib = _library()
        halo = tail_halo(kernel_sizes, dilation_sizes, k_post, stride)
        n_convs = 2 * sum(len(d) for d in dilation_sizes)
        rows, tile = _frag.window(
            ("tail", cin, c, stride, margin, n_convs), halo, t_out, _TILE_TARGET,
            lambda r, tl: lib.tail_stage_smem_bytes(cin, c, stride, margin, r, n_convs),
            multiples=(_frag.TILE_ROWS * stride,))
        chunks = [v for rng in tail_chunks(kernel_sizes, dilation_sizes, halo, tile, rows,
                                           max(k_post - 1, 0) // 2) for v in rng]
        smem = lib.tail_stage_smem_bytes(cin, c, stride, margin, rows, n_convs)
        _PLANS[key] = (rows, tile, halo, (ctypes.c_int * len(chunks))(*chunks), smem)
    return _PLANS[key]


def _library() -> ctypes.CDLL:
    lib = _nvcc.load("tail")
    lib.tail_stage_bf16.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [ctypes.POINTER(ctypes.c_int)] * 3
        + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.tail_stage_bf16.restype = ctypes.c_int
    lib.tail_stage_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.tail_stage_smem_bytes.restype = ctypes.c_int
    lib.tail_stage_attributes.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3
    lib.tail_stage_attributes.restype = ctypes.c_int
    return lib


def kernel_attributes(smem: int, device: int = 0) -> dict:
    """What the kernel takes on the card: registers and spilled bytes a
    thread (cudaFuncGetAttributes), and how many blocks of `_THREADS` threads
    and `smem` bytes an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    regs, local, blocks = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    err = _library().tail_stage_attributes(_THREADS, smem, device, ctypes.byref(regs), ctypes.byref(local),
                                           ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"tail kernel attributes failed with error {err} ({_THREADS} threads)")
    return {"registers": regs.value, "spill_bytes": local.value, "blocks_per_sm": blocks.value}


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
    ks, dils = check_stage_cuda(packed, c, x.device, "w_frag", 16)
    if packed["up_w_frag"] is None or cin % 16:
        raise ValueError(f"the kernel needs C_in % 16 == 0, got C_in = {cin}")
    for name in ("up_w_frag", "up_b") + (("post_w",) if post_w is not None else ()):
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
    rows, tile, halo, chunks, smem = launch_plan(cin, c, t_out, stride, margin, k_post, packed["kernel_sizes"],
                                                 packed["dilation_sizes"])
    out = torch.empty((batch, t_out, 1 if post_w is not None else c), dtype=x.dtype, device=x.device)
    # where the finished branches' outputs wait for the last one: a tile (and
    # conv_post's reach) a block
    scratch = torch.empty(batch * -(-t_out // tile) * (len(packed["kernel_sizes"]) - 1)
                          * (tile + max(k_post - 1, 0)) * c, dtype=torch.bfloat16, device=x.device)
    device = x.device.index or 0
    err = lib.tail_stage_bf16(
        x.data_ptr(), lengths.data_ptr(), packed["up_w_frag"].data_ptr(), packed["up_b"].data_ptr(),
        packed["w_frag"].data_ptr(), packed["b"].data_ptr(),
        post_w.data_ptr() if post_w is not None else None, out.data_ptr(), scratch.data_ptr(),
        batch, t_in, cin, c, stride, k_up, pad_up, margin, k_post,
        len(packed["kernel_sizes"]), len(packed["dilation_sizes"][0]), ks, dils, chunks,
        rows, tile, _THREADS, device, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"tail kernel launch failed with error {err} (CUDA's, or -1: a launch the kernel "
                           f"cannot take, {_THREADS} threads)")
    count_launch(__name__)
    last_launch.update(rows=rows, tile=tile, halo=halo, threads=_THREADS, tiles=-(-t_out // tile), smem=smem)
    return out
