"""K4: a decoder stage with its upsample as one hand-written CUDA kernel
(``csrc/tail.cu``).

Replaces ``openvoice_tpu/ops/mrf_pallas.py::fused_tail_stage``: leaky ReLU →
ConvTranspose1d → mask → the MRF stage of K3, and on the last stage leaky
ReLU 0.01 → conv_post → tanh, which gives the audio.  A CUDA tensor goes to
the kernel, a CPU tensor to `tail_stage_plain`; nothing falls back.

``launches`` counts the kernel's launches; it is raised where the kernel is
launched and nowhere else.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from openvoice_tpu_torch.ops import _frag, _nvcc
from openvoice_tpu_torch.ops.mrf_cuda import (
    LRELU_SLOPE, check_stage, check_stage_cuda, lrelu_plain, mrf_branches_plain, pack_stage_weights,
    stage_halo,
)

launches = 0

POST_SLOPE = 0.01   # the last activation uses torch's default slope
_THREADS = 512       # 16 warps, as K3: more warps hide more of the latency it waits on
_TILE_TARGET = 4096  # as many samples as shared memory holds (see mrf_cuda)


def pack_tail_weights(up, resblocks, conv_post=None, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Pack one stage for `tail_stage`, once: the stage's `ConvTranspose1d`
    `up`, its ResBlock1 branches, and on the last stage `conv_post`.

      up_w [k_up, C_in, C_out]  tap j is the transposed conv's W[:, :, j]
      up_b [C_out], stride, pad_up
      post_w [k_post, C_out] or None
      and the keys of `mrf_cuda.pack_stage_weights`; ``up_w_frag`` is up_w in
      the kernel's fragment order (None where the sizes have no such layout).
    """
    k_up, stride, pad_up = up.kernel_size[0], up.stride[0], up.padding[0]
    if k_up - stride - 2 * pad_up != 0 or up.output_padding[0] != 0 or up.dilation[0] != 1:
        raise ValueError(f"the fused stage needs T_out = T_in·stride: kernel {k_up}, stride {stride}, "
                         f"padding {pad_up}")
    packed = pack_stage_weights(resblocks, dtype)
    with torch.no_grad():
        packed["up_w"] = up.weight.permute(2, 0, 1).to(dtype).contiguous()
        packed["up_b"] = up.bias.to(dtype).contiguous()
        packed["post_w"] = None
        if conv_post is not None:
            if conv_post.bias is not None or conv_post.out_channels != 1:
                raise ValueError("conv_post must have one output channel and no bias")
            packed["post_w"] = conv_post.weight[0].t().to(dtype).contiguous()  # [k_post, C]
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


def _library() -> ctypes.CDLL:
    lib = _nvcc.load("tail")
    lib.tail_stage_bf16.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [ctypes.POINTER(ctypes.c_int)] * 2
        + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.tail_stage_bf16.restype = ctypes.c_int
    lib.tail_stage_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.tail_stage_smem_bytes.restype = ctypes.c_int
    return lib


def tail_stage(x: torch.Tensor, lengths: torch.Tensor, packed: dict) -> torch.Tensor:
    """x [B, T_in, C_in], the input of an upsample stage; lengths [B] true
    OUTPUT sample counts (input lengths · stride); packed from
    `pack_tail_weights` in x's dtype.  With ``post_w`` (the last stage)
    returns the audio [B, T_in·stride, 1]; without, the stage's activations
    [B, T_in·stride, C_out].  Activations past a row's length come out exactly
    0; the audio does from conv_post's reach past it (no mask follows conv_post,
    as in the Pallas kernel)."""
    global launches
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
    ks, dils = check_stage_cuda(packed, c, x.device)
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
    # the branches' reach, plus conv_post's on the last stage, kept a multiple
    # of the stride so that windows start on an input sample
    halo = stage_halo(packed["kernel_sizes"], packed["dilation_sizes"]) + max(k_post - 1, 0) // 2
    halo = -(-halo // stride) * stride
    rows, tile = _frag.window(
        ("tail", cin, c, stride, margin), halo, t_in * stride, _TILE_TARGET,
        lambda r, tl: lib.tail_stage_smem_bytes(cin, c, stride, margin, r),
        multiples=(math.lcm(_frag.even_rows(c, _THREADS), _frag.TILE_ROWS * stride), _frag.TILE_ROWS * stride))
    t_out = t_in * stride
    out = torch.empty((batch, t_out, 1 if post_w is not None else c), dtype=x.dtype, device=x.device)
    # where the finished branches' outputs wait for the last one: a tile (and
    # conv_post's reach) a block
    scratch = torch.empty(batch * -(-t_out // tile) * (len(packed["kernel_sizes"]) - 1)
                          * (tile + max(k_post - 1, 0)) * c, dtype=torch.bfloat16, device=x.device)
    err = lib.tail_stage_bf16(
        x.data_ptr(), lengths.data_ptr(), packed["up_w_frag"].data_ptr(), packed["up_b"].data_ptr(),
        packed["w_frag"].data_ptr(), packed["b"].data_ptr(),
        post_w.data_ptr() if post_w is not None else None, out.data_ptr(), scratch.data_ptr(),
        batch, t_in, cin, c, stride, k_up, pad_up, margin, k_post,
        len(packed["kernel_sizes"]), len(packed["dilation_sizes"][0]), ks, dils,
        rows, tile, _THREADS, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"tail kernel launch failed with CUDA error {err}")
    launches += 1
    return out
