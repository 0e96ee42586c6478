"""HiFi-GAN generator (reference: models.py:224-298, modules.py:221-360;
JAX: ``openvoice_tpu/nn/hifigan.py``).

With ``x_mask`` a bucket-padded batch decodes exactly as the true-length
one: the reference decodes at the true length, where every conv sees zeros
past the end, and re-zeroing the padded positions after each conv (conv
biases break zero propagation) reproduces that.

`Generator` is the plain module of stock layers (the f32 parity mode).  The
serving mode (`apply_generator` with ``packed``) runs each stage's
multi-receptive-field block as one kernel, from weights packed once off the
module: ``ops/mrf_cuda.py`` behind a stock transposed convolution for the
stages whose upsample the JAX package leaves outside its kernel (0 and 1 of
the V2 config), ``ops/tail_cuda.py`` with the upsample, and on the last
stage conv_post and tanh, inside for the others (2 and 3).
"""

from __future__ import annotations

import copy
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from openvoice_tpu_torch.config import SynthesizerConfig
from openvoice_tpu_torch.nn.conv import conv1d, conv_transpose1d
from openvoice_tpu_torch.ops.mrf_cuda import mrf_stage, pack_stage_weights
from openvoice_tpu_torch.ops.tail_cuda import pack_tail_weights, tail_stage

LRELU_SLOPE = 0.1


def _masked(x: torch.Tensor, x_mask: torch.Tensor | None) -> torch.Tensor:
    return x if x_mask is None else x * x_mask


class ResBlock1(nn.Module):
    """3× (lrelu → dilated conv → lrelu → conv) with residual; attributes
    ``convs1.N`` / ``convs2.N`` as in the reference."""

    def __init__(self, channels: int, kernel_size: int, dilations: Sequence[int]):
        super().__init__()
        self.convs1 = nn.ModuleList(conv1d(channels, channels, kernel_size, dilation=d) for d in dilations)
        self.convs2 = nn.ModuleList(conv1d(channels, channels, kernel_size) for _ in dilations)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor | None = None) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = _masked(F.leaky_relu(x, LRELU_SLOPE), x_mask)
            xt = _masked(F.leaky_relu(c1(xt), LRELU_SLOPE), x_mask)
            x = c2(xt) + x
        return _masked(x, x_mask)


class ResBlock2(nn.Module):
    """2× (lrelu → dilated conv) with residual; attributes ``convs.N``."""

    def __init__(self, channels: int, kernel_size: int, dilations: Sequence[int]):
        super().__init__()
        self.convs = nn.ModuleList(conv1d(channels, channels, kernel_size, dilation=d) for d in dilations)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor | None = None) -> torch.Tensor:
        for c in self.convs:
            x = c(_masked(F.leaky_relu(x, LRELU_SLOPE), x_mask)) + x
        return _masked(x, x_mask)


class Generator(nn.Module):
    """conv_pre → speaker cond → per stage [lrelu → upsample → MRF mean] →
    lrelu(0.01) → conv_post → tanh.  Attributes follow the reference's
    state-dict keys: ``conv_pre``, ``ups.N``, ``resblocks.N``,
    ``conv_post``, ``cond``."""

    def __init__(self, cfg: SynthesizerConfig):
        super().__init__()
        ch = cfg.upsample_initial_channel
        self.upsample_rates = tuple(cfg.upsample_rates)
        self.num_kernels = len(cfg.resblock_kernel_sizes)
        block = ResBlock1 if cfg.resblock == "1" else ResBlock2
        self.conv_pre = conv1d(cfg.inter_channels, ch, 7)
        ups, resblocks = [], []
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            cout = ch // 2 ** (i + 1)
            ups.append(conv_transpose1d(ch // 2**i, cout, k, u))
            for k_rb, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                resblocks.append(block(cout, k_rb, dils))
        self.ups = nn.ModuleList(ups)
        self.resblocks = nn.ModuleList(resblocks)
        self.conv_post = conv1d(cout, 1, 7, bias=False)
        self.cond = conv1d(cfg.gin_channels, ch) if cfg.gin_channels else None

    def forward(self, x: torch.Tensor, g: torch.Tensor | None = None,
                x_mask: torch.Tensor | None = None) -> torch.Tensor:
        """x: [B, inter, T], g: [B, gin, 1], x_mask: [B, 1, T] →
        audio [B, 1, T·prod(upsample_rates)]."""
        x = self.conv_pre(x)
        if g is not None and self.cond is not None:
            x = x + self.cond(g)
        x = _masked(x, x_mask)
        for i, (up, u) in enumerate(zip(self.ups, self.upsample_rates)):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            if x_mask is not None:
                x_mask = torch.repeat_interleave(x_mask, u, dim=2)
                x = x * x_mask
            branches = self.resblocks[i * self.num_kernels : (i + 1) * self.num_kernels]
            acc = None
            for rb in branches:
                y = rb(x, x_mask)
                acc = y if acc is None else acc + y
            x = acc / self.num_kernels
        # the final activation uses torch's default slope 0.01 (models.py:287)
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x)


def _stage_plan(gen: Generator, i: int) -> dict | None:
    """Which kernel serves stage i; both `pack_generator_caches` and the
    serving branch of `apply_generator` ask here, so the cache keys cannot
    drift from the dispatch.

    The split is the JAX package's (its ``nn/hifigan.py::_stage_plan``), so
    both packages cut the decoder alike: a stage whose upsample it fuses goes
    whole to the tail kernel ("tail" when it is the last stage, else
    "upmrf"), a stage of ResBlock1 branches whose channel count it tiles goes
    to the MRF kernel behind a stock transposed convolution ("mrf"), and any
    other stage stays on stock layers (None).
    """
    if not isinstance(gen.resblocks[0], ResBlock1):
        return None
    up = gen.ups[i]
    c_in, c_out, u, k_up = up.in_channels, up.out_channels, up.stride[0], up.kernel_size[0]
    is_last = i == len(gen.ups) - 1
    per_tile = 128 // c_out if c_out and 128 % c_out == 0 else 0
    if (per_tile and per_tile % u == 0 and (per_tile // u) * c_in == 128
            and k_up - u - 2 * up.padding[0] == 0):
        return {"kind": "tail" if is_last else "upmrf", "key": "tail" if is_last else f"upmrf{i}"}
    if c_out >= 128 or per_tile:
        return {"kind": "mrf", "key": f"mrf{i}"}
    return None


def cast_copy(module: nn.Module | None, dtype: torch.dtype) -> nn.Module | None:
    """A frozen copy of a stock layer in `dtype` (None stays None): what the
    serving mode keeps of the layers that stay outside its kernels."""
    return copy.deepcopy(module).to(dtype).requires_grad_(False) if module is not None else None


def _stage_resblocks(gen: Generator, i: int) -> list:
    return list(gen.resblocks[i * gen.num_kernels : (i + 1) * gen.num_kernels])


def pack_generator_caches(gen: Generator, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Pack, once, what the serving branch of `apply_generator` reads:
    ``{"mrf{i}" | "upmrf{i}" | "tail": packed stage}`` for every stage a
    kernel serves, and under ``"stock"`` copies in `dtype` of the stock layers
    that stay around the kernels (conv_pre, cond, the upsample of an "mrf"
    stage; for a stage without a kernel its upsample and branches, and
    conv_post unless the tail kernel holds it)."""
    def cast(module):
        return cast_copy(module, dtype)

    caches: dict = {}
    stock: dict = {"conv_pre": cast(gen.conv_pre), "cond": cast(gen.cond)}
    plan = None
    for i in range(len(gen.ups)):
        plan = _stage_plan(gen, i)
        if plan is None:
            stock[f"ups{i}"] = cast(gen.ups[i])
            stock[f"resblocks{i}"] = cast(nn.ModuleList(_stage_resblocks(gen, i)))
        elif plan["kind"] == "mrf":
            stock[f"ups{i}"] = cast(gen.ups[i])
            caches[plan["key"]] = pack_stage_weights(_stage_resblocks(gen, i), dtype)
        else:
            caches[plan["key"]] = pack_tail_weights(
                gen.ups[i], _stage_resblocks(gen, i),
                gen.conv_post if plan["kind"] == "tail" else None, dtype)
    if plan is None or plan["kind"] != "tail":
        stock["conv_post"] = cast(gen.conv_post)
    caches["stock"] = stock
    return caches


def _generator_packed(gen: Generator, x: torch.Tensor, g: torch.Tensor | None,
                      x_mask: torch.Tensor | None, packed: dict) -> torch.Tensor:
    """The serving branch, in the JAX layout throughout: x [B, T, inter] in
    the packed weights' dtype → audio [B, T·upsample, 1]."""
    stock = packed["stock"]

    def run(layer, a):  # a stock [B, C, T] layer on a [B, T, C] tensor
        return layer(a.transpose(1, 2)).transpose(1, 2)

    x = run(stock["conv_pre"], x)
    if g is not None and stock["cond"] is not None:
        x = x + run(stock["cond"], g)
    if x_mask is not None:
        x = x * x_mask
    # the kernels rebuild their masks from true lengths, so the true frame
    # count is taken once at frame rate and multiplied per stage; a mask tensor
    # at audio rate is built only while a stage without a kernel lies ahead
    cur_len = (x_mask[:, :, 0] != 0).sum(dim=1, dtype=torch.int32) if x_mask is not None else None
    plans = [_stage_plan(gen, i) for i in range(len(gen.ups))]
    for i, u in enumerate(gen.upsample_rates):
        plan = plans[i]
        mask_needed = any(p is None for p in plans[i:])
        if cur_len is not None:
            cur_len = cur_len * u
        lengths = cur_len if cur_len is not None else torch.full(
            (x.shape[0],), x.shape[1] * u, dtype=torch.int32, device=x.device)
        if plan is not None and plan["kind"] in ("tail", "upmrf"):
            x = tail_stage(x.contiguous(), lengths, packed[plan["key"]])
            if plan["kind"] == "tail":
                return x
            if x_mask is not None and mask_needed:
                x_mask = torch.repeat_interleave(x_mask, u, dim=1)
            continue
        x = run(stock[f"ups{i}"], F.leaky_relu(x, LRELU_SLOPE))
        if x_mask is not None and (mask_needed or plan is None):
            x_mask = torch.repeat_interleave(x_mask, u, dim=1)
            x = x * x_mask
        elif x_mask is not None:
            # no mask at audio rate: the kernel zeroes what the upsample
            # spilled past the true length
            x_mask = None
        if plan is not None:
            x = mrf_stage(x.contiguous(), lengths, packed[plan["key"]])
            continue
        m_t = x_mask.transpose(1, 2) if x_mask is not None else None
        acc = None
        for rb in stock[f"resblocks{i}"]:
            y = rb(x.transpose(1, 2), m_t)
            acc = y if acc is None else acc + y
        x = (acc / gen.num_kernels).transpose(1, 2)
    x = run(stock["conv_post"], F.leaky_relu(x, 0.01))
    return torch.tanh(x)


def apply_generator(gen: Generator, x: torch.Tensor, g: torch.Tensor | None = None,
                    x_mask: torch.Tensor | None = None, packed: dict | None = None) -> torch.Tensor:
    """The JAX layout: x [B, T, inter], g [B, 1, gin], x_mask [B, T, 1] →
    audio [B, T·upsample, 1].  With `packed` (`pack_generator_caches`, in
    x's dtype) the stages run as kernels: the serving mode."""
    if packed is not None:
        return _generator_packed(gen, x, g, x_mask, packed)
    g_t = g.transpose(1, 2) if g is not None else None
    m_t = x_mask.transpose(1, 2) if x_mask is not None else None
    return gen(x.transpose(1, 2), g_t, m_t).transpose(1, 2)
