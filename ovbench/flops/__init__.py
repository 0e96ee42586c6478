"""Operations and bytes of the benchmark's work, from shapes alone.

Counts are of the work a request needs at its true frame and token counts,
whatever implements it: padding to a bucket or a batch adds time, not work.
A multiply-add is 2 operations; elementwise work (activations, masks,
noise) is not counted.  ``cfg`` is a ``reference.model.Config``.

* `k1` … `k5`: each hand-written kernel's (operations, bytes) for one
  request, as the kernel table of the port counts them (K1 the posterior
  encoder's WaveNet, K2 one direction of the coupling flow, K3 decoder
  stages 0–1, K4 decoder stages 2–3 with conv_post, K5 the STFT); a kernel's
  bytes are its inputs read once, its outputs written once and its weights
  once, at 2 bytes a value (bf16; K5 4, f32).
* `converter`, `tts_encode`, `tts_decode`: every convolution and matrix
  product of one request's forward pass (the numerator of ``mfu``).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

TAPS_PER_BRANCH = 2  # ResBlock1: convs1 and convs2, per dilation


def peaks(device_name: str) -> dict | None:
    """The published peaks of the card named `device_name` (``peaks.json``):
    {"bf16", "fp32", "bytes"} per second, or None for a card not listed."""
    table = json.loads((Path(__file__).with_name("peaks.json")).read_text())
    for entry in table["cards"]:
        if all(word in device_name for word in entry["name_has"]) and not any(
                word in device_name for word in entry.get("name_lacks", [])):
            return entry
    return None


def _taps(cfg) -> int:
    """[C, C] taps of one MRF stage: Σ over branches of 2·k·len(dilations)."""
    return sum(TAPS_PER_BRANCH * k * len(d) for k, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes))


def _mrf_biases(cfg, c: int) -> int:
    return sum(TAPS_PER_BRANCH * len(d) for d in cfg.resblock_dilation_sizes) * c


def wn_flop(frames: int, n_layers: int, k: int, h: int) -> float:
    """L layers of a K-tap H→2H conv and an H→2H 1×1 (H→H on the last)."""
    return 2.0 * frames * (n_layers * (k + 1) * h * 2 * h - h * h)


def wn_weights(n_layers: int, k: int, h: int) -> int:
    return n_layers * (k * h * 2 * h + 2 * h) + (n_layers - 1) * (h * 2 * h + 2 * h) + h * h + h


def k1(cfg, frames: int) -> tuple[float, float]:
    h, n = cfg.hidden_channels, cfg.enc_q_layers
    flop = wn_flop(frames, n, cfg.enc_q_kernel_size, h)
    nbytes = 2 * (2 * frames * h + n * 2 * h + wn_weights(n, cfg.enc_q_kernel_size, h))
    return flop, nbytes


def k2(cfg, frames: int) -> tuple[float, float]:
    """One direction of the flow: each coupling's pre C/2→H, WaveNet and
    post H→C/2."""
    c, h, n, k, s = cfg.inter_channels, cfg.hidden_channels, cfg.flow_wn_layers, cfg.flow_kernel_size, cfg.flow_n_flows
    flop = s * (wn_flop(frames, n, k, h) + 2.0 * frames * 2 * (c // 2) * h)
    weights = s * ((c // 2) * h + h + wn_weights(n, k, h) + h * (c // 2) + c // 2)
    return flop, 2 * (2 * frames * c + s * n * 2 * h + weights)


def _stage_channels(cfg) -> list[tuple[int, int, int, int]]:
    """Each decoder stage's (c_in, c, rate, kernel)."""
    ch = cfg.upsample_initial_channel
    return [(ch // 2 ** i, ch // 2 ** (i + 1), u, k)
            for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes))]


def k3(cfg, frames: int) -> tuple[float, float]:
    """The MRF blocks of decoder stages 0 and 1 (their upsamples run
    outside the kernel)."""
    flop = nbytes = 0.0
    t = frames
    for i, (_, c, u, _) in enumerate(_stage_channels(cfg)[:2]):
        t *= u
        flop += 2.0 * t * _taps(cfg) * c * c
        nbytes += 2 * (2 * t * c + _taps(cfg) * c * c + _mrf_biases(cfg, c))
    return flop, nbytes


def k4(cfg, frames: int) -> tuple[float, float]:
    """Decoder stages 2 and 3: upsample and MRF, and on the last conv_post
    (7 taps to one channel)."""
    stages = _stage_channels(cfg)
    t = frames * math.prod(cfg.upsample_rates[:2])
    flop = nbytes = 0.0
    for i, (c_in, c, u, k_up) in enumerate(stages[2:]):
        last = i == len(stages) - 3
        n = t * u
        flop += 2.0 * n * (_taps(cfg) * c * c + (k_up // u) * c_in * c + (7 * c if last else 0))
        weights = _taps(cfg) * c * c + _mrf_biases(cfg, c) + k_up * c_in * c + c + (7 * c if last else 0)
        nbytes += 2 * (t * c_in + n * (1 if last else c) + weights)
        t = n
    return flop, nbytes


def k5(cfg, frames: int) -> tuple[float, float]:
    """The STFT of `frames` frames: a real FFT a frame (2.5·N·log2 N) and the
    magnitudes; the padded audio in, the bins out and the window, in f32."""
    n_fft, n_freq = cfg.filter_length, cfg.filter_length // 2 + 1
    length = (frames - 1) * cfg.hop_length + n_fft
    flop = frames * (2.5 * n_fft * math.log2(n_fft) + 5 * n_freq)
    return flop, 4 * (length + frames * n_freq + n_fft)


def _conv(t: int, c_in: int, c_out: int, k: int = 1) -> float:
    return 2.0 * t * c_in * c_out * k


def decoder(cfg, frames: int) -> float:
    """conv_pre, the speaker conditioning, each upsample and MRF, conv_post."""
    flop = _conv(frames, cfg.inter_channels, cfg.upsample_initial_channel, 7)
    flop += _conv(1, cfg.gin_channels, cfg.upsample_initial_channel)
    t = frames
    for c_in, c, u, k_up in _stage_channels(cfg):
        flop += _conv(t, c_in, c, k_up)      # a transposed conv: K outputs an input sample
        t *= u
        flop += 2.0 * t * _taps(cfg) * c * c
    return flop + _conv(t, _stage_channels(cfg)[-1][1], 1, 7)


def flow(cfg, frames: int) -> float:
    """One direction of the coupling flow, with its conditioning."""
    h = cfg.hidden_channels
    cond = cfg.flow_n_flows * _conv(1, cfg.gin_channels, 2 * h * cfg.flow_wn_layers)
    return k2(cfg, frames)[0] + cond


def converter(cfg, frames: int) -> float:
    """One conversion of `frames` frames: STFT, posterior encoder, the flow
    both ways, the decoder."""
    h = cfg.hidden_channels
    enc = (_conv(frames, cfg.spec_channels, h) + k1(cfg, frames)[0]
           + _conv(1, cfg.gin_channels, 2 * h * cfg.enc_q_layers) + _conv(frames, h, 2 * cfg.inter_channels))
    return k5(cfg, frames)[0] + enc + 2 * flow(cfg, frames) + decoder(cfg, frames)


def _dds(t: int, c: int, k: int, n_layers: int = 3) -> float:
    return n_layers * (_conv(t, 1, c, k) + _conv(t, c, c))


def tts_encode(cfg, tokens: int) -> float:
    """The text encoder (relative attention, FFN), the stochastic duration
    predictor in reverse and the deterministic one, for one sentence."""
    t, h, f, k, w = tokens, cfg.hidden_channels, cfg.filter_channels, cfg.kernel_size, cfg.attn_window_size
    layer = 4 * _conv(t, h, h) + 2 * 2.0 * t * t * h + 2 * 2.0 * t * (2 * w + 1) * h
    layer += _conv(t, h, f, k) + _conv(t, f, h, k)
    enc = cfg.n_layers * layer + _conv(t, h, 2 * cfg.inter_channels)
    bins = 10
    sdp = _conv(t, h, h) + _conv(1, cfg.gin_channels, h) + _dds(t, h, cfg.sdp_kernel_size) + _conv(t, h, h)
    sdp += 3 * (_conv(t, 1, h) + _dds(t, h, cfg.sdp_kernel_size) + _conv(t, h, 3 * bins - 1))
    df = cfg.dp_filter_channels
    dp = (_conv(1, cfg.gin_channels, h) + _conv(t, h, df, cfg.dp_kernel_size)
          + _conv(t, df, df, cfg.dp_kernel_size) + _conv(t, df, 1))
    return enc + sdp + dp


def tts_decode(cfg, tokens: int, frames: int) -> float:
    """Length regulation (the alignment's products), the flow in reverse and
    the decoder, for one sentence."""
    return 2 * 2.0 * frames * tokens * cfg.inter_channels + flow(cfg, frames) + decoder(cfg, frames)


# -- a request's work ---------------------------------------------------------------
# ``work`` (a driver's): {"convert": [frames of each conversion],
#                         "tts": [(tokens, frames) of each sentence decoded]};
# ``cfgs``: {"convert": Config, "tts": Config}.

def request_flops(cfgs: dict, work: dict) -> float:
    """Every product of one request's forward passes."""
    flop = sum(converter(cfgs["convert"], f) for f in work.get("convert", []))
    return flop + sum(tts_encode(cfgs["tts"], t) + tts_decode(cfgs["tts"], t, f) for t, f in work.get("tts", []))


def request_kernels(cfgs: dict, work: dict) -> dict[str, tuple[float, float]]:
    """(operations, bytes) of each hand-written kernel's share of one
    request, by the kernel's wrapper module: a conversion runs K5, K1, K2
    both ways, K3 and K4; a TTS decode K2 in reverse, K3 and K4."""
    out: dict[str, list[float]] = {m: [0.0, 0.0] for m in ("stft_cuda", "wn_cuda", "coupling_cuda", "mrf_cuda",
                                                             "tail_cuda")}

    def add(module, fb, times=1):
        out[module][0] += times * fb[0]
        out[module][1] += times * fb[1]

    for f in work.get("convert", []):
        c = cfgs["convert"]
        add("stft_cuda", k5(c, f))
        add("wn_cuda", k1(c, f))
        add("coupling_cuda", k2(c, f), 2)
        add("mrf_cuda", k3(c, f))
        add("tail_cuda", k4(c, f))
    for _, f in work.get("tts", []):
        c = cfgs["tts"]
        add("coupling_cuda", k2(c, f))
        add("mrf_cuda", k3(c, f))
        add("tail_cuda", k4(c, f))
    return {m: (v[0], v[1]) for m, v in out.items()}


def bound_s(module: str, flop: float, nbytes: float, peak: dict) -> float:
    """The least time the card could take: operations at the precision's
    peak (K5 float32, the others bfloat16) or bytes at its memory rate."""
    rate = peak["fp32"] if module == "stft_cuda" else peak["bf16"]
    return max(flop / rate, nbytes / peak["bytes"])
