"""Train steps for the tone-colour converter stack (the port of
``openvoice_tpu/training/train.py``).

One step: posterior encode → flow → random-slice decode (VITS segment
slicing bounds the decoder's cost) → mel L1 + prior KL → AdamW update, and
for the adversarial recipe a discriminator update before the generator's.
The JAX package trains on stock XLA ops (no Pallas kernel has a backward
pass), and so does the port: the f32 ``nn.Module``s of ``models/`` under
``torch.autograd``, with TF32 off on the card.  The mel of the loss is the
windowed DFT-basis product, which is differentiable; the STFT kernel has no
backward pass and is not used here.

Randomness (the posterior noise and the uniform draws of the slice starts)
comes from an explicit ``torch.Generator`` on the CPU, or is passed in as
`noise` and `u` (or the starts themselves), so that tests can feed both
packages the same draws.

On one device each step is one CUDA graph per (batch, frames,
segment_frames) on the card, as the JAX package jits each step with its
state donated (``openvoice_tpu/training/train.py:181``, ``:252``): the
state's `GraphCache` (``state.graphs``, `runtime/graphs.py`) captures the
step at its first call of a shape (that call is the step's eager warm-up)
and replays it after.  The draws stay on the host, in the eager order; the
body computes the starts from the staged `u` and the lengths; the
parameters, the moments and the optimizer's step counts update in place,
and the metrics are the graph's outputs.  On the card the optimizer is
capturable, its learning rate a device tensor each step writes, for the
eager and the graph route alike.  ``state.graphs.enabled = False`` runs the
steps eagerly; so do the CPU and a data-parallel step.

Data parallel (``mesh=``, one process per data position, the batch from
``training.data.make_global_batch``): every process draws the global batch's
noise and starts from the same generator state and keeps its own rows; the
KL term is weighted by the process's share of the global mask count; the
generator's and the discriminator's gradients, and the reported metrics,
are averaged over the data axis with one all-reduce each.  A step on the
data ranks so equals the single-process step on the concatenated batch, up
to the order of the sums.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from openvoice_tpu_torch.api import resolve_device
from openvoice_tpu_torch.audio.mel import mel_filterbank
from openvoice_tpu_torch.audio.stft import stft_basis
from openvoice_tpu_torch.config import SynthesizerConfig
from openvoice_tpu_torch.models import synthesizer as S
from openvoice_tpu_torch.models.align import sequence_mask
from openvoice_tpu_torch.nn.flows import apply_coupling_block
from openvoice_tpu_torch.runtime.graphs import GraphCache, GraphKey
from openvoice_tpu_torch.runtime.mesh import Comm, Mesh, Sharded, comms, upload
from openvoice_tpu_torch.training import losses as L
from openvoice_tpu_torch.training.discriminator import Discriminators, init_discriminators


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


@dataclass
class TrainState:
    """A model, its optimizer, the count of steps taken and the graphs of
    `train_step` (on the model's device).  The steps update the model and
    the optimizer in place and return the same state."""

    model: nn.Module
    opt: torch.optim.Optimizer
    step: int = 0
    graphs: GraphCache | None = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.graphs is None:
            self.graphs = GraphCache(_device_of(self.model))


@dataclass
class GanTrainState:
    """The converter's and the discriminators' states, and the graphs of
    `gan_train_step` (which read both).  It unpacks as its two states, as
    the JAX package's ``GanTrainState`` does."""

    gen: TrainState
    disc: TrainState
    graphs: GraphCache | None = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.graphs is None:
            self.graphs = GraphCache(_device_of(self.gen.model))

    def __iter__(self):
        return iter((self.gen, self.disc))


# the metrics each step returns, in the order its graph returns them
TRAIN_METRICS = ("mel", "kl", "total")
GAN_METRICS = ("mel", "kl", "adv", "fm", "gen_total", "disc")


def make_optimizer(params, lr: float = 2e-4, b1: float = 0.8, b2: float = 0.99) -> torch.optim.AdamW:
    """AdamW with the HiFi-GAN/VITS betas: optax ``adamw``'s algebra
    (bias-corrected moments, eps 1e-8 outside the root, weight decay 0.01
    decoupled and applied to the old parameter).

    AdamW skips a parameter whose ``.grad`` is None, where optax decays
    every leaf: the steps hand it zeros instead (`grads_of`).  On the card
    it is capturable (foreach), with the learning rate a 0-d tensor on the
    device that every step writes in place: a CUDA graph of a step then
    reads the step's rate, where a float would be frozen into it."""
    params = list(params)
    if params and params[0].is_cuda:
        lr = torch.tensor(lr, dtype=params[0].dtype, device=params[0].device)
        return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=1e-8, weight_decay=0.01, foreach=True,
                                 capturable=True)
    return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=1e-8, weight_decay=0.01)


def _match_device(state: TrainState) -> bool:
    """An optimizer as `make_optimizer` makes it for the parameters'
    device, again.  `load_state_dict` (a checkpoint's resume) brings the
    saved param groups: their learning rate as the file held it (a host
    tensor after a load) and their capturable flag.  Returns whether
    anything changed (a graph captured before reads the old tensors)."""
    params = [p for group in state.opt.param_groups for p in group["params"]]
    dev = params[0].device
    card = dev.type == "cuda"
    changed = False
    for group in state.opt.param_groups:
        lr = group["lr"]
        if group.get("capturable") == card and (lr.device == dev if card and torch.is_tensor(lr)
                                                else not card and not torch.is_tensor(lr)):
            continue
        group["capturable"] = card
        group["lr"] = torch.tensor(float(lr), dtype=params[0].dtype, device=dev) if card else float(lr)
        changed = True
    if changed and card:
        for p in params:
            st = state.opt.state.get(p)
            if st and st["step"].device != dev:
                st["step"] = st["step"].to(dev, torch.float32)
    return changed


def training_device(device: str | torch.device | None) -> torch.device:
    """`api.resolve_device` (the card unless the caller asks for the CPU),
    with TF32 off on the card: the JAX package trains at full f32 precision
    (``Precision.HIGHEST``), and cuDNN convolutions default to TF32."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def make_train_state(model: nn.Module, lr: float = 2e-4) -> TrainState:
    return TrainState(model=model, opt=make_optimizer(model.parameters(), lr))


def init_train_state(cfg: SynthesizerConfig, generator: torch.Generator, lr: float = 2e-4,
                     device: str | torch.device | None = None) -> TrainState:
    """A random converter (`models.synthesizer.init_synthesizer`) on the
    device, with its optimizer."""
    model = S.init_synthesizer(cfg, generator).to(training_device(device))
    return make_train_state(model, lr)


def init_gan_train_state(cfg: SynthesizerConfig, generator: torch.Generator, lr: float = 2e-4,
                         device: str | torch.device | None = None) -> GanTrainState:
    """The converter's state, then the discriminators' (both drawn from
    `generator`, in that order)."""
    dev = training_device(device)
    gen = init_train_state(cfg, generator, lr, dev)
    return GanTrainState(gen=gen, disc=make_train_state(init_discriminators(generator).to(dev), lr))


# the loss's constant matrices on each device and in each dtype, made once:
# a copy from pageable host memory to the card waits for every kernel queued
# before it
_CONSTANTS: dict[tuple, torch.Tensor] = {}


def _constant(key: tuple, make, like: torch.Tensor) -> torch.Tensor:
    full = (*key, like.device, like.dtype)
    if full not in _CONSTANTS:
        _CONSTANTS[full] = torch.from_numpy(make()).to(like.device, like.dtype)
    return _CONSTANTS[full]


def _mel_from_audio_frames(audio_bt: torch.Tensor, cfg: SynthesizerConfig, num_mels: int = 80) -> torch.Tensor:
    """[B, T_samples] → [B, frames, mels] log-mel, differentiable: reflect pad
    (n_fft − hop)/2, frames at multiples of hop, the windowed DFT basis,
    sqrt(re² + im² + 1e-6), the mel filterbank, log(clamp(·, 1e-5))."""
    n_fft, hop = cfg.filter_length, cfg.hop_length
    pad = (n_fft - hop) // 2
    x = F.pad(audio_bt[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)  # [B, F, n_fft]
    basis = _constant(("basis", n_fft, cfg.win_length), lambda: stft_basis(n_fft, cfg.win_length), x)
    proj = torch.matmul(frames, basis)
    n_freq = n_fft // 2 + 1
    mag = torch.sqrt(proj[..., :n_freq] ** 2 + proj[..., n_freq:] ** 2 + 1e-6)
    fb = _constant(("mel_t", cfg.sampling_rate, n_fft, num_mels),
                   lambda: np.ascontiguousarray(mel_filterbank(cfg.sampling_rate, n_fft, num_mels, 0.0, None).T), x)
    return torch.log(torch.clamp(torch.matmul(mag, fb), min=1e-5))


def _slice_segments(x: torch.Tensor, starts: torch.Tensor, seg: int) -> torch.Tensor:
    """Per-row slice [B, T, C] → [B, seg, C] (commons.py:48-54).  Each start
    is clamped to [0, T − seg], as ``jax.lax.dynamic_slice_in_dim`` does."""
    starts = torch.clamp(starts.to(device=x.device, dtype=torch.int64), 0, x.shape[1] - seg)
    idx = starts[:, None] + torch.arange(seg, device=x.device)[None, :]
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def starts_from_u(u: torch.Tensor, spec_lengths: torch.Tensor, segment_frames: int) -> torch.Tensor:
    """The slice starts [B] = ⌊u · max(length − segment_frames, 1)⌋ of u
    uniform in [0, 1) (commons.py:57-64), on the lengths' device."""
    max_start = torch.clamp(spec_lengths - segment_frames, min=1).float()
    return (u * max_start).to(torch.int64)


def host_draws(cfg: SynthesizerConfig, b: int, t: int, generator: torch.Generator | None,
               noise: torch.Tensor | None = None,
               u: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """A step's random draws on the CPU, each taken only when the caller
    did not pass it, in the eager step's order: noise [B, T, inter]
    standard normal, then u [B] uniform in [0, 1)."""
    if (noise is None or u is None) and generator is None:
        raise ValueError("pass a torch.Generator, or both noise and the starts (or u)")
    if noise is None:
        noise = torch.randn(b, t, cfg.inter_channels, generator=generator)
    if u is None:
        u = torch.rand(b, generator=generator)
    return noise, u


def draw_noise_and_starts(cfg: SynthesizerConfig, spec_lengths: torch.Tensor, t: int,
                          generator: torch.Generator | None, segment_frames: int,
                          noise: torch.Tensor | None = None, starts: torch.Tensor | None = None,
                          rows: tuple[int, int] | None = None, u: torch.Tensor | None = None):
    """The step's noise and slice starts on the lengths' device (the lengths
    are not read back), each drawn only when the caller did not pass it, in
    `host_draws`' order: the noise, then u (where neither the starts nor u
    were passed), whose starts `starts_from_u` gives."""
    b, dev = spec_lengths.shape[0], spec_lengths.device
    first, total = rows if rows is not None else (0, b)
    if (noise is None or (starts is None and u is None)) and generator is None:
        raise ValueError("pass a torch.Generator, or both noise and the starts (or u)")
    if noise is None:
        noise = torch.randn(total, t, cfg.inter_channels, generator=generator)[first : first + b]
    if starts is None:
        if u is None:
            u = torch.rand(total, generator=generator)[first : first + b]
        starts = starts_from_u(upload(u, dev), spec_lengths, segment_frames)
    return upload(noise, dev), starts


class GeneratorOut(NamedTuple):
    audio_hat: torch.Tensor  # [B, seg·upsample] decoded slice
    target: torch.Tensor     # [B, seg·upsample] the same slice of the input audio
    z_p: torch.Tensor        # [B, T, inter]
    m_q: torch.Tensor
    logs_q: torch.Tensor
    mask: torch.Tensor       # [B, T, 1]


class DataParallel(NamedTuple):
    """This process's place in a data-parallel step: the data axis's
    collectives and its rows (first, global batch)."""

    comm: Comm
    rows: tuple[int, int]


def data_parallel(mesh: Mesh | None, batch: tuple) -> tuple[tuple, DataParallel | None]:
    """(This process's rows of each batch tensor, its `DataParallel`), or
    the batch as given and None without a mesh.  Data-parallel training
    runs one process per data position (`runtime.multihost.global_mesh`)."""
    if mesh is None:
        return batch, None
    coords = mesh.local_coords()
    if len(coords) != 1:
        raise ValueError(f"data-parallel training runs one process per data position; this process holds "
                         f"{len(coords)} (build the mesh with runtime.multihost.global_mesh)")
    local = tuple(x.local() if isinstance(x, Sharded) else x for x in batch)
    b = local[0].shape[0]
    return local, DataParallel(comms(mesh, "data")[coords[0]], (coords[0][0] * b, b * mesh.shape["data"]))


def _average(tensors: list[torch.Tensor], dp: DataParallel | None) -> list[torch.Tensor]:
    """The mean over the data axis of each tensor, in one all-reduce."""
    if dp is None:
        return tensors
    flat = dp.comm.all_reduce(torch.cat([t.reshape(-1) for t in tensors])) / dp.comm.size
    return [p.view_as(t) for p, t in zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]


def _generator_forward(model: S.Synthesizer, cfg: SynthesizerConfig, spec: torch.Tensor, audio: torch.Tensor,
                       spec_lengths: torch.Tensor, g: torch.Tensor, generator: torch.Generator | None,
                       segment_frames: int, noise: torch.Tensor | None = None,
                       starts: torch.Tensor | None = None, dp: DataParallel | None = None,
                       u: torch.Tensor | None = None) -> GeneratorOut:
    """enc_q → flow → slice → dec, shared by both steps.

    spec [B, T, n_freq], audio [B, T·hop], spec_lengths [B], g [B, 1, gin].
    With zero_g (V2) the posterior encoder and the decoder see zeros and the
    flow sees the real g, as in conversion."""
    b, t = spec.shape[0], spec.shape[1]
    mask = sequence_mask(spec_lengths, t)[..., None].to(spec.dtype)
    noise, starts = draw_noise_and_starts(cfg, spec_lengths, t, generator, segment_frames, noise, starts,
                                          rows=None if dp is None else dp.rows, u=u)
    g_enc = torch.zeros_like(g) if cfg.zero_g else g
    z, m_q, logs_q = S.posterior_encode(model, spec, mask, g_enc, 1.0, noise)
    z_p = apply_coupling_block(model.flow, z, mask, g=g, reverse=False)
    z_slice = _slice_segments(z, starts, segment_frames)
    audio_hat = model.dec(z_slice.transpose(1, 2), g=g_enc.transpose(1, 2))[:, 0]  # [B, seg·up]
    target = _slice_segments(audio.reshape(b, -1)[..., None], starts * cfg.hop_length,
                             segment_frames * cfg.upsample_factor)[..., 0]
    return GeneratorOut(audio_hat, target, z_p, m_q, logs_q, mask)


def _mel_kl(fwd: GeneratorOut, cfg: SynthesizerConfig,
            dp: DataParallel | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The mel L1 and the KL.  In a data-parallel step the KL (a masked mean)
    is weighted by this process's share of the global mask count, so that
    the mean over the data axis is the global batch's KL."""
    loss_mel = L.mel_l1(_mel_from_audio_frames(fwd.audio_hat, cfg), _mel_from_audio_frames(fwd.target, cfg))
    loss_kl = L.kl_to_standard_normal(fwd.z_p, fwd.m_q, fwd.logs_q, fwd.mask)
    if dp is not None:
        count = torch.clamp(fwd.mask.detach().sum(), min=1.0)
        loss_kl = loss_kl * (count * dp.comm.size / dp.comm.all_reduce(count))
    return loss_mel, loss_kl


def converter_loss(model: S.Synthesizer, cfg: SynthesizerConfig, spec: torch.Tensor, audio: torch.Tensor,
                   spec_lengths: torch.Tensor, g: torch.Tensor, generator: torch.Generator | None = None,
                   segment_frames: int = 32, c_mel: float = 45.0, c_kl: float = 1.0,
                   noise: torch.Tensor | None = None, starts: torch.Tensor | None = None,
                   dp: DataParallel | None = None, u: torch.Tensor | None = None):
    """The self-reconstruction objective: → (total, {"mel", "kl"})."""
    fwd = _generator_forward(model, cfg, spec, audio, spec_lengths, g, generator, segment_frames, noise, starts,
                             dp, u)
    loss_mel, loss_kl = _mel_kl(fwd, cfg, dp)
    return c_mel * loss_mel + c_kl * loss_kl, {"mel": loss_mel, "kl": loss_kl}


def discriminator_loss(disc: Discriminators, target: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """LSGAN loss of `disc` on the real slice and a (detached) fake one."""
    logits_real, _ = disc(target)
    logits_fake, _ = disc(fake.detach())
    return L.discriminator_adv_loss(logits_real, logits_fake)


def generator_loss(disc: Discriminators, fwd: GeneratorOut, cfg: SynthesizerConfig, c_mel: float = 45.0,
                   c_kl: float = 1.0, c_fm: float = 2.0, dp: DataParallel | None = None) -> tuple[torch.Tensor, dict]:
    """The generator's adversarial objective through `disc`, the real
    slice's feature maps detached: → (total, {"mel", "kl", "adv", "fm"})."""
    loss_mel, loss_kl = _mel_kl(fwd, cfg, dp)
    with torch.no_grad():
        _, fmaps_real = disc(fwd.target)
    logits_fake, fmaps_fake = disc(fwd.audio_hat)
    loss_adv = L.generator_adv_loss(logits_fake)
    loss_fm = L.feature_matching_loss(fmaps_real, fmaps_fake)
    total = c_mel * loss_mel + c_kl * loss_kl + loss_adv + c_fm * loss_fm
    return total, {"mel": loss_mel, "kl": loss_kl, "adv": loss_adv, "fm": loss_fm}


def grads_of(loss: torch.Tensor, module: nn.Module) -> list[torch.Tensor]:
    """d loss / d every parameter of `module`, in ``parameters()`` order,
    zeros where the loss does not reach (optax sees a zero gradient there).
    Nothing is written to ``.grad``."""
    params = list(module.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if gr is None else gr for p, gr in zip(params, grads)]


def _write_lr(opt: torch.optim.Optimizer, lr) -> None:
    """This step's learning rate (a float or a 0-d tensor) into each param
    group: in place into a capturable optimizer's device tensor, which a
    graph of the step reads; as a float elsewhere."""
    for group in opt.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].copy_(lr) if torch.is_tensor(lr) else group["lr"].fill_(lr)
        else:
            group["lr"] = float(lr)


def _apply_grads(state: TrainState, grads: list[torch.Tensor], lr) -> None:
    """One AdamW update of every parameter (each gets its gradient, zeros
    included, so that each is decayed as optax decays every leaf).  Every
    ``.grad`` is None again after it, and the step count is the caller's:
    inside a graph's capture no Python-side value may move."""
    for p, gr in zip(state.model.parameters(), grads):
        p.grad = gr
    _write_lr(state.opt, lr)
    state.opt.step()
    state.opt.zero_grad(set_to_none=True)


def _metrics(metrics: dict, dp: DataParallel | None) -> dict:
    """Detached metrics, averaged over the data axis in a data-parallel step."""
    names = list(metrics)
    return dict(zip(names, _average([metrics[k].detach() for k in names], dp)))


# -- the steps' graph bodies (runtime/graphs.py): tensors in, metrics out, the
# state updated in place --------------------------------------------------------

def train_step_body(state: TrainState, cfg: SynthesizerConfig, segment_frames: int, spec: torch.Tensor,
                    audio: torch.Tensor, lengths: torch.Tensor, g: torch.Tensor, noise: torch.Tensor,
                    u: torch.Tensor, lr: torch.Tensor) -> tuple:
    """One mel + KL step on staged tensors (the JAX package's jitted
    ``train_step``: static cfg and segment_frames, the draws traced): the
    starts from u, the loss, every gradient, the AdamW update in place →
    the metrics in `TRAIN_METRICS` order."""
    loss, metrics = converter_loss(state.model, cfg, spec, audio, lengths, g, segment_frames=segment_frames,
                                   noise=noise, starts=starts_from_u(u, lengths, segment_frames))
    _apply_grads(state, grads_of(loss, state.model), lr)
    return metrics["mel"].detach(), metrics["kl"].detach(), loss.detach()


def gan_train_step_body(state: GanTrainState, cfg: SynthesizerConfig, segment_frames: int, spec: torch.Tensor,
                        audio: torch.Tensor, lengths: torch.Tensor, g: torch.Tensor, noise: torch.Tensor,
                        u: torch.Tensor, lr: torch.Tensor, c_mel: torch.Tensor, c_kl: torch.Tensor,
                        c_fm: torch.Tensor) -> tuple:
    """One adversarial step on staged tensors (the jitted
    ``gan_train_step``), in `gan_train_step`'s order → the metrics in
    `GAN_METRICS` order."""
    fwd = _generator_forward(state.gen.model, cfg, spec, audio, lengths, g, None, segment_frames, noise,
                             starts_from_u(u, lengths, segment_frames))
    d_loss = discriminator_loss(state.disc.model, fwd.target, fwd.audio_hat)
    _apply_grads(state.disc, grads_of(d_loss, state.disc.model), lr)
    g_loss, metrics = generator_loss(state.disc.model, fwd, cfg, c_mel, c_kl, c_fm)
    _apply_grads(state.gen, grads_of(g_loss, state.gen.model), lr)
    return tuple(x.detach() for x in (*(metrics[k] for k in GAN_METRICS[:4]), g_loss, d_loss))


def _graph_step(state, site: str, body, states: tuple[TrainState, ...], cfg: SynthesizerConfig, spec, audio,
                spec_lengths, g, generator, segment_frames: int, noise, u, lr, **scalars) -> tuple:
    """``body(state, ...)`` through ``state.graphs`` (a replay after the
    shape's first call; eager where the cache is inactive): the draws on the
    host, every input staged, the step counts of `states` outside the body
    → the body's outputs."""
    if any([_match_device(ts) for ts in states]):  # every state's, not the first that changed
        state.graphs.clear()  # they read the optimizer's old learning-rate tensors
    b, t = spec.shape[0], spec.shape[1]
    noise, u = host_draws(cfg, b, t, generator, noise, u)
    dtype = next(states[0].model.parameters()).dtype
    inputs = {"spec": spec, "audio": audio, "lengths": spec_lengths, "g": g, "noise": noise, "u": u,
              "lr": torch.tensor(lr, dtype=torch.float64),
              **{k: torch.tensor(v, dtype=dtype) for k, v in scalars.items()}}
    key = GraphKey(site, bucket=t, batch=b, segment_frames=segment_frames)
    out = state.graphs.run(key, partial(body, state, cfg, segment_frames), inputs)
    for ts in states:
        ts.step += 1
    return out


def _graph_route(state, mesh: Mesh | None, starts) -> bool:
    """Whether a step takes `_graph_step`: one device (no mesh), the starts
    from u.  A step given its starts runs only where no graph is captured."""
    if mesh is not None:
        return False
    if starts is not None:
        if state.graphs.active():
            raise ValueError("a graph of the step computes its starts from u: pass u instead of starts, or turn "
                             "state.graphs off")
        return False
    return True


def train_step(state: TrainState, cfg: SynthesizerConfig, spec: torch.Tensor, audio: torch.Tensor,
               spec_lengths: torch.Tensor, g: torch.Tensor, generator: torch.Generator | None = None,
               segment_frames: int = 32, lr: float = 2e-4, noise: torch.Tensor | None = None,
               starts: torch.Tensor | None = None, mesh: Mesh | None = None,
               u: torch.Tensor | None = None) -> tuple[TrainState, dict]:
    """One mel + KL step → (state, {"mel", "kl", "total"}), the metrics as
    detached 0-d tensors on the device.  `lr` applies to this step (pass the
    value used at init, or a schedule's output).  The batch may lie on the
    host or on the state's device; `noise` and `u` (or `starts`), if passed,
    replace the generator's draws.  On one device the step is
    `train_step_body` through ``state.graphs``; with `mesh` it is
    data-parallel (`data_parallel`; `noise` and `starts`, if passed, are
    this process's rows) and eager."""
    if _graph_route(state, mesh, starts):
        out = _graph_step(state, "train_step", train_step_body, (state,), cfg, spec, audio, spec_lengths,
                          g, generator, segment_frames, noise, u, lr)
        return state, dict(zip(TRAIN_METRICS, out))
    (spec, audio, spec_lengths, g), dp = data_parallel(mesh, (spec, audio, spec_lengths, g))
    loss, metrics = converter_loss(state.model, cfg, spec, audio, spec_lengths, g, generator,
                                   segment_frames=segment_frames, noise=noise, starts=starts, dp=dp, u=u)
    _apply_grads(state, _average(grads_of(loss, state.model), dp), lr)
    state.step += 1
    return state, _metrics({**metrics, "total": loss}, dp)


def gan_train_step(state: GanTrainState, cfg: SynthesizerConfig, spec: torch.Tensor, audio: torch.Tensor,
                   spec_lengths: torch.Tensor, g: torch.Tensor, generator: torch.Generator | None = None,
                   segment_frames: int = 32, c_mel: float = 45.0, c_kl: float = 1.0, c_fm: float = 2.0,
                   lr: float = 2e-4, noise: torch.Tensor | None = None,
                   starts: torch.Tensor | None = None, mesh: Mesh | None = None,
                   u: torch.Tensor | None = None) -> tuple[GanTrainState, dict]:
    """One adversarial step in the JAX package's order: the generator's
    forward once (JAX runs it twice on the same draws, to the same values),
    the discriminator's update on the detached fake, then the generator's
    loss through the UPDATED discriminator and the generator's update.  The
    generator's gradients are taken over its own parameters alone, so the
    discriminator's parameters and moments see only their own update.  On
    one device `gan_train_step_body` through ``state.graphs``; with `mesh`
    data-parallel and eager, as `train_step`.
    → (state, {"mel", "kl", "adv", "fm", "gen_total", "disc"})."""
    if _graph_route(state, mesh, starts):
        out = _graph_step(state, "gan_train_step", gan_train_step_body, (state.gen, state.disc), cfg, spec,
                          audio, spec_lengths, g, generator, segment_frames, noise, u, lr, c_mel=c_mel, c_kl=c_kl,
                          c_fm=c_fm)
        return state, dict(zip(GAN_METRICS, out))
    (spec, audio, spec_lengths, g), dp = data_parallel(mesh, (spec, audio, spec_lengths, g))
    fwd = _generator_forward(state.gen.model, cfg, spec, audio, spec_lengths, g, generator, segment_frames,
                             noise, starts, dp, u)
    d_loss = discriminator_loss(state.disc.model, fwd.target, fwd.audio_hat)
    _apply_grads(state.disc, _average(grads_of(d_loss, state.disc.model), dp), lr)
    g_loss, metrics = generator_loss(state.disc.model, fwd, cfg, c_mel, c_kl, c_fm, dp)
    _apply_grads(state.gen, _average(grads_of(g_loss, state.gen.model), dp), lr)
    state.gen.step += 1
    state.disc.step += 1
    return state, _metrics({**metrics, "gen_total": g_loss, "disc": d_loss}, dp)
