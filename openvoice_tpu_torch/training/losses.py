"""Training losses for the converter stack (the port of
``openvoice_tpu/training/losses.py``).

The VITS recipe: mel reconstruction and prior KL, plus the LSGAN terms and
feature matching of the adversarial step (``training/discriminator.py``).
Plain functions on tensors, differentiable under ``torch.autograd``.
"""

from __future__ import annotations

from typing import Sequence

import torch


def kl_to_standard_normal(z_p: torch.Tensor, m_q: torch.Tensor, logs_q: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """KL(q(z|x) ‖ N(0, I)) evaluated on the flow-mapped latent, as a masked
    mean per frame.

    The converter's coupling flow is volume-preserving (mean-only couplings:
    logdet ≡ 0), so the posterior entropy term uses logs_q directly while
    the cross-entropy uses z_p.  `m_q` is unused, as in the JAX package."""
    ce = 0.5 * torch.square(z_p)
    ent = logs_q + 0.5
    return torch.sum((ce - ent) * mask) / torch.clamp(torch.sum(mask), min=1.0)


def mel_l1(mel_hat: torch.Tensor, mel_ref: torch.Tensor) -> torch.Tensor:
    """L1 over log-mels (the VITS/HiFi-GAN reconstruction term)."""
    return torch.mean(torch.abs(mel_hat - mel_ref))


def feature_matching_loss(fmaps_real: Sequence[Sequence[torch.Tensor]],
                          fmaps_fake: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
    """Mean over every feature map of mean |real − fake|."""
    terms = [torch.mean(torch.abs(r - f)) for fr, ff in zip(fmaps_real, fmaps_fake) for r, f in zip(fr, ff)]
    return sum(terms) / max(len(terms), 1)


def generator_adv_loss(disc_fake_outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """LSGAN generator loss: E[(D(G(x)) − 1)²], averaged over discriminators."""
    total = sum(torch.mean(torch.square(d - 1.0)) for d in disc_fake_outputs)
    return total / max(len(disc_fake_outputs), 1)


def discriminator_adv_loss(disc_real_outputs: Sequence[torch.Tensor],
                           disc_fake_outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """LSGAN discriminator loss: E[(D(x) − 1)²] + E[D(G(x))²], averaged over
    discriminators."""
    total = sum(torch.mean(torch.square(dr - 1.0)) + torch.mean(torch.square(df))
                for dr, df in zip(disc_real_outputs, disc_fake_outputs))
    return total / max(len(disc_real_outputs), 1)
