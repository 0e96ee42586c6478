"""Piecewise rational-quadratic spline flows of the reference (the
stochastic duration predictor's coupling; reference repository:
openvoice/transforms.py): a frozen copy of the port's f32 version, which
runs the reference's bin search and linear tails without branches."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _searchsorted(bin_locations: torch.Tensor, inputs: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Reference semantics: add eps to the last edge, count edges <= input."""
    bin_locations = bin_locations.clone()
    bin_locations[..., -1] += eps
    return (inputs[..., None] >= bin_locations).sum(dim=-1) - 1


def _edges(unnormalized: torch.Tensor, lo: float, hi: float, min_bin: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Softmax bin sizes with a floor → (cumulative edges [..., K+1] pinned
    to lo and hi, bin sizes [..., K])."""
    num_bins = unnormalized.shape[-1]
    sizes = min_bin + (1 - min_bin * num_bins) * torch.softmax(unnormalized, dim=-1)
    cum = F.pad(torch.cumsum(sizes, dim=-1), (1, 0))
    cum = (hi - lo) * cum + lo
    cum[..., 0] = lo
    cum[..., -1] = hi
    return cum, cum[..., 1:] - cum[..., :-1]


def rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    left: float = 0.0,
    right: float = 1.0,
    bottom: float = 0.0,
    top: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Monotonic RQ spline (Durkan et al.); inputs [...], params [..., K]
    (derivatives [..., K+1])."""
    num_bins = unnormalized_widths.shape[-1]
    cumwidths, widths = _edges(unnormalized_widths, left, right, min_bin_width)
    cumheights, heights = _edges(unnormalized_heights, bottom, top, min_bin_height)
    derivatives = min_derivative + F.softplus(unnormalized_derivatives)

    bin_idx = _searchsorted(cumheights if inverse else cumwidths, inputs)
    bin_idx = torch.clamp(bin_idx, 0, num_bins - 1)[..., None]

    def take(arr):
        return torch.gather(arr, -1, bin_idx)[..., 0]

    input_cumwidths = take(cumwidths)
    input_bin_widths = take(widths)
    input_cumheights = take(cumheights)
    delta = heights / widths
    input_delta = take(delta)
    input_derivatives = take(derivatives)
    input_derivatives_plus_one = take(derivatives[..., 1:])
    input_heights = take(heights)
    slope_sum = input_derivatives + input_derivatives_plus_one - 2 * input_delta

    if inverse:
        a = (inputs - input_cumheights) * slope_sum + input_heights * (input_delta - input_derivatives)
        b = input_heights * input_derivatives - (inputs - input_cumheights) * slope_sum
        c = -input_delta * (inputs - input_cumheights)
        discriminant = torch.clamp(b * b - 4 * a * c, min=0.0)
        root = (2 * c) / (-b - torch.sqrt(discriminant))
        outputs = root * input_bin_widths + input_cumwidths
        theta = root
    else:
        theta = (inputs - input_cumwidths) / input_bin_widths
    theta_one_minus_theta = theta * (1 - theta)
    denominator = input_delta + slope_sum * theta_one_minus_theta
    if not inverse:
        numerator = input_heights * (input_delta * theta * theta + input_derivatives * theta_one_minus_theta)
        outputs = input_cumheights + numerator / denominator
    derivative_numerator = input_delta * input_delta * (
        input_derivatives_plus_one * theta * theta
        + 2 * input_delta * theta_one_minus_theta
        + input_derivatives * (1 - theta) * (1 - theta)
    )
    logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)
    return outputs, (-logabsdet if inverse else logabsdet)


def unconstrained_rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    tail_bound: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Linear tails outside [−tail_bound, tail_bound] (transforms.py:50-97)."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    # the derivative parameters are padded with the boundary constant at both
    # ends, so that the spline meets the identity tails with slope 1
    constant = float(math.log(math.exp(1 - min_derivative) - 1))
    unnormalized_derivatives = F.pad(unnormalized_derivatives, (1, 1), value=constant)
    out_in, lad_in = rational_quadratic_spline(
        torch.clamp(inputs, -tail_bound, tail_bound),
        unnormalized_widths, unnormalized_heights, unnormalized_derivatives,
        inverse=inverse, left=-tail_bound, right=tail_bound, bottom=-tail_bound, top=tail_bound,
        min_bin_width=min_bin_width, min_bin_height=min_bin_height, min_derivative=min_derivative,
    )
    return torch.where(inside, out_in, inputs), torch.where(inside, lad_in, lad_in.new_zeros(()))


def piecewise_rational_quadratic_transform(
    inputs,
    unnormalized_widths,
    unnormalized_heights,
    unnormalized_derivatives,
    inverse=False,
    tails=None,
    tail_bound=1.0,
    min_bin_width=DEFAULT_MIN_BIN_WIDTH,
    min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
    min_derivative=DEFAULT_MIN_DERIVATIVE,
):
    """Dispatch as in transforms.py:12-42: no tails, or linear tails."""
    kwargs = dict(inverse=inverse, min_bin_width=min_bin_width, min_bin_height=min_bin_height,
                  min_derivative=min_derivative)
    if tails is None:
        return rational_quadratic_spline(inputs, unnormalized_widths, unnormalized_heights,
                                         unnormalized_derivatives, **kwargs)
    if tails != "linear":
        raise NotImplementedError(f"{tails} tails are not implemented")
    return unconstrained_rational_quadratic_spline(inputs, unnormalized_widths, unnormalized_heights,
                                                   unnormalized_derivatives, tail_bound=tail_bound, **kwargs)
