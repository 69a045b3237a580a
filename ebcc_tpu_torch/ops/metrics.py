"""Error metrics: data range, max error, relative error, quantiles.

Counterpart of ``ebcc_tpu.ops.metrics`` on tensors: the reference's metric
helpers (j2k_codec.h:237-303: ``get_data_range``, ``get_max_error``,
``get_max_relative_error``, ``get_error_target_quantile`` and the pointwise
variants), batched over a leading frame axis, in the input's dtype and on
the input's device.
"""

from __future__ import annotations

import torch

_FRAME = (-2, -1)


def data_range(x: torch.Tensor) -> torch.Tensor:
    """max - min per frame (j2k_codec.h:237-249)."""
    return torch.amax(x, dim=_FRAME) - torch.amin(x, dim=_FRAME)


def max_error(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """max |x - y| per frame (j2k_codec.h:264-279)."""
    return torch.amax(torch.abs(x - y), dim=_FRAME)


def max_relative_error(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """max |x - y| / range(x) per frame (j2k_codec.h:251-262)."""
    return max_error(x, y) / data_range(x)


def error_quantile(x: torch.Tensor, y: torch.Tensor,
                   error_target) -> torch.Tensor:
    """Fraction of points with |x - y| <= target (j2k_codec.h:281-291).

    ``error_target`` broadcasts: scalar, per-frame [B], or per-point.
    """
    t = torch.as_tensor(error_target, dtype=x.dtype, device=x.device)
    if t.ndim == 1:
        t = t[:, None, None]
    return torch.mean((torch.abs(x - y) <= t).to(x.dtype), dim=_FRAME)


def pointwise_violations(x: torch.Tensor, y: torch.Tensor,
                         error_bound) -> torch.Tensor:
    """Count of points violating a per-point bound (j2k_codec.h:293-303)."""
    eb = torch.as_tensor(error_bound, dtype=x.dtype, device=x.device)
    return torch.sum(torch.abs(x - y) > eb, dim=_FRAME)


def rmse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean((x - y) ** 2, dim=_FRAME))


def psnr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio against the per-frame data range."""
    r = data_range(x)
    return 20.0 * torch.log10(r / torch.clamp(rmse(x, y), min=1e-30))
