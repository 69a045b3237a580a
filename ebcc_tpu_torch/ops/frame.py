"""Frame preparation: padding, u16 scale/unscale, DC removal.

Counterpart of ``ebcc_tpu.ops.frame``, batched over a leading frame axis.
The arithmetic follows the native encoder site by site
(``native/ebcc_cpu_encoder.cc``), which is byte-identical to the JAX
pipeline: the unscale is one fused multiply-add, ``fma(y, RECIP_U16 * rng,
mn)``, emulated in float64 (:func:`fma`), and the DC floor sums in float64.
"""

from __future__ import annotations

import numpy as np
import torch

U16_MAX = 65535.0
RESID_SCALE = 255.0  # reference residual quantisation scale (spiht_re.h:12)
# f32-rounded reciprocals: division by a constant compiles to a multiply
# by these (ebcc_cpu_encoder.cc:71-76)
RECIP_U16 = float(np.float32(1.0 / 65535.0))
RECIP_RS = float(np.float32(1.0 / 255.0))


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding, as native ``std::fma``.

    Emulated in float64: the product of two floats is exact there, the sum
    rounds once to float64 and once more to float32.  ``a`` is a float32
    tensor; ``b``/``c`` are float32 tensors broadcastable to it or Python
    floats holding float32 values."""
    b = b.double() if torch.is_tensor(b) else b
    c = c.double() if torch.is_tensor(c) else c
    return (a.double() * b + c).float()


def padded_size(n: int, levels: int) -> int:
    """Smallest multiple of 2**(levels+1) that is >= n (dwt.h:42-45)."""
    m = 1 << (levels + 1)
    return ((n + m - 1) // m) * m


def pad_symmetric(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Pad ``[..., H, W]`` on the right/bottom to multiples of 2**(levels+1):
    the right pad mirrors the last columns, the bottom pad mirrors the last
    rows of the original region, and the bottom-right corner is zero
    (dwt.h:61-70)."""
    h, w = x.shape[-2], x.shape[-1]
    hp, wp = padded_size(h, levels), padded_size(w, levels)
    ey, ex = hp - h, wp - w
    xw = x
    if ex:
        xw = torch.cat([x, x[..., :, w - ex:].flip(-1)], dim=-1)
    if ey:
        bottom = x[..., h - ey:, :].flip(-2)
        if ex:
            corner = x.new_zeros((*x.shape[:-2], ey, ex))
            bottom = torch.cat([bottom, corner], dim=-1)
        xw = torch.cat([xw, bottom], dim=-2)
    return xw


def crop(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return x[..., :h, :w]


def minmax(x: torch.Tensor):
    """Per-frame min/max over the trailing two dims."""
    flat = x.flatten(-2)
    return flat.amin(-1), flat.amax(-1)


def scale_to_u16(x: torch.Tensor, mn: torch.Tensor,
                 mx: torch.Tensor) -> torch.Tensor:
    """``(x - mn) / (mx - mn) * 65535``, clipped to [0, 65535] and truncated
    toward zero (the C cast to uint16, j2k_codec.h:523-526): float32
    holding integers, constant fields at 0.  Three separately rounded
    float32 operations, as the native host scaling (``scale_u16_ref``,
    ebcc_cpu_encoder.cc), so the planes are bit-equal to its u16 output."""
    rng = mx - mn
    safe = torch.where(rng > 0, rng, 1.0)
    y = (x - mn[:, None, None]) / safe[:, None, None] * U16_MAX
    return torch.trunc(y.clamp(0.0, U16_MAX))


def unscale(y: torch.Tensor, mn: torch.Tensor, mx: torch.Tensor,
            recip: float = RECIP_U16) -> torch.Tensor:
    """``y / scale * (mx - mn) + mn`` as ``fma(y, recip * (mx - mn), mn)``
    per frame (ebcc_cpu_decoder.cc:313-330; ``recip`` = 1/65535 for the
    base layer, 1/255 for the residual layer)."""
    c = recip * (mx - mn)  # float32
    return fma(y, c[:, None, None], mn[:, None, None])


def sub_dc_floor(x: torch.Tensor):
    """Subtract the floored mean over the trailing two dims (dwt.h:252-267).

    The mean is a float64 sum rounded to float32 before the floor
    (``dc_floor_mean``, ebcc_cpu_encoder.cc:232-236).  Returns (centred,
    dc [B])."""
    n = x.shape[-2] * x.shape[-1]
    dc = torch.floor((x.double().sum(dim=(-2, -1)) / n).float())
    return x - dc[:, None, None], dc
