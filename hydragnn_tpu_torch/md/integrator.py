"""Velocity-Verlet on an exact binary grid (counterpart:
hydragnn_tpu/md/integrator.py, bit for bit).

Every value the integrator touches is exactly representable, so no
operation rounds and no order of evaluation can change a result:

* positions live on the 2**-POS_BITS grid, the velocity*dt ("vd") and
  acceleration*dt² ("ad2") terms on the 2**-(VEL_BITS+1) grid; sums of
  grid multiples within `validate_ranges`' limits are exact in float64;
* the only products are by powers of two or the force-scaling products
  F * s_hi and F * s_lo, where F carries a float32 mantissa (24 bits) and
  each Veltkamp half of the scale at most 27 bits: both are exact;
* each re-quantization rounds once, through floor(x * 2**bits + 0.5).

The same exactness makes the Verlet-skin displacement check and the
candidate re-filter's d² (sums of squares of grid coordinates) exact, so
every rebuild decision is reproducible. The cost: positions are snapped
to 2**-21 (~5e-7 box units, finer than the float32 positions the model
sees) and velocity increments to 2**-41.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# contract constants, not knobs: changing them changes every trajectory
POS_BITS = 21
VEL_BITS = 40

_POS_SCALE = float(2.0 ** POS_BITS)
_POS_INV = float(2.0 ** -POS_BITS)
_VEL_SCALE = float(2.0 ** VEL_BITS)
_VEL_INV = float(2.0 ** -VEL_BITS)

# float64 holds integers to 2^53 and the finest grid is 2^-41, so
# coordinates must stay below 2^12 (COORD_LIMIT keeps a factor 2); every
# d² is exact while 3 (d 2^POS_BITS)² < 2^53, d <= ~26, and candidates
# reach ~2 (r + skin), so r + skin <= 8 leaves a margin
COORD_LIMIT = float(2.0 ** 11)
CUTOFF_LIMIT = 8.0

_SPLITTER = float(2.0 ** 27 + 1.0)  # Veltkamp split constant for float64


def validate_ranges(coord_max: float, cutoff_plus_skin: float) -> None:
    """Raise when the exact-arithmetic budget cannot be guaranteed."""
    if not np.isfinite(coord_max) or coord_max > COORD_LIMIT:
        raise ValueError(
            f"MD grid integrator: coordinate magnitude {coord_max} exceeds "
            f"the exact-arithmetic limit {COORD_LIMIT} (positions must "
            "stay below it for every integrator add to be exact; "
            "recenter the system or shrink the box)")
    if not np.isfinite(cutoff_plus_skin) or cutoff_plus_skin > CUTOFF_LIMIT:
        raise ValueError(
            f"MD grid integrator: cutoff + skin = {cutoff_plus_skin} "
            f"exceeds the exact-d^2 limit {CUTOFF_LIMIT} (candidate "
            "distances must square exactly on the position grid; use a "
            "smaller cutoff or rescale coordinates)")


def quantize_pos(x):
    """Snap to the position grid: floor(x 2^POS_BITS + 0.5) 2^-POS_BITS."""
    return np.floor(x * _POS_SCALE + 0.5) * _POS_INV


def quantize_vel(x):
    """Snap to the velocity-increment grid (2^-VEL_BITS)."""
    return np.floor(x * _VEL_SCALE + 0.5) * _VEL_INV


def init_state(pos0, vel0, dt: float) -> Tuple[np.ndarray, np.ndarray]:
    """(pos, vd): the initial state on the grids; vd carries vel * dt."""
    pos = quantize_pos(np.asarray(pos0, np.float64))
    vd = quantize_vel(np.asarray(vel0, np.float64) * float(dt))
    return pos, vd


def quantize_cell(cell) -> np.ndarray:
    """A [3, 3] lattice snapped to the position grid, so the ghost
    offsets (shifts_int @ cell) land on it too."""
    return quantize_pos(np.asarray(cell, np.float64).reshape(3, 3))


def force_scale_split(dt: float, force_scale: float = 1.0,
                      mass: float = 1.0) -> Tuple[float, float]:
    """Veltkamp halves of (force_scale / mass) dt² 2^VEL_BITS."""
    s2 = (float(force_scale) / float(mass)) * float(dt) * float(dt) * _VEL_SCALE
    if not np.isfinite(s2):
        raise ValueError(
            f"MD grid integrator: non-finite force scale from dt={dt}, "
            f"force_scale={force_scale}, mass={mass}")
    c = s2 * _SPLITTER
    hi = c - (c - s2)
    lo = s2 - hi
    return float(hi), float(lo)


def accel_term(forces, s_hi: float, s_lo: float):
    """ad2: F (force_scale / mass) dt² on the velocity grid. Forces are
    rounded through float32 first (the split products need a 24-bit
    mantissa); both products are then exact and each floor rounds once."""
    f = forces.astype(np.float32).astype(np.float64)
    a = np.floor(f * s_hi + 0.5) + np.floor(f * s_lo + 0.5)
    return a * _VEL_INV


def drift(pos, vd, ad2):
    """pos' = quantize(pos + vd + ad2 / 2): grid addends, exact sum."""
    return quantize_pos(pos + vd + 0.5 * ad2)


def kick(vd, ad2, ad2_new):
    """vd' = vd + (ad2 + ad2') / 2: the two velocity half-kicks."""
    return vd + 0.5 * (ad2 + ad2_new)


# ------------------------------------------------------ torch forms --


def quantize_pos_torch(x: torch.Tensor) -> torch.Tensor:
    """`quantize_pos` on a float64 tensor."""
    return torch.floor(x * _POS_SCALE + 0.5) * _POS_INV


def accel_term_torch(forces: torch.Tensor, s_hi: float,
                     s_lo: float) -> torch.Tensor:
    """`accel_term` on a tensor: forces rounded through float32, then the
    two exact split products, each floored once."""
    f = forces.to(torch.float32).to(torch.float64)
    a = torch.floor(f * s_hi + 0.5) + torch.floor(f * s_lo + 0.5)
    return a * _VEL_INV


def drift_torch(pos: torch.Tensor, vd: torch.Tensor,
                ad2: torch.Tensor) -> torch.Tensor:
    """`drift` on float64 tensors."""
    return quantize_pos_torch(pos + vd + 0.5 * ad2)


def kick_torch(vd: torch.Tensor, ad2: torch.Tensor,
               ad2_new: torch.Tensor) -> torch.Tensor:
    """`kick` on float64 tensors."""
    return vd + 0.5 * (ad2 + ad2_new)


def displacement2_torch(pos: torch.Tensor, ref: torch.Tensor
                        ) -> torch.Tensor:
    """Squared displacement from the reference positions over the last
    axis, [..., 3] -> [...]: the Verlet-skin check's d², exact on the
    grid (graphs/neighborlist.py compares it with (skin / 2)²)."""
    d = pos - ref
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]
