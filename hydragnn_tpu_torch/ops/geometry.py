"""Edge geometry (counterpart: hydragnn_tpu/ops/geometry.py)."""
from __future__ import annotations

import torch

from ..kernels.segment import gather_rows
from .scalars import weak


def edge_vectors(pos, senders, receivers, edge_shifts=None, eps: float = 1e-9,
                 send_layout=None, recv_layout=None):
    """(vec [E, 3], length [E]) with vec = pos[send] + shift - pos[recv]
    and length = sqrt(|vec|² + eps): a padding edge (a self-loop on the
    padding node, no shift) has length sqrt(eps), finite, and callers
    mask it at aggregation. The gathers' gradient is a segment sum
    (kernels.segment.gather_rows), so forces taken through it are the
    same on every run. `send_layout` / `recv_layout` are CSR views of the
    senders / receivers (kernels.fused_mp.segment_layouts), when the caller
    has them: the gathers' backward then walks them instead of sorting.
    The filter layouts leave out the masked padding edges, whose gradient
    rows land only in the padding node."""
    vec = (gather_rows(pos, senders, send_layout)
           - gather_rows(pos, receivers, recv_layout))
    if edge_shifts is not None:
        vec = vec + edge_shifts
    length = torch.sqrt(torch.sum(vec * vec, dim=-1) + weak(eps, vec))
    return vec, length
