"""Layer initializers of the port (``src/repro/models/layers.py``)."""
from __future__ import annotations

import torch


def orthogonal_init(generator: torch.Generator, d_in: int, d_out: int,
                    dtype=torch.float32) -> torch.Tensor:
    """Orthonormal-column init: a Stiefel-feasible starting point for
    manifold-constrained weights (the paper initializes on St(d, r))."""
    tall = d_in >= d_out
    a = torch.randn((d_in, d_out) if tall else (d_out, d_in),
                    generator=generator)
    q = torch.linalg.qr(a)[0]
    return (q if tall else q.T).to(dtype).contiguous()
