"""How orthonormal the plain polar retraction's result is, on the CPU and
on the card, with its products summed over the whole reduction and in
chunks of ``ref.CHUNK_K`` (what ``geometry/stiefel.py`` ships above
``ref.LONG_K``).

At musicgen-large's 2048 x 2048 Stiefel leaves and at smollm-135m's
576 x 576 ones, for a tangent step of 1e-3 and 1e-2 times a Gaussian (one
leaf, seeded): || y^T y - I ||_F of the retracted y, in fp64 (the
iterate's own feasibility) and in fp32 (as the trainer's metric reads
it).  TF32 is off.

    python -m repro_torch.launch.retract_accuracy [--devices cpu,cuda]
"""
from __future__ import annotations

import argparse
import json
import contextlib
from unittest import mock

import torch

from repro_torch.geometry import stiefel as st
from repro_torch.kernels import ref

SHAPES = ((2048, 2048), (576, 576))
SCALES = (1e-3, 1e-2)


def feasibility(x: torch.Tensor, u: torch.Tensor, device: str,
                whole: bool) -> dict:
    """The residuals of ``retract_polar(x, u)`` on ``device``, its
    reductions whole (``whole``) or as shipped."""
    with mock.patch.object(ref, "LONG_K", 1 << 30) if whole \
            else contextlib.nullcontext():
        y = st.retract_polar(x.to(device), u.to(device)).cpu()
    return {"fp64": float(st.stiefel_error(y.double())),
            "fp32": float(st.stiefel_error(y))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", default="cpu,cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    for d, r in SHAPES:
        x = torch.linalg.qr(torch.randn(d, r, generator=gen,
                                        dtype=torch.float64))[0].float()
        for scale in SCALES:
            u = ref.stiefel_project_ref(
                x, scale * torch.randn(d, r, generator=gen))
            row = {"d": d, "r": r, "scale": scale}
            for dev in args.devices.split(","):
                for whole in (True, False):
                    key = f"{dev} {'whole' if whole else 'chunked'}"
                    row[key] = feasibility(x, u, dev, whole)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
