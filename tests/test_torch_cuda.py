"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA device and skip without one (``cuda`` fixture,
decided when a test runs).  They import no JAX, so they run on a GPU
machine that has only PyTorch:

    python -m pytest -q tests/test_torch_cuda.py

Gates as in ``chip_smoke.py``: the ring mixes bitwise, stiefel_project
1e-5 relative, fused_retract 5e-5 absolute.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import ops, ref

WC, WS = 1.0 / 3.0, 1.0 / 3.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_cuda_ring_kernels_bitwise(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    ops.reset_launch_counts()
    for shape in [(20, 3), (20, 16, 8, 3, 3), (5, 1001), (3, 4096)]:
        x = torch.randn(shape, generator=gen, device=cuda)
        want = ref.ring_mix_ref(x, x.roll(1, 0), x.roll(-1, 0), WC, WS)
        assert torch.equal(ops.ring_mix(x, w_self=WC, w_side=WS), want)
        for hops in (1, 3, 67):
            z = x
            for _ in range(hops):
                z = ref.ring_mix_ref(z, z.roll(1, 0), z.roll(-1, 0), WC, WS)
            assert torch.equal(
                ops.multi_hop_mix(x, hops=hops, w_self=WC, w_side=WS), z)
    counts = ops.launch_counts()
    assert counts["ring_mix"] == 4 and counts["multi_hop_mix"] == 12


@pytest.mark.parametrize("shape", [(20, 784, 64), (20, 64, 3), (784, 64),
                                   (3, 1000, 37), (2, 600, 130)])
def test_cuda_stiefel_kernels_vs_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.linalg.qr(torch.randn(shape, generator=gen, device=cuda))[0]
    g = 0.5 * x + 0.1 * torch.randn(shape, generator=gen, device=cuda)
    want = ref.stiefel_project_ref(x, g)
    got = ops.stiefel_project(x, g)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    got = ops.fused_retract(x, g)
    assert float((got - ref.fused_retract_ref(x, g)).abs().max()) <= 5e-5


def test_cuda_wrappers_raise_on_fp64(cuda):
    x = torch.randn(4, 8, 2, device=cuda, dtype=torch.float64)
    for call in (lambda: ops.ring_mix(x, w_self=WC, w_side=WS),
                 lambda: ops.multi_hop_mix(x, hops=2, w_self=WC, w_side=WS),
                 lambda: ops.stiefel_project(x, x),
                 lambda: ops.fused_retract(x, x)):
        with pytest.raises(TypeError, match="float32"):
            call()
