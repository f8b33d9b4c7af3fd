"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA device and skip without one (``cuda`` fixture,
decided when a test runs).  They import no JAX, so they run on a GPU
machine that has only PyTorch:

    python -m pytest -q tests/test_torch_cuda.py

Gates as in ``chip_smoke.py``: the ring mixes (fp32 and int8) bitwise,
stiefel_project 1e-5 relative, fused_retract 5e-5 absolute.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.comms.backend import StackedBackend
from repro_torch.comms.compress import quantize_det
from repro_torch.core.gossip import GossipSpec
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


def _quant_hop_plain(q, s):
    return ref.quant_mix_ref(q, q.roll(1, 0), q.roll(-1, 0), s, s.roll(1, 0),
                             s.roll(-1, 0), WC, WS)


@pytest.mark.parametrize("n", [3, 20])
@pytest.mark.parametrize("f", [1, 3, 130, 50176])
def test_cuda_quant_kernels_bitwise(cuda, n, f):
    gen = torch.Generator(device=cuda).manual_seed(n + f)
    x = torch.randn((n, f), generator=gen, device=cuda)
    q, s = quantize_det(x)
    s = s.reshape(n, 1)
    ops.reset_launch_counts()
    assert torch.equal(ops.quant_mix(q, s, w_self=WC, w_side=WS),
                       _quant_hop_plain(q, s))
    for hops in (1, 3, 66):
        want = ref.multi_hop_mix_quant_ref(
            ref.ring_panel(q, hops), ref.ring_panel(s, hops), hops=hops,
            w_self=WC, w_side=WS)[hops:hops + n]
        got = ops.multi_hop_mix_quant(q, s, hops=hops, w_self=WC, w_side=WS)
        assert torch.equal(got, want), hops
    counts = ops.launch_counts()
    assert counts["quant_mix"] == 1 and counts["multi_hop_mix_quant"] == 3


def test_cuda_quant_ring_hops_is_the_plain_schedule(cuda):
    """The backend's one-launch all-hop schedule == hop by hop
    quantize_det + quant_mix, the JAX package's stacked schedule."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    spec = GossipSpec(n_nodes=20)
    for shape in [(20, 3), (20, 16, 8, 3, 3), (20, 784, 64)]:
        x = torch.randn(shape, generator=gen, device=cuda)
        z = x
        for _ in range(7):
            q, s = quantize_det(z)
            z = _quant_hop_plain(q.reshape(20, -1),
                                 s.reshape(20, 1)).reshape(shape)
        assert torch.equal(StackedBackend().quant_ring_hops(spec, x, 7), z)


def test_cuda_quant_wrappers_refuse_other_dtypes(cuda):
    q = torch.zeros(4, 8, dtype=torch.int8, device=cuda)
    s = torch.ones(4, 1, device=cuda)
    for call in (ops.quant_mix,
                 lambda a, b, **kw: ops.multi_hop_mix_quant(a, b, hops=2,
                                                            **kw)):
        with pytest.raises(TypeError, match="int8"):
            call(q.float(), s, w_self=WC, w_side=WS)
        with pytest.raises(TypeError, match="float32"):
            call(q, s.double(), w_self=WC, w_side=WS)
