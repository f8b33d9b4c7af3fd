"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA device and skip without one (``cuda`` fixture,
decided when a test runs).  They import no JAX, so they run on a GPU
machine that has only PyTorch:

    python -m pytest -q tests/test_torch_cuda.py

Gates as in ``chip_smoke.py``: the ring mixes (fp32 and int8, one leaf
or a grouped tree, the int8 first hop with the exact hop of a base fused
in) bitwise,
stiefel_project 1e-5 relative (one leaf or a grouped tree, on chip or
streaming), fused_retract 5e-5 absolute, the attention
kernels 2e-5 absolute in fp32 and 2e-2 in bf16 (the JAX package's gates;
bf16 with outputs in [4, 8) against the reference's unrounded fp32 result),
with exact zeros for query rows without keys and for empty decode slots.
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


def _hops_plain(x, hops):
    z = x
    for _ in range(hops):
        z = ref.ring_mix_ref(z, z.roll(1, 0), z.roll(-1, 0), WC, WS)
    return z


# the ragged tree of the CPU tests (y / v, conv1, conv2, an odd width)
RAGGED = [(3,), (72,), (1152,), (1001,), (16, 8, 3, 3)]


@pytest.mark.parametrize("n", [3, 20, 32, 33, 40, 64])
def test_cuda_grouped_ring_mixes_bitwise(cuda, n):
    """One grouped launch over a ragged tree == the plain hops, bit for
    bit: the register kernel (n <= 32) and the shared-memory one (n = 33,
    40; 64 needs more than 48 KB of shared memory a block), with a leaf that
    is not 16-byte aligned (a view at offset 1: the scalar path)."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    xs = [torch.randn((n, *s), generator=gen, device=cuda) for s in RAGGED]
    xs.append(torch.randn(n * 1152 + 1, generator=gen,
                          device=cuda)[1:].view(n, 1152))
    assert xs[-1].data_ptr() % 16 != 0
    ops.reset_launch_counts()
    for x, o in zip(xs, ops.ring_mix_leaves(xs, w_self=WC, w_side=WS)):
        assert o.shape == x.shape and torch.equal(o, _hops_plain(x, 1))
    for hops in (1, 3, 67):
        got = ops.multi_hop_mix_leaves(xs, hops=hops, w_self=WC, w_side=WS)
        for x, g in zip(xs, got):
            assert g.shape == x.shape and torch.equal(g, _hops_plain(x, hops))
    counts = ops.launch_counts()
    assert counts["ring_mix"] == 1 and counts["multi_hop_mix"] == 3


@pytest.mark.parametrize("count,launches", [(1, 1), (16, 1), (17, 2)])
def test_cuda_grouped_launches_per_16_leaves(cuda, count, launches):
    gen = torch.Generator(device=cuda).manual_seed(count)
    xs = [torch.randn((20, 5 + j), generator=gen, device=cuda)
          for j in range(count)]
    ops.reset_launch_counts()
    one = ops.ring_mix_leaves(xs, w_self=WC, w_side=WS)
    three = ops.multi_hop_mix_leaves(xs, hops=3, w_self=WC, w_side=WS)
    counts = ops.launch_counts()
    assert counts["ring_mix"] == launches
    assert counts["multi_hop_mix"] == launches
    for x, o, t in zip(xs, one, three):
        assert torch.equal(o, _hops_plain(x, 1))
        assert torch.equal(t, _hops_plain(x, 3))
        assert o.is_contiguous() and o.data_ptr() % 16 == 0
    # every output is a view of one buffer
    assert len({o.untyped_storage().data_ptr() for o in one}) == 1


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


def _rel_err(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def test_cuda_stiefel_project_leaves_main_tree_one_launch(cuda):
    """The fair tree's two Stiefel leaves (fc1, head) in ONE launch, each
    within 1e-5 relative of the plain version, and the one-leaf entry
    gives the same numbers."""
    from repro_torch.kernels import stiefel_project as _sp
    gen = torch.Generator(device=cuda).manual_seed(2)
    shapes = [(20, 784, 64), (20, 64, 3)]
    assert [_sp.cluster_size(d, r) for _, d, r in shapes] == [4, 4]
    xs, gs = [], []
    for shape in shapes:
        x = torch.linalg.qr(torch.randn(shape, generator=gen, device=cuda))[0]
        xs.append(x)
        gs.append(0.5 * x + 0.1 * torch.randn(shape, generator=gen,
                                              device=cuda))
    ops.reset_launch_counts()
    got = ops.stiefel_project_leaves(xs, gs)
    assert ops.launch_counts()["stiefel_project"] == 1
    for x, g, out in zip(xs, gs, got):
        assert out.shape == x.shape
        assert _rel_err(out, ref.stiefel_project_ref(x, g)) <= 1e-5
        assert torch.equal(ops.stiefel_project(x, g), out)


# (batch, d, r): d a multiple of no tile; the last leaf's rows overflow a
# cluster's shared memory, so it streams
STIEFEL_RS = [(3, 313, 1), (3, 313, 3), (3, 313, 37), (3, 313, 64),
              (3, 409, 99), (3, 525, 128), (3, 1037, 256), (3, 5001, 64)]


@pytest.mark.parametrize("shape", STIEFEL_RS)
def test_cuda_stiefel_project_leaves_every_r(cuda, shape):
    """Each r on its route: one launch on chip (a cluster of 4 or 8 CTAs),
    two streaming (the tensor-core Gram and apply), within 1e-5 relative;
    and every leaf of the list in one grouped call."""
    from repro_torch.kernels import stiefel_project as _sp
    gen = torch.Generator(device=cuda).manual_seed(shape[2])
    x = torch.linalg.qr(torch.randn(shape, generator=gen, device=cuda))[0]
    g = 0.5 * x + 0.1 * torch.randn(shape, generator=gen, device=cuda)
    ctas = _sp.cluster_size(*shape[1:])
    assert (ctas in (4, 8)) == (shape[2] <= 128 and shape[1] < 5000)
    ops.reset_launch_counts()
    got = ops.stiefel_project_leaves([x], [g])[0]
    assert ops.launch_counts()["stiefel_project"] == (1 if ctas else 2)
    assert _rel_err(got, ref.stiefel_project_ref(x, g)) <= 1e-5


def test_cuda_stiefel_project_leaves_mixed_routes(cuda):
    """A group of every leaf above: one launch for the on-chip ones (all
    with the largest cluster any of them needs, so a leaf's sums may run
    in another order than in a call of its own), two for each streaming
    one, every output within 1e-5 relative of the plain version."""
    from repro_torch.kernels import stiefel_project as _sp
    gen = torch.Generator(device=cuda).manual_seed(9)
    xs = [torch.linalg.qr(torch.randn(s, generator=gen, device=cuda))[0]
          for s in STIEFEL_RS]
    gs = [0.5 * x + 0.1 * torch.randn(x.shape, generator=gen, device=cuda)
          for x in xs]
    streams = sum(_sp.cluster_size(*s[1:]) == 0 for s in STIEFEL_RS)
    ops.reset_launch_counts()
    got = ops.stiefel_project_leaves(xs, gs)
    assert ops.launch_counts()["stiefel_project"] == 1 + 2 * streams
    for x, g, out in zip(xs, gs, got):
        assert out.shape == x.shape
        assert _rel_err(out, ref.stiefel_project_ref(x, g)) <= 1e-5


def test_cuda_stiefel_project_streaming_stress(cuda):
    """(20, 4096, 256) streams through the 3xTF32 tensor-core route: two
    launches, 1e-5 relative."""
    from repro_torch.kernels import stiefel_project as _sp
    shape = (20, 4096, 256)
    assert _sp.cluster_size(*shape[1:]) == 0
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.linalg.qr(torch.randn(shape, generator=gen, device=cuda))[0]
    g = 0.5 * x + 0.1 * torch.randn(shape, generator=gen, device=cuda)
    ops.reset_launch_counts()
    got = ops.stiefel_project(x, g)
    assert ops.launch_counts()["stiefel_project"] == 2
    assert _rel_err(got, ref.stiefel_project_ref(x, g)) <= 1e-5
    got = ops.fused_retract(x, g)
    assert float((got - ref.fused_retract_ref(x, g)).abs().max()) <= 5e-5


@pytest.mark.parametrize("r,ctas", [(3, 1), (37, 4), (64, 4), (98, 8),
                                    (99, 8), (128, 8), (256, 8)])
def test_cuda_fused_retract_every_cluster_size(cuda, r, ctas):
    """The (r, r) stage on one block (r <= 32) or a cluster of 4 or 8 CTAs
    per node, across r = 98 / 99 (where six (r, r) fp32 matrices stop
    fitting one block's shared memory) up to the largest r taken, against
    the plain version (5e-5)."""
    from repro_torch.kernels import retract as _rt
    assert _rt.cluster_size(r) == ctas
    gen = torch.Generator(device=cuda).manual_seed(r)
    shape = (3, max(2 * r, 300), r)
    x = torch.linalg.qr(torch.randn(shape, generator=gen, device=cuda))[0]
    g = 0.5 * x + 0.1 * torch.randn(shape, generator=gen, device=cuda)
    ops.reset_launch_counts()
    got = ops.fused_retract(x, g)
    assert ops.launch_counts()["fused_retract"] == 1
    assert ops.route_launch_counts() == {"fused_retract_global": 0}
    assert float((got - ref.fused_retract_ref(x, g)).abs().max()) <= 5e-5
    # ns_iters = 0 and a single node take the same stages
    got = ops.fused_retract(x[:1], g[:1], ns_iters=0)
    want = ref.fused_retract_ref(x[:1], g[:1], ns_iters=0)
    assert float((got - want).abs().max()) <= 5e-5


@pytest.mark.parametrize("r", [257, 384, 576])
@pytest.mark.parametrize("nodes", [1, 8])
@pytest.mark.parametrize("ns_iters", [0, 20])
def test_cuda_fused_retract_global_route(cuda, r, nodes, ns_iters):
    """Above the cluster routes (r > 256) the (r, r) stage runs as
    tensor-core GEMMs over global memory (``cluster_size`` 0): r = 257 (one
    past the edge, 4-byte staging), 384, and 576 (smollm-135m's square
    leaves, d = r), against the plain version (5e-5), one counted launch a
    call, counted on the global route where it launches, bitwise repeats."""
    from repro_torch.kernels import retract as _rt
    assert _rt.cluster_size(r) == 0
    gen = torch.Generator(device=cuda).manual_seed(r + nodes)
    d = r if r == 576 else r + 43
    x = torch.linalg.qr(torch.randn((nodes, d, r), generator=gen,
                                    device=cuda))[0]
    g = 0.5 * x + 0.1 * torch.randn((nodes, d, r), generator=gen,
                                    device=cuda)
    ops.reset_launch_counts()
    got = ops.fused_retract(x, g, ns_iters=ns_iters)
    assert ops.launch_counts()["fused_retract"] == 1
    assert ops.route_launch_counts() == {"fused_retract_global": 1}
    want = ref.fused_retract_ref(x, g, ns_iters=ns_iters)
    assert float((got - want).abs().max()) <= 5e-5
    assert torch.equal(ops.fused_retract(x, g, ns_iters=ns_iters), got)


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


@pytest.mark.parametrize("n", [3, 20])
@pytest.mark.parametrize("with_base", [True, False])
def test_cuda_quant_mix_leaves_bitwise(cuda, n, with_base):
    """The grouped int8 hop of a ragged tree (char4 / float4 leaves and
    scalar ones, one base not 16-byte aligned), with the old public copies'
    exact hop fused in or without, in ONE launch: bitwise the chain it
    replaces (ring_mix_leaves of the bases, quant_mix per leaf, the add)
    and the plain version."""
    widths = [3, 72, 1152, 13, 50176, 1152]
    qs, ss = _quant_tree(cuda, n, widths, n + with_base)
    gen = torch.Generator(device=cuda).manual_seed(n)
    base = None
    if with_base:
        base = [torch.randn((n, f), generator=gen, device=cuda)
                for f in widths[:-1]]
        base.append(torch.randn(n * widths[-1] + 1, generator=gen,
                                device=cuda)[1:].view(n, widths[-1]))
        assert base[-1].data_ptr() % 16 != 0
    ops.reset_launch_counts()
    got = ops.quant_mix_leaves(qs, ss, base=base, w_self=WC, w_side=WS)
    assert ops.launch_counts()["quant_mix"] == 1
    chain = ops.ring_mix_leaves(base, w_self=WC, w_side=WS) if base else None
    for j, (q, s) in enumerate(zip(qs, ss)):
        plain = _quant_hop_plain(q, s)
        one = ops.quant_mix(q, s, w_self=WC, w_side=WS)
        assert torch.equal(one, plain)
        if base is not None:
            plain = ref.ring_mix_ref(base[j], base[j].roll(1, 0),
                                     base[j].roll(-1, 0), WC, WS) + plain
            one = chain[j] + one
        assert got[j].shape == q.shape
        assert torch.equal(got[j], one) and torch.equal(got[j], plain)


@pytest.mark.parametrize("count,launches", [(16, 1), (17, 2)])
def test_cuda_quant_mix_leaves_launches_per_16_leaves(cuda, count, launches):
    qs, ss = _quant_tree(cuda, 20, [5 + j for j in range(count)], count)
    base = [torch.ones(q.shape, device=cuda) for q in qs]
    ops.reset_launch_counts()
    got = ops.quant_mix_leaves(qs, ss, base=base, w_self=WC, w_side=WS)
    assert ops.launch_counts()["quant_mix"] == launches
    for q, s, g in zip(qs, ss, got):
        assert torch.equal(g, 1.0 + _quant_hop_plain(q, s))
    assert len({g.untyped_storage().data_ptr() for g in got}) == 1


def test_cuda_stacked_backend_fused_first_hop(cuda):
    """``StackedBackend.quant_ring_hop_leaves`` with a base: one launch for
    the tree, bitwise ``mix_hop`` of the base plus the int8 hop; on a
    2-node ring the base keeps ``mix_ring``'s expression."""
    for n in (20, 2):
        spec = GossipSpec(n_nodes=n)
        qs, ss = _quant_tree(cuda, n, QUANT_TREE, 30 + n)
        gen = torch.Generator(device=cuda).manual_seed(n)
        base = [torch.randn(q.shape, generator=gen, device=cuda) for q in qs]
        backend = StackedBackend()
        ops.reset_launch_counts()
        got = backend.quant_ring_hop_leaves(spec, qs, ss, base)
        assert ops.launch_counts()["quant_mix"] == 1
        mixed = backend.mix_hop(spec, base)
        for j, (q, s) in enumerate(zip(qs, ss)):
            want = mixed[j] + backend.quant_ring_hop(spec, q, s)
            assert torch.equal(got[j], want)


def test_cuda_grouped_wrappers_refuse_other_dtypes(cuda):
    x = torch.randn(4, 8, 2, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        ops.stiefel_project_leaves([x.float(), x], [x.float(), x])
    q = torch.zeros(4, 8, dtype=torch.int8, device=cuda)
    s = torch.ones(4, 1, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        ops.quant_mix_leaves([q], [s], base=[x[:, :, 0]], w_self=WC,
                             w_side=WS)
    with pytest.raises(TypeError, match="int8"):
        ops.quant_mix_leaves([q.float()], [s], w_self=WC, w_side=WS)


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


# the fair CNN's per-node leaf widths: y (and v), conv1, head, conv2, fc1
QUANT_TREE = [3, 72, 192, 1152, 50176]


def _quant_tree(cuda, n, widths, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    qs, ss = [], []
    for f in widths:
        q, s = quantize_det(torch.randn((n, f), generator=gen, device=cuda))
        qs.append(q)
        ss.append(s.reshape(n, 1))
    return qs, ss


def _quant_hops_oracle(q, s, hops):
    n = q.shape[0]
    return ref.multi_hop_mix_quant_ref(
        ref.ring_panel(q, hops), ref.ring_panel(s, hops), hops=hops,
        w_self=WC, w_side=WS)[hops:hops + n]


@pytest.mark.parametrize("hops", [1, 2, 3, 66])
def test_cuda_quant_hops_leaves_bitwise_one_launch(cuda, hops):
    """One launch for a mixed tree (the state on chip, one barrier a hop
    for all leaves), and each leaf alone (y: one block, no grid barrier):
    every leaf bitwise the plain version."""
    from repro_torch.kernels import multi_hop_mix as _mh
    n = 20
    qs, ss = _quant_tree(cuda, n, QUANT_TREE, hops)
    assert _mh.quant_onchip(torch.cuda.current_device(), n,
                            QUANT_TREE)
    ops.reset_launch_counts()
    got = ops.multi_hop_mix_quant_leaves(qs, ss, hops=hops, w_self=WC,
                                         w_side=WS)
    assert ops.launch_counts()["multi_hop_mix_quant"] == 1
    for q, s, g in zip(qs, ss, got):
        assert torch.equal(g, _quant_hops_oracle(q, s, hops))
        assert torch.equal(ops.multi_hop_mix_quant(q, s, hops=hops, w_self=WC,
                                                   w_side=WS), g)
    assert ops.launch_counts()["multi_hop_mix_quant"] == 1 + len(qs)


@pytest.mark.parametrize("n,widths", [
    (20, [3, 1 << 18]),          # past the resident grid: blocks shared out
    (40, [3, 72, 1152, 5000]),   # more rows than the on-chip route keeps
])
def test_cuda_quant_hops_leaves_global_route(cuda, n, widths):
    from repro_torch.kernels import multi_hop_mix as _mh
    assert not _mh.quant_onchip(torch.cuda.current_device(), n, widths)
    qs, ss = _quant_tree(cuda, n, widths, n)
    for hops in (1, 2, 7):
        ops.reset_launch_counts()
        got = ops.multi_hop_mix_quant_leaves(qs, ss, hops=hops, w_self=WC,
                                             w_side=WS)
        assert ops.launch_counts()["multi_hop_mix_quant"] == 1
        for q, s, g in zip(qs, ss, got):
            assert torch.equal(g, _quant_hops_oracle(q, s, hops)), hops


def test_cuda_quant_ring_hops_leaves_is_the_plain_schedule(cuda):
    """The backend's tree call == hop by hop quantize_det + quant_mix on
    each leaf, the JAX package's stacked schedule."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    spec = GossipSpec(n_nodes=20)
    xs = [torch.randn(shape, generator=gen, device=cuda) for shape in
          [(20, 8, 1, 3, 3), (20, 16, 8, 3, 3), (20, 784, 64), (20, 64, 3)]]
    ops.reset_launch_counts()
    got = StackedBackend().quant_ring_hops_leaves(spec, xs, 9)
    assert ops.launch_counts()["multi_hop_mix_quant"] == 1
    for x, g in zip(xs, got):
        z = x
        for _ in range(9):
            q, s = quantize_det(z)
            z = _quant_hop_plain(q.reshape(20, -1),
                                 s.reshape(20, 1)).reshape(x.shape)
        assert torch.equal(g, z)


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


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_GATE = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # b, s, t, h, hkv, hd, hdv, causal, window
    (1, 256, 256, 9, 3, 64, 64, True, None),     # smollm prefill
    (2, 1, 288, 9, 3, 64, 64, True, None),       # contiguous decode
    (1, 96, 160, 4, 4, 16, 16, True, None),      # ragged edges
    (1, 64, 64, 4, 2, 32, 16, True, None),       # hd_v != hd
    (1, 128, 128, 4, 1, 32, 32, True, 48),       # window + MQA
    (1, 64, 80, 4, 4, 32, 32, False, None),      # non-causal
    (1, 40, 40, 2, 1, 256, 256, True, None),     # the largest head dims
    (1, 200, 232, 4, 2, 128, 128, True, None),   # hd 128, keys split in 2
    (2, 33, 97, 4, 4, 128, 64, False, None),     # hd 128, hdv 64
    (1, 1024, 1024, 2, 1, 64, 64, True, None),   # causal S=T=1024
    (1, 70, 90, 4, 2, 40, 24, True, None),       # not multiples of 16
    # the served configurations (src/repro_torch/configs)
    (1, 256, 256, 32, 8, 128, 128, True, None),  # granite-3-8b, GQA 4
    (1, 256, 256, 32, 8, 64, 64, True, None),    # granite-3-2b, GQA 4
    (1, 256, 256, 16, 8, 64, 64, True, None),    # granite-moe, GQA 2
    (4, 32, 32, 32, 32, 64, 64, True, None),     # musicgen, GQA 1
    (2, 1536, 1536, 32, 16, 128, 128, True, 1024),  # gemma3 local
    (2, 1, 1552, 32, 16, 128, 128, True, None),  # gemma3 global decode
    (1, 24, 24, 8, 2, 20, 20, True, None),       # granite-3-8b SMOKE
    (1, 24, 24, 8, 2, 16, 16, True, None),       # granite-3-2b SMOKE
    (2, 13, 13, 4, 2, 32, 32, True, 8),          # gemma3 SMOKE
    # MLA (q/k head dim != v head dim) and cross-attention (not causal)
    (4, 256, 256, 128, 128, 192, 128, True, None),  # deepseek prefill, SIMT
    (4, 1, 272, 128, 128, 192, 128, True, None),    # deepseek decode
    (2, 13, 13, 4, 4, 48, 32, True, None),          # deepseek SMOKE
    (2, 512, 1600, 32, 8, 128, 128, False, None),   # llama-vision cross
    (2, 1, 1600, 32, 8, 128, 128, False, None),     # its decode
    (2, 13, 16, 4, 2, 32, 32, False, None),         # llama-vision SMOKE
    # zamba2-2.7b: head dim 80 (tensor cores), 32:32
    (2, 1000, 1000, 32, 32, 80, 80, True, None),    # zamba2 prefill
    (2, 1, 1015, 32, 32, 80, 80, True, None),       # zamba2 decode
])
def test_cuda_flash_attention_vs_plain(cuda, case, dtype):
    """Both routes of the kernel, chosen by shape: the tensor cores for
    head dims that are multiples of 16 up to 128, the SIMT kernel
    otherwise."""
    from repro_torch.kernels import flash_attention as _fa
    b, s, t, h, hkv, hd, hdv, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(s + t)
    q = torch.randn((b, s, h, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, t, hkv, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, t, hkv, hdv), generator=gen, device=cuda).to(dtype)
    qpos = torch.arange(t - s, t, dtype=torch.int32,
                        device=cuda).expand(b, s)
    tc = hd % 16 == 0 and hdv % 16 == 0 and max(hd, hdv) <= 128
    assert _fa.route(q, k, v) == ("tensor_core" if tc else "simt")
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              q_positions=qpos)
    assert ops.launch_counts()["flash_attention"] == 1
    want = ref.blockwise_attention(q, k, v, causal=causal, window=window,
                                   q_positions=qpos)
    assert got.dtype == dtype and got.shape == (b, s, h, hdv)
    assert float((got.float() - want.float()).abs().max()) <= ATTN_GATE[dtype]


@pytest.mark.parametrize("case", [
    # b, s, t, h, hkv, causal
    (1, 256, 256, 9, 3, True),       # smollm prefill
    (1, 1024, 1024, 2, 1, True),     # causal S=T=1024
])
def test_cuda_flash_attention_bf16_large_outputs(cuda, case):
    """bf16 on the tensor cores with every output in [4, 8), under the
    2e-2 gate, against the reference's fp32 arithmetic on the same bf16
    inputs.  There one bf16 ulp is 2^-5: the output's own rounding costs
    up to 2^-6 = 0.0156, which leaves 0.0044 for the kernel.  Rounding P
    (or the scaled q) to bf16 moves the output by about |out| * 2^-10 and
    fails here; the rounded reference is no yardstick, since two roundings
    of values a hair apart differ by a whole ulp."""
    b, s, t, h, hkv, causal = case
    gen = torch.Generator(device=cuda).manual_seed(s)
    q = torch.randn((b, s, h, 64), generator=gen, device=cuda)
    k = torch.randn((b, t, hkv, 64), generator=gen, device=cuda)
    v = 6.0 + 1.9 * torch.rand((b, t, hkv, 64), generator=gen, device=cuda)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    qpos = torch.arange(t - s, t, dtype=torch.int32,
                        device=cuda).expand(b, s)
    got = ops.flash_attention(q, k, v, causal=causal, q_positions=qpos)
    want = ref.blockwise_attention(q.float(), k.float(), v.float(),
                                   causal=causal, q_positions=qpos)
    assert 4.0 <= float(want.min()) and float(want.max()) < 8.0
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want).abs().max()) <= ATTN_GATE[torch.bfloat16]


def test_cuda_flash_rows_without_keys_are_exact_zeros(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((1, 256, 9, 64), generator=gen, device=cuda)
               for _ in range(3))
    k, v = k[:, :, :3], v[:, :, :3]
    pos = torch.arange(256, dtype=torch.int32, device=cuda)[None]
    kvpos = torch.where(pos < 64, -1, pos)          # rows 0..63 see nothing
    got = ops.flash_attention(q, k, v, q_positions=pos, kv_positions=kvpos)
    want = ref.blockwise_attention(q, k, v, q_positions=pos,
                                   kv_positions=kvpos)
    assert torch.all(got[:, :64] == 0)
    assert float((got - want).abs().max()) <= 2e-5


def _paged_inputs(cuda, dtype, seq, g, m, ps=16, hkv=3, hd=64, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    s = len(seq)
    n_pages = s * m + 1
    q = torch.randn((s, hkv * g, hd), generator=gen, device=cuda).to(dtype)
    kp = torch.randn((n_pages, ps, hkv, hd), generator=gen,
                     device=cuda).to(dtype)
    vp = torch.randn((n_pages, ps, hkv, hd), generator=gen,
                     device=cuda).to(dtype)
    bt = torch.full((s, m), -1, dtype=torch.int32)
    order = torch.randperm(n_pages - 1, generator=torch.Generator()
                           .manual_seed(seed)) + 1
    used = 0
    for i, sl in enumerate(seq):
        n = -(-sl // ps)
        bt[i, :n] = order[used:used + n]
        used += n
    return (q, kp, vp, bt.to(cuda),
            torch.tensor(seq, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,window", [(3, None), (1, None), (3, 48), (2, 5)])
def test_cuda_paged_decode_vs_plain(cuda, dtype, g, window):
    q, kp, vp, bt, seq = _paged_inputs(cuda, dtype, [288, 37, 0, 161, 1, 16],
                                       g, m=18)
    ops.reset_launch_counts()
    got = ops.paged_decode_attention(q, kp, vp, bt, seq, window=window)
    assert ops.launch_counts()["paged_decode"] == 1
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, seq, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.all(got[2] == 0)                   # the empty slot
    assert float((got.float() - want.float()).abs().max()) <= ATTN_GATE[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 100, 37])
def test_cuda_paged_decode_split_edges(cuda, dtype, window):
    """The split over each slot's keys (64-token chunks of 16-token pages):
    seq_lens on a chunk edge, one token, a full table row, an empty slot,
    one key either side of an edge; windows that start inside a chunk."""
    seq = [64, 128, 1, 288, 0, 65, 63, 200]
    q, kp, vp, bt, sl = _paged_inputs(cuda, dtype, seq, 3, m=18, seed=4)
    ops.reset_launch_counts()
    got = ops.paged_decode_attention(q, kp, vp, bt, sl, window=window)
    assert ops.launch_counts()["paged_decode"] == 1
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, sl, window=window)
    assert torch.all(got[4] == 0)
    assert float((got.float() - want.float()).abs().max()) <= ATTN_GATE[dtype]


@pytest.mark.parametrize("g,hkv,hd", [(4, 8, 64), (4, 8, 128), (2, 8, 64)])
def test_cuda_paged_decode_at_served_shapes(cuda, g, hkv, hd):
    """The paged models' decode waves (granite-3-2b, granite-3-8b,
    granite-moe-1b-a400m: 4 slots, one empty), fp32."""
    q, kp, vp, bt, seq = _paged_inputs(cuda, torch.float32,
                                       [288, 37, 0, 161], g, m=18, hkv=hkv,
                                       hd=hd)
    got = ops.paged_decode_attention(q, kp, vp, bt, seq)
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, seq)
    assert torch.all(got[2] == 0)
    assert float((got - want).abs().max()) <= ATTN_GATE[torch.float32]


def test_cuda_flash_attention_wrapped_ring_cache(cuda):
    """gemma3's local-layer decode: one query at position 1551 against a
    ring of 1024 slots that has wrapped (slot j holds the newest position
    p = j mod 1024), window 1024, fp32."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((2, 1, 32, 128), generator=gen, device=cuda)
    k, v = (torch.randn((2, 1024, 16, 128), generator=gen, device=cuda)
            for _ in range(2))
    slots = torch.arange(1024, dtype=torch.int32, device=cuda)
    kvpos = torch.where(slots + 1024 <= 1551, slots + 1024, slots)
    kvpos = kvpos.expand(2, 1024).contiguous()
    qpos = torch.full((2, 1), 1551, dtype=torch.int32, device=cuda)
    kw = dict(window=1024, q_positions=qpos, kv_positions=kvpos)
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.blockwise_attention(q, k, v, **kw)
    assert float((got - want).abs().max()) <= ATTN_GATE[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_decode_64_slots_of_2048(cuda, dtype):
    """The stress shape of chip_smoke.py at reduced width (one kv head of
    two query heads, hd 32): 32 chunks per slot, 64 slots."""
    q, kp, vp, bt, sl = _paged_inputs(cuda, dtype, [2048] * 64, 2, m=128,
                                      hkv=1, hd=32, seed=5)
    got = ops.paged_decode_attention(q, kp, vp, bt, sl)
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, sl)
    assert float((got.float() - want.float()).abs().max()) <= ATTN_GATE[dtype]


def test_cuda_paged_decode_is_deterministic_and_resets_its_tickets(cuda):
    """The combine merges the partials in chunk order: two calls give the
    same bits.  Its last blocks reset the tickets to 0, so a call after a
    call on the same buffer is right."""
    from repro_torch.kernels import paged_decode as _pd
    q, kp, vp, bt, sl = _paged_inputs(cuda, torch.float32,
                                      [288, 37, 0, 161, 1, 16], 3, m=18)
    first = ops.paged_decode_attention(q, kp, vp, bt, sl)
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream().cuda_stream
    tickets = _pd._TICKETS[(cuda.index or 0, stream)]
    assert int(tickets.abs().sum()) == 0
    second = ops.paged_decode_attention(q, kp, vp, bt, sl)
    assert torch.equal(first, second)
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, sl)
    assert float((second - want).abs().max()) <= ATTN_GATE[torch.float32]
    assert int(tickets.abs().sum()) == 0


def test_cuda_attention_wrappers_refuse_other_dtypes(cuda):
    x = torch.zeros(1, 8, 4, 16, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(x, x, x)
    with pytest.raises(TypeError, match="float32"):
        ops.flash_attention(x.float(), x.float(), x.half())
    q, kp, vp, bt, seq = _paged_inputs(cuda, torch.float32, [5], 1, m=2)
    with pytest.raises(TypeError, match="int32"):
        ops.paged_decode_attention(q, kp, vp, bt.long(), seq)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.paged_decode_attention(q.double(), kp.double(), vp.double(), bt,
                                   seq)
    with pytest.raises(ValueError, match="head dims up to 256"):
        big = torch.zeros(1, 4, 2, 288, device=cuda)
        ops.flash_attention(big, big, big)


# ---------------------------------------------------------------------------
# the attention backward kernel (csrc/flash_attention_bwd.cu)
# ---------------------------------------------------------------------------

BWD_GATE = 1e-5     # relative to the largest |plain| value of dq, dk, dv


@pytest.mark.parametrize("case", [
    # b, s, t, h, hkv, hd, hdv, causal, window, empty keys
    (32, 63, 63, 9, 3, 64, 64, True, None, 0),    # the trainer's shape
    (2, 100, 100, 9, 3, 64, 64, True, 16, 0),     # a window
    (2, 37, 130, 9, 3, 64, 48, True, None, 0),    # S != T, hdv != hd
    (2, 64, 64, 6, 2, 32, 32, True, None, 20),    # kv -1, rows without keys
    (2, 50, 70, 4, 4, 64, 64, False, None, 0),    # non-causal
    (1, 70, 70, 4, 1, 128, 128, True, None, 0),   # the largest head dims
    (8, 15, 15, 4, 4, 48, 32, True, None, 0),     # MLA at SMOKE (tensor)
    (2, 37, 45, 4, 2, 40, 24, True, None, 0),     # hdv != hd, SIMT
    (8, 15, 16, 4, 2, 32, 32, False, None, 0),    # cross at SMOKE, S != T
    (1, 256, 1600, 32, 8, 128, 128, False, None, 0),  # cross, llama widths
    (2, 37, 61, 4, 2, 40, 24, False, None, 0),    # cross, SIMT
    (16, 63, 63, 32, 32, 80, 80, True, None, 0),  # zamba2 training, hd 80
])
def test_cuda_flash_attention_backward_vs_plain(cuda, case):
    from repro_torch.kernels import flash_attention as _fa
    b, s, t, h, hkv, hd, hdv, causal, window, empty = case
    gen = torch.Generator(device=cuda).manual_seed(s + t)
    q = torch.randn((b, s, h, hd), generator=gen, device=cuda)
    k = torch.randn((b, t, hkv, hd), generator=gen, device=cuda)
    v = torch.randn((b, t, hkv, hdv), generator=gen, device=cuda)
    qpos = torch.arange(s, dtype=torch.int32, device=cuda).expand(b, s)
    kpos = torch.arange(t, dtype=torch.int32, device=cuda)
    kpos = torch.where(kpos < empty, -1, kpos).expand(b, t)
    kw = dict(causal=causal, window=window, q_positions=qpos,
              kv_positions=kpos)
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    d_out = torch.randn(out.shape, generator=gen, device=cuda)
    ops.reset_launch_counts()
    got = ops.flash_attention_backward(q, k, v, out, d_out, lse=lse, **kw)
    route = _fa.backward_route(q, k, v, out, d_out)
    assert ops.backward_launch_counts() == {
        "flash_attention_bwd": _fa.backward_launches(route, h, hkv)}
    want = ref.attention_backward(q, k, v, out, d_out, **kw)
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= BWD_GATE * scale
    again = ops.flash_attention_backward(q, k, v, out, d_out, lse=lse, **kw)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.parametrize("hd", [32, 64, 128, 40])
@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("window", [None, 24])
def test_cuda_flash_attention_backward_routes(cuda, hd, group, window):
    """Both routes of the backward kernel at odd S and T (77 queries, 93
    keys, the first 5 keys empty): the tensor-core route at head dims 32,
    64 and 128, the SIMT route at 40; GQA groups 1 and 3; causal, with or
    without a window of 24.  The forward's lse (``return_lse``) within
    1e-5 of the plain one where a row has keys; the gradient with that lse
    handed in (as autograd does: no forward launch) within 1e-5 relative
    of the plain version, rows and keys without a usable partner exact
    zeros, bitwise the same on a repeat."""
    from repro_torch.kernels import flash_attention as _fa
    b, s, t, hkv = 2, 77, 93, 2
    h = hkv * group
    gen = torch.Generator(device=cuda).manual_seed(hd + group)
    q = torch.randn((b, s, h, hd), generator=gen, device=cuda)
    k = torch.randn((b, t, hkv, hd), generator=gen, device=cuda)
    v = torch.randn((b, t, hkv, hd), generator=gen, device=cuda)
    kpos = torch.arange(t, dtype=torch.int32, device=cuda)
    kpos = torch.where(kpos < 5, -1, kpos).expand(b, t)
    kw = dict(causal=True, window=window, kv_positions=kpos)
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    want_lse = ref.attention_lse(q, k, **kw)
    assert float((lse - want_lse)[:, :, 5:].abs().max()) <= \
        1e-5 * float(want_lse[:, :, 5:].abs().max())
    d_out = torch.randn(out.shape, generator=gen, device=cuda)
    assert _fa.backward_route(q, k, v, out, d_out) == (
        "simt" if hd == 40 else "tensor_core")
    ops.reset_launch_counts()
    got = ops.flash_attention_backward(q, k, v, out, d_out, lse=lse, **kw)
    assert ops.backward_launch_counts() == {"flash_attention_bwd": (
        3 if hd != 40 and group > 1 else 2)}
    assert ops.launch_counts()["flash_attention"] == 0
    want = ref.attention_backward(q, k, v, out, d_out, **kw)
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= BWD_GATE * scale
    assert bool(torch.all(got[0][:, :5] == 0))
    assert bool(torch.all(got[1][:, :5] == 0) and torch.all(got[2][:, :5] == 0))
    again = ops.flash_attention_backward(q, k, v, out, d_out, lse=lse, **kw)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


def test_cuda_vmapped_grad_runs_the_kernels(cuda):
    """vmap(grad) over a node axis through ops.flash_attention: the forward
    and backward kernels see the folded batch, and the gradients are the
    per-node plain ones."""
    from torch.func import grad, vmap
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((3, 2, 40, 9, 64), generator=gen, device=cuda)
    k = torch.randn((3, 2, 40, 3, 64), generator=gen, device=cuda)
    v = torch.randn((3, 2, 40, 3, 64), generator=gen, device=cuda)
    w = torch.randn((3, 2, 40, 9, 64), generator=gen, device=cuda)

    def loss(q, k, v, w):
        return (ops.flash_attention(q, k, v) * w).sum()

    ops.reset_launch_counts()
    got = vmap(grad(loss, argnums=(0, 1, 2)))(q, k, v, w)
    assert ops.launch_counts()["flash_attention"] == 1
    # the tensor-core route under GQA 9:3: dq, dk/dv per head, the group sum
    assert ops.backward_launch_counts() == {"flash_attention_bwd": 3}
    for i in range(3):
        out = ref.blockwise_attention(q[i], k[i], v[i])
        want = ref.attention_backward(q[i], k[i], v[i], out, w[i])
        scale = max(float(x.abs().max()) for x in want)
        for g, x in zip(got, want):
            assert float((g[i] - x).abs().max()) <= BWD_GATE * scale


def test_cuda_flash_attention_backward_refuses_bf16(cuda):
    x = torch.zeros((1, 8, 2, 16), device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 8), device=cuda)
    with pytest.raises(TypeError, match="float32 only"):
        ops.flash_attention_backward(x, x, x, x, x, lse=lse)
