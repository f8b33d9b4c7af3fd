"""The port's kernels against the JAX package's oracles and Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held here against ``repro.kernels.ref`` (run eagerly, one rounded operation
at a time) and against the Pallas kernels in interpret mode, on the same
NumPy inputs.  Tolerances:

* ring_mix / multi_hop_mix, one leaf or a grouped tree
  (``ring_mix_leaves`` / ``multi_hop_mix_leaves``, and the stacked
  backend's ``mix`` over a tree): bitwise against the eager oracles.  Under
  ``jit`` XLA:CPU contracts ``wc*x + ws*(l+r)`` into one FMA, so the
  Pallas-interpret results differ by the rounding of one product per hop;
  the ring hop is non-expansive in the max norm, so the difference stays
  within ``hops * eps32 * max|x|`` (``_fma_bound``).
* stiefel_project, one leaf or a grouped tree (``stiefel_project_leaves``,
  and ``geometry.tangent_project_tree``): 1e-6 absolute at unit-scale
  inputs.
* fused_retract: 5e-5 against ``retract_polar(..., method="eigh")`` (the
  JAX package's own gate) and against its Pallas kernel (ns_iters = 20
  pinned, so no tuned config applies).
* quant_mix / multi_hop_mix_quant, one leaf or a grouped tree
  (``quant_mix_leaves``, with the old public copies' exact hop fused in or
  without; ``multi_hop_mix_quant_leaves``, and the stacked backend's
  ``quant_ring_hops_leaves``): bitwise against the eager oracles (for the
  fused hop, the JAX package's eager ``mix_ring`` plus its oracle) and
  against the JAX package's stacked hop-by-hop ``quant_ring_hops`` run
  eagerly.  Against the Pallas kernels in interpret mode (jitted, so the
  combine may be FMA-contracted): quant_mix within one rounding of its
  products, multi_hop_mix_quant within one int8 step (``max|out| / 127``,
  the JAX package's own gate for its kernel), since a value that moves by
  one rounding can requantize one step apart.
* flash_attention / paged_decode_attention (plain versions): 2e-5
  absolute in fp32 and 2e-2 in bf16, the JAX package's own gates, against
  the Pallas kernels in interpret mode on every query row, and against the
  JAX oracles (``attention_naive``, ``paged_decode_attention_ref``) on rows
  with at least one usable key: where a row has none, the Pallas kernels
  and the port give exact zeros, the JAX oracle the mean of the values.

The CUDA kernels themselves are tested in ``test_torch_cuda.py``.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.comms import compress as jcompress  # noqa: E402
from repro.comms.backend import StackedBackend as JStacked  # noqa: E402
from repro.core.gossip import GossipSpec as JGossip  # noqa: E402
from repro.geometry import stiefel as jst  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import paged_decode as jpd  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.comms import compress  # noqa: E402
from repro_torch.comms.backend import StackedBackend as TStacked  # noqa: E402
from repro_torch.core.gossip import GossipSpec as TGossip  # noqa: E402
from repro_torch.kernels import leaves, ops, ref  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

WC, WS = 1.0 / 3.0, 1.0 / 3.0
EPS32 = float(np.finfo(np.float32).eps)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(t):
    return t.detach().cpu().numpy()


def _fma_bound(x, hops):
    return hops * EPS32 * float(np.abs(x).max())


def _stiefel_pair(rng, shape):
    x = np.linalg.qr(rng.normal(size=shape))[0].astype(np.float32)
    g = (0.5 * x + 0.1 * rng.normal(size=shape)).astype(np.float32)
    return x, g


# ---------------------------------------------------------------------------
# ring mixes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 5), (4, 16, 8), (20, 3), (7, 1)])
@pytest.mark.parametrize("w", [(WC, WS), (0.4, 0.3)])
def test_ring_mix_bitwise_vs_oracle(shape, w):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    l, r = np.roll(x, 1, 0), np.roll(x, -1, 0)
    want = np.asarray(jref.ring_mix_ref(jnp.asarray(x), jnp.asarray(l),
                                        jnp.asarray(r), *w))
    got = _np(ops.ring_mix(_t(x), w_self=w[0], w_side=w[1]))
    np.testing.assert_array_equal(got, want)
    got3 = _np(ref.ring_mix_ref(_t(x), _t(l), _t(r), *w))
    np.testing.assert_array_equal(got3, want)
    pallas = np.asarray(jops.ring_mix(
        jnp.asarray(x), jnp.asarray(l), jnp.asarray(r), w_self=w[0],
        w_side=w[1], impl="pallas_interpret"))
    assert np.abs(got - pallas).max() <= _fma_bound(x, 1)


@pytest.mark.parametrize("n,f,hops", [(3, 7, 1), (5, 33, 3), (4, 16, 9),
                                      (20, 8, 23)])
def test_multi_hop_mix_bitwise_vs_oracle(n, f, hops):
    """k hops of the node-stacked ring == the JAX package's halo-panel
    oracle on the wrapped panel == k single hops, bit for bit (k > n too)."""
    rng = np.random.default_rng(n * f + hops)
    x = rng.normal(size=(n, f)).astype(np.float32)
    panel = x[(np.arange(n + 2 * hops) - hops) % n]
    want = np.asarray(jref.multi_hop_mix_ref(
        jnp.asarray(panel), hops=hops, out_rows=n, halo=hops, w_self=WC,
        w_side=WS))
    got = _np(ops.multi_hop_mix(_t(x), hops=hops, w_self=WC, w_side=WS))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_np(ref.ring_panel(_t(x), hops)), panel)
    z = _t(x)
    for _ in range(hops):
        z = ops.ring_mix(z, w_self=WC, w_side=WS)
    np.testing.assert_array_equal(got, _np(z))
    pallas = np.asarray(jops.multi_hop_mix(
        jnp.asarray(panel), hops=hops, out_rows=n, halo=hops, w_self=WC,
        w_side=WS, impl="pallas_interpret"))
    assert np.abs(got - pallas).max() <= _fma_bound(x, hops)


@pytest.mark.parametrize("b,halo,hops", [(4, 3, 3), (6, 5, 2)])
def test_halo_panel_oracle_bitwise(b, halo, hops):
    """The port's panel oracle keeps the JAX package's interface."""
    rng = np.random.default_rng(b + halo)
    panel = rng.normal(size=(b + 2 * halo, 40)).astype(np.float32)
    kw = dict(hops=hops, out_rows=b, halo=halo, w_self=0.4, w_side=0.3)
    want = np.asarray(jref.multi_hop_mix_ref(jnp.asarray(panel), **kw))
    np.testing.assert_array_equal(_np(ref.multi_hop_mix_ref(_t(panel), **kw)),
                                  want)


# a ragged tree of the main path's kinds: y / v, conv1, conv2 (as its flat
# leaf and with its conv dims), an odd width
RAGGED = [(3,), (72,), (1152,), (1001,), (16, 8, 3, 3)]


@pytest.mark.parametrize("n", [3, 20])
@pytest.mark.parametrize("hops", [1, 3, 67])
def test_grouped_ring_mixes_bitwise_vs_oracle(n, hops):
    """``ring_mix_leaves`` / ``multi_hop_mix_leaves`` on a ragged tree ==
    the one-leaf wrappers == the JAX package's eager oracles (the one-hop
    combine, and the halo-panel oracle on the wrapped panel), bit for bit."""
    rng = np.random.default_rng(100 * n + hops)
    xs = [rng.normal(size=(n, *s)).astype(np.float32) for s in RAGGED]
    got = ops.multi_hop_mix_leaves([_t(x) for x in xs], hops=hops,
                                   w_self=WC, w_side=WS)
    assert [g.shape for g in got] == [x.shape for x in xs]
    for x, g in zip(xs, got):
        np.testing.assert_array_equal(_np(g), _np(ops.multi_hop_mix(
            _t(x), hops=hops, w_self=WC, w_side=WS)))
    # the oracle is column by column, so one call on the leaves' columns
    # side by side holds every leaf (one eager run, not one per leaf)
    flat = np.concatenate([x.reshape(n, -1) for x in xs], axis=1)
    panel = flat[(np.arange(n + 2 * hops) - hops) % n]
    want = np.asarray(jref.multi_hop_mix_ref(
        jnp.asarray(panel), hops=hops, out_rows=n, halo=hops, w_self=WC,
        w_side=WS))
    np.testing.assert_array_equal(
        np.concatenate([_np(g).reshape(n, -1) for g in got], axis=1), want)
    if hops == 1:
        one = ops.ring_mix_leaves([_t(x) for x in xs], w_self=WC, w_side=WS)
        for x, g, o in zip(xs, got, one):
            want = np.asarray(jref.ring_mix_ref(
                jnp.asarray(x), jnp.asarray(np.roll(x, 1, 0)),
                jnp.asarray(np.roll(x, -1, 0)), WC, WS))
            np.testing.assert_array_equal(_np(o), want)
            np.testing.assert_array_equal(
                _np(ops.ring_mix(_t(x), w_self=WC, w_side=WS)), want)
            np.testing.assert_array_equal(_np(g), want)


@pytest.mark.parametrize("n", [2, 3, 20])
@pytest.mark.parametrize("steps", [1, 3, 67])
def test_stacked_backend_mix_bitwise_vs_jax(n, steps):
    """The port's ``StackedBackend.mix`` over a nested tree (one grouped
    call for its leaves; ``mix_ring`` for the two-node ring) == the JAX
    package's ``StackedBackend.mix`` run eagerly, bit for bit."""
    rng = np.random.default_rng(10 * n + steps)
    tree = {"w": [rng.normal(size=(n, 8, 1, 3, 3)).astype(np.float32),
                  rng.normal(size=(n, 1001)).astype(np.float32)],
            "y": rng.normal(size=(n, 3)).astype(np.float32)}
    got = TStacked().mix(TGossip(n_nodes=n), {
        "w": [_t(a) for a in tree["w"]], "y": _t(tree["y"])}, steps)
    with jax.disable_jit():
        want = JStacked().mix(JGossip(n_nodes=n), {
            "w": [jnp.asarray(a) for a in tree["w"]],
            "y": jnp.asarray(tree["y"])}, steps)
    for g, w in zip(got["w"] + [got["y"]], want["w"] + [want["y"]]):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_grouped_outputs_share_one_aligned_buffer():
    """The grouped launches' outputs: one allocation, each leaf a
    contiguous view of its own shape at a 16-byte-aligned offset (the
    kernels' float4 paths)."""
    xs = [torch.zeros(s) for s in [(3, 3), (3, 5, 2), (3, 1), (3, 8)]]
    outs = leaves.outputs(xs)
    assert [o.shape for o in outs] == [x.shape for x in xs]
    assert all(o.is_contiguous() for o in outs)
    assert [o.storage_offset() for o in outs] == [0, 12, 44, 48]
    assert len({o.untyped_storage().data_ptr() for o in outs}) == 1


@pytest.mark.parametrize("op", [
    lambda xs: ops.ring_mix_leaves(xs, w_self=WC, w_side=WS),
    lambda xs: ops.multi_hop_mix_leaves(xs, hops=3, w_self=WC, w_side=WS)])
@pytest.mark.parametrize("xs,match", [
    ([], "non-empty list"),
    ([torch.zeros(4, 3), torch.zeros(5, 3)], "leaves of 4 and 5 nodes"),
    ([torch.zeros(4, 3), torch.zeros(4, 3, device="meta")],
     "different devices")])
def test_grouped_operand_checks(op, xs, match):
    with pytest.raises(ValueError, match=match):
        op(xs)


# ---------------------------------------------------------------------------
# int8 compressed ring mixes
# ---------------------------------------------------------------------------


def _payload(rng, shape):
    """A deterministic int8 payload of a random leaf, from both packages."""
    x = rng.normal(size=shape).astype(np.float32)
    q, s = compress.quantize_det(_t(x))
    jq, js = jcompress.quantize_det(jnp.asarray(x))
    np.testing.assert_array_equal(_np(q), np.asarray(jq))
    return x, q, s


@pytest.mark.parametrize("shape", [(3, 5), (4, 16, 8), (20, 3), (7, 1),
                                   (2, 9)])
@pytest.mark.parametrize("w", [(WC, WS), (0.4, 0.3)])
def test_quant_mix_bitwise_vs_oracle(shape, w):
    x, q, s = _payload(np.random.default_rng(sum(shape)), shape)
    n = shape[0]
    q2, s2 = _np(q).reshape(n, -1), _np(s).reshape(n, 1)
    args = [jnp.asarray(a) for a in (q2, np.roll(q2, 1, 0), np.roll(q2, -1, 0),
                                     s2, np.roll(s2, 1, 0), np.roll(s2, -1, 0))]
    want = np.asarray(jref.quant_mix_ref(*args, *w)).reshape(shape)
    got = _np(ops.quant_mix(q, s, w_self=w[0], w_side=w[1]))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _np(ref.quant_mix_ref(*(torch.from_numpy(np.array(a))
                                for a in args), *w)).reshape(shape), want)
    pallas = np.asarray(jops.quant_mix(*args, w_self=w[0], w_side=w[1],
                                       impl="pallas_interpret"))
    assert np.abs(got.reshape(n, -1) - pallas).max() <= \
        2 * EPS32 * np.abs(want).max()


# a tree of payload widths: the fair CNN's y / v, conv1 and an odd width
# (the kernel's scalar path), and widths of four (its char4 / float4 path)
QUANT_WIDTHS = [3, 72, 13, 1152, 8]


@pytest.mark.parametrize("n", [3, 5, 20])
@pytest.mark.parametrize("with_base", [True, False])
def test_quant_mix_leaves_bitwise_vs_eager_mix_ring_plus_oracle(n, with_base):
    """The grouped int8 hop of a tree, with the old public copies' exact
    hop fused in (``base``) or without, == the JAX package's eager
    ``mix_ring(hat) + quant_mix_ref`` (the first hop of its engine), bit
    for bit, leaf by leaf; and == the port's own chain (ring_mix_leaves of
    the bases, quant_mix per leaf, then the sum)."""
    from repro.core import gossip as jgossip
    rng = np.random.default_rng(n + 7 * with_base)
    qs, ss, hats = [], [], []
    for f in QUANT_WIDTHS:
        _, q, s = _payload(rng, (n, f))
        qs.append(q)
        ss.append(s.reshape(n, 1))
        hats.append(rng.normal(size=(n, f)).astype(np.float32))
    base = [_t(h) for h in hats] if with_base else None
    got = ops.quant_mix_leaves(qs, ss, base=base, w_self=WC, w_side=WS)
    chain = ops.ring_mix_leaves(base, w_self=WC, w_side=WS) if with_base \
        else None
    for j, (q, s, h) in enumerate(zip(qs, ss, hats)):
        q2, s2 = _np(q), _np(s)
        args = [jnp.asarray(a) for a in (q2, np.roll(q2, 1, 0),
                                         np.roll(q2, -1, 0), s2,
                                         np.roll(s2, 1, 0), np.roll(s2, -1, 0))]
        with jax.disable_jit():
            want = jref.quant_mix_ref(*args, WC, WS)
            if with_base:
                want = jgossip.mix_ring(jnp.asarray(h), steps=1,
                                        self_weight=WC) + want
        assert got[j].dtype == torch.float32 and got[j].shape == q.shape
        np.testing.assert_array_equal(_np(got[j]), np.asarray(want))
        one = ops.quant_mix(q, s, w_self=WC, w_side=WS)
        if with_base:
            one = chain[j] + one
        assert torch.equal(got[j], one)


def test_quant_mix_leaves_operand_checks():
    q = torch.zeros(3, 5, dtype=torch.int8)
    s = torch.ones(3, 1)
    with pytest.raises(ValueError, match="non-empty lists"):
        ops.quant_mix_leaves([], [], w_self=WC, w_side=WS)
    with pytest.raises(ValueError, match="non-empty lists"):
        ops.quant_mix_leaves([q, q], [s], w_self=WC, w_side=WS)
    with pytest.raises(ValueError, match="non-empty lists"):
        ops.quant_mix_leaves([q], [s], base=[torch.zeros(3, 5)] * 2,
                             w_self=WC, w_side=WS)
    with pytest.raises(ValueError, match="nodes in one call"):
        ops.quant_mix_leaves([q, torch.zeros(4, 5, dtype=torch.int8)],
                             [s, torch.ones(4, 1)], w_self=WC, w_side=WS)
    with pytest.raises(ValueError, match="one scale per node"):
        ops.quant_mix_leaves([q], [torch.ones(2, 1)], w_self=WC, w_side=WS)
    with pytest.raises(ValueError, match="a base of 3 nodes and 15"):
        ops.quant_mix_leaves([q], [s], base=[torch.zeros(3, 4)], w_self=WC,
                             w_side=WS)
    with pytest.raises(ValueError, match="different devices"):
        ops.quant_mix_leaves([q], [s], base=[torch.zeros(3, 5, device="meta")],
                             w_self=WC, w_side=WS)
    # more leaves than one launch takes: the plain version has no limit
    out = ops.quant_mix_leaves([q] * (leaves.MAX_LEAVES + 1),
                               [s] * (leaves.MAX_LEAVES + 1),
                               base=[torch.ones(3, 5)] * (leaves.MAX_LEAVES + 1),
                               w_self=WC, w_side=WS)
    assert len(out) == leaves.MAX_LEAVES + 1
    assert all(torch.equal(o, torch.ones(3, 5)) for o in out)


@pytest.mark.parametrize("n,f,hops", [(3, 7, 1), (5, 33, 3), (4, 16, 9),
                                      (6, 130, 4), (20, 8, 23)])
def test_multi_hop_mix_quant_vs_reference(n, f, hops):
    """k int8 hops of the node-stacked ring == the JAX package's stacked
    hop-by-hop schedule (eager) == its halo-panel oracle on the wrapped
    panel, bit for bit (k > n too); within one int8 step of its Pallas
    kernel."""
    x, q, s = _payload(np.random.default_rng(n * f + hops), (n, f))
    got = _np(ops.multi_hop_mix_quant(q, s, hops=hops, w_self=WC, w_side=WS))
    with jax.disable_jit():
        stacked = np.asarray(JStacked().quant_ring_hops(
            JGossip(n_nodes=n), jnp.asarray(x), hops))
    np.testing.assert_array_equal(got, stacked)
    idx = (np.arange(n + 2 * hops) - hops) % n
    qp, sp = _np(q)[idx], _np(s)[idx]
    oracle = np.asarray(jref.multi_hop_mix_quant_ref(
        jnp.asarray(qp), jnp.asarray(sp), hops=hops, w_self=WC,
        w_side=WS))[hops:hops + n]
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(_np(ref.multi_hop_mix_quant_ref(
        torch.from_numpy(qp), torch.from_numpy(sp), hops=hops, w_self=WC,
        w_side=WS))[hops:hops + n], oracle)
    pallas = np.asarray(jops.multi_hop_mix_quant(
        jnp.asarray(qp), jnp.asarray(sp), hops=hops, out_rows=n, halo=hops,
        w_self=WC, w_side=WS, impl="pallas_interpret"))
    assert np.abs(got - pallas).max() <= np.abs(got).max() / 127.0


# a mixed tree of the fair CNN's leaf widths per node: y / head's rows,
# conv1, head, conv2 and a wider fc1 stand-in
QUANT_TREE = [(3,), (8, 1, 3, 3), (64, 3), (16, 8, 3, 3), (300,)]


@pytest.mark.parametrize("n,hops", [(5, 1), (5, 2), (4, 3), (6, 9)])
def test_multi_hop_mix_quant_leaves_vs_halo_oracle(n, hops):
    """The grouped int8 all-hop entry == the JAX package's halo-panel
    oracle on each leaf's wrapped panel and its stacked hop-by-hop
    schedule (eager), bit for bit, leaf by leaf; nothing launches on the
    CPU."""
    rng = np.random.default_rng(100 * n + hops)
    xs, qs, ss = [], [], []
    for shape in QUANT_TREE:
        x, q, s = _payload(rng, (n, *shape))
        xs.append(x)
        qs.append(q)
        ss.append(s)
    ops.reset_launch_counts()
    got = ops.multi_hop_mix_quant_leaves(qs, ss, hops=hops, w_self=WC,
                                         w_side=WS)
    assert ops.launch_counts()["multi_hop_mix_quant"] == 0
    assert len(got) == len(qs)
    for x, q, s, g in zip(xs, qs, ss, got):
        assert g.shape == q.shape and g.dtype == torch.float32
        f = x.size // n
        idx = (np.arange(n + 2 * hops) - hops) % n
        oracle = np.asarray(jref.multi_hop_mix_quant_ref(
            jnp.asarray(_np(q).reshape(n, f)[idx]),
            jnp.asarray(_np(s).reshape(n, 1)[idx]), hops=hops, w_self=WC,
            w_side=WS))[hops:hops + n]
        np.testing.assert_array_equal(_np(g).reshape(n, f), oracle)
        with jax.disable_jit():
            stacked = np.asarray(JStacked().quant_ring_hops(
                JGossip(n_nodes=n), jnp.asarray(x), hops))
        np.testing.assert_array_equal(_np(g), stacked)
        np.testing.assert_array_equal(
            _np(g), _np(ops.multi_hop_mix_quant(q, s, hops=hops, w_self=WC,
                                                w_side=WS)))


def test_stacked_backend_quant_ring_hops_leaves_vs_jax():
    """The backend's tree call == the JAX package's stacked schedule leaf
    by leaf (eager), fp32 in, each leaf's shape and dtype out."""
    n, steps = 5, 4
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(n, *s)).astype(np.float32) for s in QUANT_TREE]
    got = TStacked().quant_ring_hops_leaves(TGossip(n_nodes=n),
                                            [_t(x) for x in xs], steps)
    for x, g in zip(xs, got):
        with jax.disable_jit():
            want = np.asarray(JStacked().quant_ring_hops(
                JGossip(n_nodes=n), jnp.asarray(x), steps))
        assert g.shape == x.shape
        np.testing.assert_array_equal(_np(g), want)
    same = TStacked().quant_ring_hops_leaves(TGossip(n_nodes=n),
                                             [_t(xs[0])], 0)
    np.testing.assert_array_equal(_np(same[0]), xs[0])


def test_multi_hop_mix_quant_leaves_operand_checks():
    q = torch.zeros(3, 5, dtype=torch.int8)
    s = torch.ones(3, 1)
    with pytest.raises(ValueError, match="hops"):
        ops.multi_hop_mix_quant_leaves([q], [s], hops=0, w_self=WC,
                                       w_side=WS)
    with pytest.raises(ValueError, match="lists"):
        ops.multi_hop_mix_quant_leaves([q, q], [s], hops=2, w_self=WC,
                                       w_side=WS)
    with pytest.raises(ValueError, match="lists"):
        ops.multi_hop_mix_quant_leaves([], [], hops=2, w_self=WC, w_side=WS)
    with pytest.raises(ValueError, match="nodes in one call"):
        ops.multi_hop_mix_quant_leaves(
            [q, torch.zeros(4, 5, dtype=torch.int8)], [s, torch.ones(4, 1)],
            hops=2, w_self=WC, w_side=WS)
    with pytest.raises(ValueError, match="one scale per node"):
        ops.multi_hop_mix_quant_leaves([q, q], [s, torch.ones(2, 1)], hops=2,
                                       w_self=WC, w_side=WS)


# ---------------------------------------------------------------------------
# Stiefel projection and fused retraction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(40, 6), (3, 64, 3), (2, 130, 17)])
def test_stiefel_project_vs_oracle(shape):
    x, g = _stiefel_pair(np.random.default_rng(len(shape)), shape)
    got = _np(ops.stiefel_project(_t(x), _t(g)))
    want = np.asarray(jref.stiefel_project_ref(jnp.asarray(x), jnp.asarray(g)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    pallas = np.asarray(jops.stiefel_project(jnp.asarray(x), jnp.asarray(g),
                                             impl="pallas_interpret"))
    np.testing.assert_allclose(got, pallas, atol=1e-6)


# one tree of Stiefel leaves: the fair head leaf, fc1 at a narrow width, an
# unbatched leaf and a ragged one
STIEFEL_TREE = [(3, 64, 3), (4, 48, 8), (40, 6), (2, 130, 17)]


def test_stiefel_project_leaves_vs_oracle_and_pallas():
    """The grouped projection of a tree, leaf by leaf, against the JAX
    oracle and its Pallas kernel in interpret mode (1e-6), and equal to the
    one-leaf entry."""
    rng = np.random.default_rng(3)
    pairs = [_stiefel_pair(rng, shape) for shape in STIEFEL_TREE]
    got = ops.stiefel_project_leaves([_t(x) for x, _ in pairs],
                                     [_t(g) for _, g in pairs])
    assert len(got) == len(pairs)
    for (x, g), out in zip(pairs, got):
        assert out.shape == x.shape
        want = np.asarray(jref.stiefel_project_ref(jnp.asarray(x),
                                                   jnp.asarray(g)))
        np.testing.assert_allclose(_np(out), want, atol=1e-6)
        pallas = np.asarray(jops.stiefel_project(
            jnp.asarray(x), jnp.asarray(g), impl="pallas_interpret"))
        np.testing.assert_allclose(_np(out), pallas, atol=1e-6)
        assert torch.equal(out, ops.stiefel_project(_t(x), _t(g)))


def test_stiefel_project_leaves_operand_checks():
    x = torch.zeros(3, 5, 2)
    with pytest.raises(ValueError, match="non-empty lists"):
        ops.stiefel_project_leaves([], [])
    with pytest.raises(ValueError, match="non-empty lists"):
        ops.stiefel_project_leaves([x, x], [x])
    with pytest.raises(ValueError, match="matching"):
        ops.stiefel_project_leaves([x, x], [x, torch.zeros(3, 5, 3)])
    with pytest.raises(ValueError, match="different devices"):
        ops.stiefel_project_leaves([x, x], [x, torch.zeros(3, 5, 2,
                                                           device="meta")])
    # more leaves than one launch takes: the plain version has no limit
    xs = [torch.linalg.qr(torch.randn(2, 7, 2))[0]] * (leaves.MAX_LEAVES + 1)
    out = ops.stiefel_project_leaves(xs, xs)
    assert len(out) == len(xs)
    assert all(float(o.abs().max()) < 1e-6 for o in out)


def test_tangent_project_tree_groups_each_geometry(monkeypatch):
    """``tangent_project_tree`` sends every Stiefel leaf of a tree through
    ONE ``stiefel_project_leaves`` call and leaves the Euclidean leaves to
    their own projection; the result equals the leaf-by-leaf one."""
    from repro_torch.geometry import as_manifold_map, tangent_project_tree
    calls = []
    grouped = ops.stiefel_project_leaves

    def spy(xs, gs):
        calls.append(len(xs))
        return grouped(xs, gs)

    monkeypatch.setattr(ops, "stiefel_project_leaves", spy)
    rng = np.random.default_rng(5)
    mmap = as_manifold_map({"conv": "euclidean", "fc1": "stiefel",
                            "head": "stiefel"})
    x, g = {}, {}
    for key, shape in (("conv", (3, 4, 2)), ("fc1", (3, 12, 6)),
                       ("head", (3, 6, 3))):
        xk, gk = _stiefel_pair(rng, shape)
        x[key], g[key] = _t(xk), _t(gk)
    got = tangent_project_tree(mmap, x, g)
    assert calls == [2] and list(got) == list(x)
    for key in x:
        assert torch.equal(got[key],
                           mmap[key].tangent_project(x[key], g[key]))


# (1, 300, 264): an r above the CUDA kernel's cluster routes (r <= 256),
# which its global route takes on the card
@pytest.mark.parametrize("shape", [(40, 6), (3, 64, 3), (2, 130, 17),
                                   (1, 300, 264)])
def test_fused_retract_vs_eigh_polar_and_pallas(shape):
    x, g = _stiefel_pair(np.random.default_rng(7 + len(shape)), shape)
    got = _np(ops.fused_retract(_t(x), _t(g), ns_iters=20))
    xj, gj = jnp.asarray(x), jnp.asarray(g)
    eigh = np.asarray(jst.retract_polar(xj, jst.tangent_project(xj, gj),
                                        method="eigh"))
    np.testing.assert_allclose(got, eigh, atol=5e-5)
    pallas = np.asarray(jops.fused_retract(xj, gj, ns_iters=20, block_d=128,
                                           impl="pallas_interpret"))
    np.testing.assert_allclose(got, pallas, atol=5e-5)
    np.testing.assert_allclose(
        _np(ref.fused_retract_ref(_t(x), _t(g))),
        np.asarray(jref.fused_retract_ref(xj, gj, ns_iters=20)), atol=1e-6)


# ---------------------------------------------------------------------------
# dispatch: CPU -> plain version; anything else but CUDA raises
# ---------------------------------------------------------------------------


def test_cpu_calls_launch_nothing():
    ops.reset_launch_counts()
    x = torch.linalg.qr(torch.randn(2, 12, 3))[0]
    ops.stiefel_project(x, x)
    ops.stiefel_project_leaves([x, x], [x, x])
    ops.fused_retract(x, x)
    ops.ring_mix(x, w_self=WC, w_side=WS)
    ops.multi_hop_mix(x, hops=2, w_self=WC, w_side=WS)
    q, s = compress.quantize_det(x)
    ops.quant_mix(q, s, w_self=WC, w_side=WS)
    ops.quant_mix_leaves([q, q], [s, s], base=[x, x], w_self=WC, w_side=WS)
    ops.multi_hop_mix_quant(q, s, hops=3, w_self=WC, w_side=WS)
    ops.flash_attention(x[None], x[None], x[None])
    ops.paged_decode_attention(x, x[None], x[None],
                               torch.zeros(2, 1, dtype=torch.int32),
                               torch.ones(2, dtype=torch.int32))
    assert ops.launch_counts() == {"stiefel_project": 0, "fused_retract": 0,
                                   "ring_mix": 0, "multi_hop_mix": 0,
                                   "quant_mix": 0, "multi_hop_mix_quant": 0,
                                   "flash_attention": 0, "paged_decode": 0}


@pytest.mark.parametrize("call", [
    lambda x: ops.ring_mix(x, w_self=WC, w_side=WS),
    lambda x: ops.multi_hop_mix(x, hops=3, w_self=WC, w_side=WS),
    lambda x: ops.stiefel_project(x, x),
    lambda x: ops.stiefel_project_leaves([x, x], [x, x]),
    lambda x: ops.fused_retract(x, x),
    lambda x: ops.quant_mix(x.to(torch.int8), x[:, :1, :1], w_self=WC,
                            w_side=WS),
    lambda x: ops.multi_hop_mix_quant(x.to(torch.int8), x[:, 0, 0], hops=2,
                                      w_self=WC, w_side=WS),
    lambda x: ops.quant_mix_leaves([x.to(torch.int8)], [x[:, 0, 0]],
                                   base=[x], w_self=WC, w_side=WS),
    lambda x: ops.flash_attention(x[None], x[None], x[None]),
    lambda x: ops.paged_decode_attention(
        x, x[None], x[None], torch.zeros(4, 1, dtype=torch.int32,
                                         device=x.device),
        torch.ones(4, dtype=torch.int32, device=x.device)),
])
def test_no_silent_fallback_for_other_devices(call):
    with pytest.raises(ValueError, match="no kernel for device meta"):
        call(torch.empty(4, 6, 2, device="meta"))


def test_operand_checks():
    x = torch.zeros(3, 5, 2)
    with pytest.raises(ValueError, match="matching"):
        ops.stiefel_project(x, torch.zeros(3, 5, 3))
    with pytest.raises(ValueError, match="different devices"):
        ops.fused_retract(x, torch.zeros(3, 5, 2, device="meta"))
    with pytest.raises(ValueError, match="hops"):
        ops.multi_hop_mix(x, hops=0, w_self=WC, w_side=WS)
    with pytest.raises(ValueError, match="node-stacked"):
        ops.ring_mix(torch.zeros(0, 4), w_self=WC, w_side=WS)
    q = torch.zeros(3, 5, dtype=torch.int8)
    with pytest.raises(ValueError, match="one scale per node"):
        ops.quant_mix(q, torch.ones(2, 1), w_self=WC, w_side=WS)
    with pytest.raises(ValueError, match="hops"):
        ops.multi_hop_mix_quant(q, torch.ones(3, 1), hops=0, w_self=WC,
                                w_side=WS)


# ---------------------------------------------------------------------------
# attention: flash (prefill / contiguous decode) and paged decode
# ---------------------------------------------------------------------------

ATTN_CASES = [   # tests/test_kernels.py ATTN_CASES, dtypes by name
    # b, s, t, h, hkv, hd, hdv, causal, window, dtype
    (1, 128, 128, 4, 4, 32, 32, True, None, "float32"),
    (2, 64, 64, 8, 2, 64, 64, True, None, "float32"),
    (1, 128, 128, 4, 1, 32, 32, True, 48, "float32"),     # window + MQA
    (2, 1, 256, 8, 2, 64, 64, True, None, "float32"),     # decode
    (1, 96, 160, 4, 4, 16, 16, True, None, "float32"),    # ragged
    (1, 64, 64, 4, 2, 32, 16, True, None, "float32"),     # hd_v != hd_k
    (1, 64, 64, 4, 4, 32, 32, False, None, "float32"),    # non-causal
    (1, 64, 64, 4, 4, 32, 32, True, None, "bfloat16"),    # bf16
]


def _attn_gate(dtype: str) -> float:
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _as(x, dtype: str):
    """One fp32 NumPy array as the JAX and the port tensors of ``dtype``
    (both round fp32 to bf16 to nearest even: the same bits)."""
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _flash_pair(q, k, v, qpos, kvpos, causal, window, dtype):
    """(port plain version, JAX Pallas kernel in interpret mode, JAX
    naive oracle) on the same inputs, as fp32 NumPy."""
    jq, tq = _as(q, dtype)
    jk, tk = _as(k, dtype)
    jv, tv = _as(v, dtype)
    jpos = [None if p is None else jnp.asarray(p) for p in (qpos, kvpos)]
    tpos = [None if p is None else torch.from_numpy(p) for p in (qpos, kvpos)]
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                              q_positions=tpos[0], kv_positions=tpos[1])
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  q_positions=jpos[0], kv_positions=jpos[1],
                                  impl="pallas_interpret", block_q=32,
                                  block_kv=64)
    naive = jref.attention_naive(jq, jk, jv, causal=causal, window=window,
                                 q_positions=jpos[0], kv_positions=jpos[1])
    naive_port = ref.attention_naive(tq, tk, tv, causal=causal,
                                     window=window, q_positions=tpos[0],
                                     kv_positions=tpos[1])
    return _f32(got), _f32(pallas), _f32(naive), _f32(naive_port)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_vs_pallas_and_oracle(case):
    b, s, t, h, hkv, hd, hdv, causal, window, dtype = case
    rng = np.random.default_rng(abs(hash(case[:9])) % 2 ** 31)
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, t, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, t, hkv, hdv)).astype(np.float32)
    qpos = (np.broadcast_to(np.arange(t - s, t, dtype=np.int32), (b, s))
            .copy() if s < t else None)
    got, pallas, naive, naive_port = _flash_pair(q, k, v, qpos, None, causal,
                                                 window, dtype)
    gate = _attn_gate(dtype)
    assert got.shape == (b, s, h, hdv)
    np.testing.assert_allclose(got, pallas, atol=gate)
    np.testing.assert_allclose(got, naive, atol=gate)   # every row has keys
    np.testing.assert_allclose(naive_port, naive, atol=gate)


def test_flash_attention_ring_cache_positions():
    """Ring-buffer cache: kv positions out of order still mask rightly."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(1, 1, 2, 16)).astype(np.float32)
    k = rng.normal(size=(1, 64, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, 64, 2, 16)).astype(np.float32)
    kvpos = np.roll(np.arange(64, 128, dtype=np.int32)[None], 7, axis=1)
    qpos = np.full((1, 1), 127, np.int32)
    got, pallas, naive, _ = _flash_pair(q, k, v, qpos, kvpos, True, None,
                                        "float32")
    np.testing.assert_allclose(got, pallas, atol=2e-5)
    np.testing.assert_allclose(got, naive, atol=2e-5)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _flash_bf16_arithmetic(q, k, v, p_split: bool, block: int = 64):
    """The CUDA kernel's bf16 tensor-core arithmetic on one causal head,
    emulated on the CPU in fp32 (q, k, v hold bf16 values): exp2 of
    scores in log2 units, the online softmax over key tiles of ``block``,
    l summing the unrounded P.  ``p_split``: q raw with the scale on the
    fp32 scores and P as bf16 high + residual (the kernel's); else the
    scaled q and P each rounded once to bf16.  Returns the bf16 output."""
    s_len, hd = q.shape
    qs = hd ** -0.5 * 1.4426950408889634
    scores = (q @ k.T) * qs if p_split else _bf16(q * qs) @ k.T
    pos = torch.arange(s_len)
    scores = scores.masked_fill(pos[None, :] > pos[:, None], -math.inf)
    m = torch.full((s_len,), -1e30)
    l = torch.zeros(s_len)
    acc = torch.zeros(s_len, v.shape[1])
    for t0 in range(0, s_len, block):
        sc = scores[:, t0:t0 + block]
        m_new = torch.maximum(m, sc.max(1).values)
        corr = torch.exp2(m - m_new)
        prob = torch.exp2(sc - m_new[:, None])
        l = l * corr + prob.sum(1)
        hi = _bf16(prob)
        used = hi + _bf16(prob - hi) if p_split else hi
        acc = acc * corr[:, None] + used @ v[t0:t0 + block]
        m = m_new
    return _bf16(acc / l[:, None])


def test_bf16_flash_arithmetic_needs_the_p_split_for_large_outputs():
    """With every output in [4, 8), one bf16 rounding of P (and of the
    scaled q) puts the result past the 2e-2 gate against the reference's
    fp32 arithmetic; q raw and P as high + residual keep it at the
    output's own half ulp (2^-6).  The reason for the CUDA kernel's bf16
    arithmetic; the kernel itself is held to this on the card
    (test_torch_cuda.py)."""
    rng = np.random.default_rng(0)
    worst = {True: 0.0, False: 0.0}
    for _ in range(3):
        q = _bf16(torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32)))
        k = _bf16(torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32)))
        v = _bf16(torch.from_numpy(
            (6.0 + 1.9 * rng.random((256, 64))).astype(np.float32)))
        want = ref.blockwise_attention(q[None, :, None], k[None, :, None],
                                       v[None, :, None])[0, :, 0]
        assert 4.0 <= float(want.min()) and float(want.max()) < 8.0
        for split in worst:
            got = _flash_bf16_arithmetic(q, k, v, split)
            worst[split] = max(worst[split],
                               float((got - want).abs().max()))
    assert worst[True] <= 2 ** -6 + 1e-4 < 2e-2 < worst[False]


def test_flash_attention_rows_without_keys_are_zero():
    """Query rows with no usable key (their keys lie ahead or are empty):
    exact zeros, as the Pallas kernel gives; the others as the oracle."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(1, 8, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, 16, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, 16, 2, 16)).astype(np.float32)
    kvpos = np.concatenate([np.full(8, -1), np.arange(8, 16)])[None] \
        .astype(np.int32)
    qpos = np.arange(4, 12, dtype=np.int32)[None]
    got, pallas, naive, naive_port = _flash_pair(q, k, v, qpos, kvpos, True,
                                                 None, "float32")
    empty = qpos[0] < 8
    assert not np.any(got[:, empty]) and not np.any(naive_port[:, empty])
    np.testing.assert_allclose(got, pallas, atol=2e-5)
    np.testing.assert_allclose(got[:, ~empty], naive[:, ~empty], atol=2e-5)
    assert np.abs(naive[:, empty]).max() > 0.01    # the oracle's mean


def _paged_case(seed=0, s=5, hkv=2, g=1, hd=32, ps=8, m=6):
    """tests/test_serve.py's paged case, as NumPy."""
    rng = np.random.default_rng(seed)
    n_pages = s * m + 1
    q = rng.normal(size=(s, hkv * g, hd)).astype(np.float32)
    kp = rng.normal(size=(n_pages, ps, hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(n_pages, ps, hkv, hd)).astype(np.float32)
    seq = np.array([1, 7, 13, 0, min(m * ps, 40)][:s], np.int32)
    bt = np.full((s, m), -1, np.int32)
    nxt = 1
    for i, sl in enumerate(seq):
        for j in range(-(-int(sl) // ps)):
            bt[i, j] = nxt
            nxt += 1
    return q, kp, vp, bt, seq


def _paged_port(q, kp, vp, bt, seq, window=None):
    return ops.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(seq), window=window).numpy()


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("window", [None, 5])
def test_paged_decode_vs_pallas_and_oracle(g, window):
    q, kp, vp, bt, seq = _paged_case(g=g)
    got = _paged_port(q, kp, vp, bt, seq, window)
    s, h, hd = q.shape
    hkv = kp.shape[2]
    pallas = np.asarray(jpd.paged_decode_shgd(
        jnp.asarray(q).reshape(s, hkv, g, hd), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(bt), jnp.asarray(seq), window=window,
        interpret=True)).reshape(s, h, hd)
    oracle = np.asarray(jref.paged_decode_attention_ref(
        *map(jnp.asarray, (q, kp, vp, bt, seq)), window=window))
    np.testing.assert_allclose(got, pallas, atol=2e-5)
    np.testing.assert_allclose(got, oracle, atol=2e-5)


def test_paged_decode_empty_slot_zeros():
    q, kp, vp, bt, seq = _paged_case()
    assert seq[3] == 0
    got = _paged_port(q, kp, vp, bt, seq)
    pallas = np.asarray(jops.paged_decode_attention(
        *map(jnp.asarray, (q, kp, vp, bt, seq)), impl="pallas_interpret"))
    assert not np.any(got[3]) and not np.any(pallas[3])


def test_paged_decode_ragged_table():
    """A table width the JAX kernel's pages_per_block=2 does not divide
    (its wrapper pads with -1 columns); the port walks the pages as they
    are."""
    q, kp, vp, bt, seq = _paged_case(m=5)
    got = _paged_port(q, kp, vp, bt, seq)
    pallas = np.asarray(jops.paged_decode_attention(
        *map(jnp.asarray, (q, kp, vp, bt, seq)), impl="pallas_interpret",
        pages_per_block=2))
    np.testing.assert_allclose(got, pallas, atol=2e-5)


def test_attention_operand_checks():
    x = torch.zeros(1, 4, 6, 8)
    with pytest.raises(ValueError, match=r"with Hkv \| H"):
        ops.flash_attention(x, torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 4, 8))
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(x, x, x, window=0)
    q, kp, vp, bt, seq = map(torch.from_numpy, _paged_case())
    with pytest.raises(ValueError, match="block_table"):
        ops.paged_decode_attention(q, kp, vp, bt[:2], seq)


@pytest.mark.parametrize("m_pages,page_size", [
    (18, 16), (128, 16), (1, 16), (12, 4), (5, 24), (3, 100), (7, 64),
    (9, 1)])
def test_paged_decode_split_plan_covers_every_key_once(m_pages, page_size):
    """The CUDA kernel's split of each (slot, kv head)'s keys: chunk c holds
    positions [c * chunk, (c + 1) * chunk).  Every position of a table row
    lies in exactly one chunk, no chunk starts past the row (so none
    reaches into another slot's), chunks are whole pages where a page fits
    in one, and no chunk exceeds the kernel's 64 keys."""
    from repro_torch.kernels import paged_decode as _pd
    chunk, n_chunks = _pd.split_plan(m_pages, page_size)
    keys = m_pages * page_size
    assert 1 <= chunk <= _pd.CHUNK_KEYS
    if page_size <= _pd.CHUNK_KEYS:
        assert chunk % page_size == 0
    covered = np.zeros(keys, np.int64)
    for c in range(n_chunks):
        assert c * chunk < keys
        covered[c * chunk:min((c + 1) * chunk, keys)] += 1
    assert np.all(covered == 1)
