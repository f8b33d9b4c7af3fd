"""The port's kernels against the JAX package's oracles and Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held here against ``repro.kernels.ref`` (run eagerly, one rounded operation
at a time) and against the Pallas kernels in interpret mode, on the same
NumPy inputs.  Tolerances:

* ring_mix / multi_hop_mix: bitwise against the eager oracles.  Under
  ``jit`` XLA:CPU contracts ``wc*x + ws*(l+r)`` into one FMA, so the
  Pallas-interpret results differ by the rounding of one product per hop;
  the ring hop is non-expansive in the max norm, so the difference stays
  within ``hops * eps32 * max|x|`` (``_fma_bound``).
* stiefel_project: 1e-6 absolute at unit-scale inputs.
* fused_retract: 5e-5 against ``retract_polar(..., method="eigh")`` (the
  JAX package's own gate) and against its Pallas kernel (ns_iters = 20
  pinned, so no tuned config applies).
* quant_mix / multi_hop_mix_quant: bitwise against the eager oracles and
  against the JAX package's stacked hop-by-hop ``quant_ring_hops`` run
  eagerly.  Against the Pallas kernels in interpret mode (jitted, so the
  combine may be FMA-contracted): quant_mix within one rounding of its
  products, multi_hop_mix_quant within one int8 step (``max|out| / 127``,
  the JAX package's own gate for its kernel), since a value that moves by
  one rounding can requantize one step apart.

The CUDA kernels themselves are tested in ``test_torch_cuda.py``.
"""
from __future__ import annotations

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
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.comms import compress  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

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


@pytest.mark.parametrize("shape", [(40, 6), (3, 64, 3), (2, 130, 17)])
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
    ops.fused_retract(x, x)
    ops.ring_mix(x, w_self=WC, w_side=WS)
    ops.multi_hop_mix(x, hops=2, w_self=WC, w_side=WS)
    q, s = compress.quantize_det(x)
    ops.quant_mix(q, s, w_self=WC, w_side=WS)
    ops.multi_hop_mix_quant(q, s, hops=3, w_self=WC, w_side=WS)
    assert ops.launch_counts() == {"stiefel_project": 0, "fused_retract": 0,
                                   "ring_mix": 0, "multi_hop_mix": 0,
                                   "quant_mix": 0, "multi_hop_mix_quant": 0}


@pytest.mark.parametrize("call", [
    lambda x: ops.ring_mix(x, w_self=WC, w_side=WS),
    lambda x: ops.multi_hop_mix(x, hops=3, w_self=WC, w_side=WS),
    lambda x: ops.stiefel_project(x, x),
    lambda x: ops.fused_retract(x, x),
    lambda x: ops.quant_mix(x.to(torch.int8), x[:, :1, :1], w_self=WC,
                            w_side=WS),
    lambda x: ops.multi_hop_mix_quant(x.to(torch.int8), x[:, 0, 0], hops=2,
                                      w_self=WC, w_side=WS),
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
