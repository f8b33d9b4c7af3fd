"""The LM trainer of the port on the MoE configurations, held against the
JAX trainer on the CPU at ``SMOKE``: 3 DRSGDA steps on a 4-node ring
within 1e-5 (``tests/_torch_lm_parity.py``).

* granite-moe-1b-a400m: ``"moe_attn"`` blocks, the routed experts'
  capacity dispatch batched under ``torch.func.vmap(grad)`` over the
  nodes, the router's auxiliary loss in the robust loss;
* deepseek-v2-236b: MLA attention (q/k head dim 48, v head dim 32 at
  ``SMOKE``) through the attention gradient, a dense layer, then MoE with
  a shared expert; MLA's ``w_dq``, ``w_dkv`` and ``wo`` on the Stiefel
  manifold, under the default polar retraction and under
  ``"polar_fused"`` (``ops.fused_retract``; its 128 x 48 ``w_dkv``).

The cases share one file: pytest-xdist's ``loadfile`` queues files by
their number of tests, so one-test files would run last, as the suite's
tail.
"""
from __future__ import annotations

import math

import pytest

jax = pytest.importorskip("jax")

import _torch_lm_parity as lp  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401


@pytest.mark.parametrize("arch, retraction", [
    ("granite-moe-1b-a400m", "polar"),
    ("deepseek-v2-236b", "polar"),
    ("deepseek-v2-236b", "polar_fused")])
def test_moe_trainer_matches_the_reference(arch, retraction):
    m = lp.check_trainer(arch, retraction=retraction)
    assert math.isfinite(float(m.loss))
