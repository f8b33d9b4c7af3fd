"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``apply_moe``, from the same NumPy weights and tokens.

Cases: granite-moe-1b-a400m's ``SMOKE`` spec (4 experts, top-2, no token
dropped), a capacity factor at which tokens are dropped (asserted),
``dispatch_groups`` of -1 (one group per sequence) and 2, and one shared
expert.  Output and auxiliary loss within 1e-5 (fp32 GEMMs and the k
expert outputs of a token summed in another order); the chosen experts
equal (random fp32 router logits make ties improbable; the smallest gap
between the k-th and the next probability is printed, so a tie that ever
decides a case shows).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = 1e-5
B, S = 2, 12


def _smoke():
    cfg = configs.get_config("granite-moe-1b-a400m", smoke=True)
    return cfg, cfg.stages[0].blocks[0].moe


CASES = {
    "smoke": {},
    "dropping": {"capacity_factor": 0.5},
    "per_sequence": {"dispatch_groups": -1, "capacity_factor": 0.75},
    "two_groups": {"dispatch_groups": 2, "capacity_factor": 0.75},
    "shared": {"n_shared": 1},
}


def _weights(cfg, spec, seed=0):
    """The MoE leaves of ``convert.lm_params_from_seed``'s first block."""
    block = dataclasses.replace(cfg.stages[0].blocks[0], moe=spec)
    one = dataclasses.replace(cfg, stages=configs.uniform_stages(block, 1))
    return convert.lm_params_from_seed(one, seed)["stages"]["s0"]["b0"]["moe"]


def _dropped(params, x, spec) -> int:
    """(token, choice) pairs over capacity, summed over dispatch groups."""
    t = x.shape[0] * x.shape[1]
    g = x.shape[0] if spec.dispatch_groups == -1 else spec.dispatch_groups
    groups = x.reshape(g, t // g, -1) if g > 1 else x.reshape(1, t, -1)
    out = 0
    for xg in groups:
        _, _, idx = moe.route(params, xg, spec)
        load = torch.bincount(idx.reshape(-1), minlength=spec.n_experts)
        out += int(torch.clamp(load - moe.capacity(xg.shape[0], spec),
                               min=0).sum())
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_moe_matches_reference(case):
    cfg, spec = _smoke()
    spec = dataclasses.replace(spec, **CASES[case])
    jspec = jbase.MoESpec(**dataclasses.asdict(spec))
    raw = _weights(cfg, spec)
    x = np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    params = convert.tree_from_reference(raw, "cpu")
    y, aux = moe.apply_moe(params, torch.from_numpy(x), spec)
    jy, jaux = jmoe.apply_moe(jax.tree.map(jnp.asarray, raw), jnp.asarray(x),
                              jspec)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL, atol=TOL)
    assert float(aux) > 0

    # the same experts chosen, token for token
    probs, _, idx = moe.route(params, torch.from_numpy(x).reshape(B * S, -1),
                              spec)
    jprobs = jax.nn.softmax(jnp.asarray(x.reshape(B * S, -1))
                            @ jnp.asarray(raw["router"]), axis=-1)
    _, jidx = jax.lax.top_k(jprobs, spec.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    top = torch.sort(probs, dim=-1, descending=True).values
    print(f"{case}: smallest gap between the top-{spec.top_k} and the next "
          f"probability {float((top[:, spec.top_k - 1] - top[:, spec.top_k]).min()):.3e}")

    dropped = _dropped(params, torch.from_numpy(x), spec)
    if case in ("dropping", "per_sequence", "two_groups"):
        assert dropped > 0, case
    if case == "smoke":
        assert dropped == 0


def test_shapes_and_init():
    """init_moe's leaves have the JAX initializer's shapes, dtypes and
    scales; meta tensors without a generator."""
    cfg, spec = _smoke()
    spec = dataclasses.replace(spec, n_shared=2)
    got = moe.init_moe(torch.Generator().manual_seed(0), cfg, spec)
    want = jax.eval_shape(lambda: jmoe.init_moe(
        jax.random.PRNGKey(0), cfg, jbase.MoESpec(**dataclasses.asdict(spec))))
    flat = {"/".join(str(k.key) for k in p): v for p, v in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    mine = {"/".join(p): v for p, v in _flat(got)}
    assert {p: tuple(v.shape) for p, v in mine.items()} == {
        p: tuple(v.shape) for p, v in flat.items()}
    assert all(v.dtype == torch.float32 for v in mine.values())
    assert abs(float(mine["router"].std()) - 0.02) < 4e-3
    d = cfg.d_model
    assert abs(float(mine["w_up"].std()) - d ** -0.5) < 0.1 * d ** -0.5
    meta = moe.init_moe(None, cfg, spec)
    assert meta["w_down"].device.type == "meta"


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v
