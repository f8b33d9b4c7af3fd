"""The port's checkpoints (``repro_torch.checkpoint``), alone and across
packages, mirroring ``tests/test_data_checkpoint.py``.

The file layout is the JAX package's (``p<i>`` in its flatten order, dict
keys sorted, a ``__paths__`` and a ``__dtypes__`` manifest), so a file
crosses between the packages: the fair parameter tree (node-stacked, in
the JAX layout) written by either restores in the other bitwise, and an
optimizer state's manifest names its leaves as the JAX package's does.  A
run resumed from a checkpoint is bitwise the run that never stopped:
DRGDA on the fair CNN, 10 steps against 5, save, restore, 5, with
telemetry on (the counters ride the state) over the exact ring, EF-int8
gossip (its error-feedback memory rides the state too), a faulty channel
and elastic leave-and-rejoin (the drawn counters and the membership ride
it).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import checkpoint
from repro_torch.comms.elastic import ChurnSchedule, ElasticSpec
from repro_torch.comms.spec import CommSpec
from repro_torch.launch.fair import prepare
from repro_torch.obs import Telemetry, unpack
from repro_torch.tree import tree_flatten_with_path
from _torch_threads import one_thread  # noqa: E402,F401


def _leaves(tree):
    return tree_flatten_with_path(tree)[1]


def test_checkpoint_roundtrip(tmp_path):
    tree = {"b": {"d": torch.tensor(3, dtype=torch.int32),
                  "c": torch.ones(4, dtype=torch.bfloat16) / 3},
            "a": torch.arange(6.0).reshape(2, 3),
            "s": [torch.zeros(2, dtype=torch.int8) - 5, 7, None]}
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, 10, tree)
    checkpoint.save(d, 20, tree)
    assert checkpoint.latest_step(d) == 20
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    like = {"b": {"d": torch.zeros((), dtype=torch.int32),
                  "c": torch.zeros(4, dtype=torch.bfloat16)},
            "a": torch.zeros(2, 3), "s": [torch.zeros(2, dtype=torch.int8),
                                          0, None]}
    back = checkpoint.restore(d, 10, like, device="cpu")
    assert list(back) == list(like)               # the caller's key order
    assert tree_flatten_with_path(back)[0] == ["a", "b/c", "b/d", "s/0",
                                               "s/1"]
    for a, b in zip(_leaves(tree), _leaves(back)):
        if isinstance(a, int):
            assert b == a and type(b) is int
        else:
            assert b.dtype == a.dtype and torch.equal(a, b)


def test_checkpoint_structure_mismatch(tmp_path):
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore(d, 1, {"z": torch.zeros(3)}, device="cpu")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fair_params_cross_packages(writer, tmp_path):
    """The node-stacked fair parameter tree (JAX layout) written by one
    package restores bitwise in the other; a DRGDA state's manifest names
    its leaves as the JAX package's does."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import checkpoint as jckpt
    from repro.core.gda import DRGDA as JDRGDA
    from repro.core.gda import broadcast_to_nodes
    from repro.core.gossip import GossipSpec as JSpec
    from repro.objectives import fair as jfair

    params = broadcast_to_nodes(
        jfair.init_cnn(jax.random.PRNGKey(0), image_hw=8, fc=16), 4)
    want = {k: np.asarray(v) for k, v in params.items()}
    d = str(tmp_path / writer)
    if writer == "jax":
        jckpt.save(d, 3, params)
        back = checkpoint.restore(
            d, 3, {k: torch.zeros(v.shape) for k, v in want.items()},
            device="cpu")
        got = {k: v.numpy() for k, v in back.items()}
    else:
        checkpoint.save(d, 3, {k: torch.from_numpy(v.copy())
                               for k, v in want.items()})
        back = jckpt.restore(d, 3, jax.tree.map(jnp.zeros_like, params))
        got = {k: np.asarray(v) for k, v in back.items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])

    # an optimizer state: the same manifest in both packages
    run = prepare("drgda", True, image_hw=8, n_nodes=4, device="cpu")
    jopt = JDRGDA(jfair.make_fair_problem(params), JSpec(n_nodes=4,
                                                         k_steps=1))
    full = {k: jnp.asarray(v) for k, v in run.stream.full(4).items()}
    js = jopt.init(params, jnp.full((4, 3), 1.0 / 3.0), full)
    assert tree_flatten_with_path(run.state)[0] == jckpt._paths(js)


RESUME_CASES = {
    # name: (comm, elastic)
    "exact": (None, None),
    "ef_int8": (CommSpec(compressor="int8", gamma=0.95), None),
    "faulty_channel": (CommSpec(drop_rate=0.3, straggler_rate=0.2, seed=4),
                       None),
    # node 2 away for rounds 3-6, across the save
    "elastic_leave_rejoin": (None, ElasticSpec(churn=ChurnSchedule(
        kind="scripted", events=((3, "leave", 2), (7, "join", 2))))),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_is_bitwise(case, tmp_path):
    """DRGDA (fair CNN, 4 nodes, 8x8, polar_fused, telemetry on): 10 steps
    equal 5 steps, a save, a restore into a fresh state and 5 more."""
    comm, elastic = RESUME_CASES[case]

    def fresh():
        tel = Telemetry(out_dir=str(tmp_path / "tel"), flush_every=2)
        return prepare("drgda", True, image_hw=8, n_nodes=4, device="cpu",
                       comm=comm, elastic=elastic, telemetry=tel)

    ref = fresh()
    state = ref.state
    for t in range(10):
        state, _ = ref.opt.step(state, ref.full)
        if t == 4:
            path = checkpoint.save(str(tmp_path / "ckpt"), 5, state)
    run = fresh()
    resumed = checkpoint.restore(str(tmp_path / "ckpt"), 5, run.state,
                                 device="cpu")
    assert path.endswith("step_00000005.npz") and resumed.step == 5
    for _ in range(5):
        resumed, _ = run.opt.step(resumed, run.full)
    assert resumed.step == state.step == 10
    want, got = (tree_flatten_with_path(s) for s in (state, resumed))
    assert got[0] == want[0]
    for path, a, b in zip(got[0], got[1], want[1]):
        if torch.is_tensor(a):
            assert torch.equal(a, b), path
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            assert a == b, path
    assert unpack(resumed.obs) == unpack(state.obs)
    if case in ("faulty_channel", "elastic_leave_rejoin"):
        assert unpack(state.obs).active_links < unpack(state.obs).hops * 4
