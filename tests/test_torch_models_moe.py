"""granite-moe-1b-a400m in the port (``"moe_attn"`` blocks: GQA, then the
routed experts of ``models/moe.py``), against the JAX package at
``SMOKE`` from its initial weights (``tests/_torch_model_parity.py``).

The parameter tree (routers, stacked experts) carried across by
``convert.transformer_params_from_reference`` and back; train-mode logits
and the router's auxiliary loss (summed over blocks) within 1e-5;
prefill and 3 contiguous decode steps within 1e-5; greedy ``generate``
tokens, and the paged engine's greedy tokens with fewer requests than
slots (empty slots take expert capacity in both engines' waves), equal to
the JAX package's.  The trainer refuses MoE and codebook configs.
"""
from __future__ import annotations

import pytest

jax = pytest.importorskip("jax")

import _torch_model_parity as mp  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import build_trainer  # noqa: E402
from repro_torch.models import moe  # noqa: E402


@pytest.fixture(scope="module")
def model():
    return mp.carried("granite-moe-1b-a400m")


def test_parameter_trees_cross(model):
    mp.check_parameter_trees(model)
    spec = model[2].stages[0].blocks[0].moe
    assert model[3]["stages"]["s0"]["b0"]["moe"]["w_gate"].shape == (
        2, spec.n_experts, model[2].d_model, spec.d_expert)


def test_forward_logits_and_aux_match_reference(model):
    cfg = model[2]
    logits, aux = mp.check_forward(model, mp.prompts(cfg, 2, 11, seed=1))
    assert logits.shape == (2, 11, cfg.vocab_size) and float(aux) > 0.0


def test_prefill_and_decode_match_reference(model):
    cfg = model[2]
    mp.check_prefill_and_decode(model, mp.prompts(cfg, 2, 13, seed=2), 3)


def test_generate_tokens_equal_reference(model):
    cfg = model[2]
    mp.check_generate(model, mp.prompts(cfg, 2, 13, seed=3), 6)


def test_engine_tokens_equal_reference_engine(model):
    """3 slots, 2 requests: every wave dispatches 3 tokens as one group;
    at SMOKE the capacity (top_k * cf / E = 1 slot a token) drops none."""
    cfg = model[2]
    spec = cfg.stages[0].blocks[0].moe
    assert moe.capacity(3, spec) >= 3
    want, got, engine = mp.serve_both(model, mp.ragged(cfg, (6, 13), 5),
                                      n_slots=3, n_new=7)
    assert got == want and all(len(t) == 7 for t in got.values())


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "musicgen-large"])
def test_trainer_refuses_moe_and_codebooks(arch):
    cfg = configs.get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_trainer(cfg, 2)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                    "1", "--nodes", "2"])
    dense = configs.get_config("granite-3-2b", smoke=True)
    assert build_trainer(dense, 2)[0].gossip.n_nodes == 2
