"""How far xlstm-1.3b's logits in the port lie from the JAX package's on
the CPU at ``SMOKE`` widths and at 4 layers (2 stacked repeats of its
mLSTM + sLSTM supercell): the table behind the tolerances of
``tests/test_torch_models_xlstm.py``.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_xlstm_logit_gap.py

For each (layers, seed, length), two prompts drawn as the test draws them,
from the JAX package's initial weights (``PRNGKey(0)``) on both sides:
``gap`` (the port's train-mode logits against the JAX package's, jitted),
the largest |logit|, and ``port-f64`` and ``jax-f64``: each package's fp32
logits against a float64 forward of the port (its weights in float64;
the cells then keep their gates and states in float64).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_model_parity as mp
from repro import configs as jconfigs
from repro.models import transformer as JT
from repro_torch import configs, convert
from repro_torch.models import transformer as T
from repro_torch.tree import tree_map

DRAWS = [(1, 40), (1, 70), (2, 45), (3, 45), (4, 40), (5, 70)]


def _models():
    jcfg, jparams, cfg, params = mp.carried("xlstm-1.3b")
    yield "2", jcfg, jparams, cfg, params
    jcfg4 = dataclasses.replace(jcfg, stages=jconfigs.base.patterned_stages(
        jcfg.stages[0].blocks, 4))
    cfg4 = dataclasses.replace(cfg, stages=configs.patterned_stages(
        cfg.stages[0].blocks, 4))
    jp4 = JT.init_params(jax.random.PRNGKey(0), jcfg4)
    yield "4", jcfg4, jp4, cfg4, convert.transformer_params_from_reference(
        jp4, "cpu")


def main() -> None:
    torch.set_num_threads(1)
    print("layers seed length gap max|logit| port-f64 jax-f64")
    for layers, jcfg, jparams, cfg, params in _models():
        p64 = tree_map(lambda t: t.double(), params)
        for seed, length in DRAWS:
            tok = mp.prompts(cfg, 2, length, seed=seed)
            jl = np.asarray(mp._jforward(jparams, jcfg, jnp.asarray(tok))[0])
            tl = T.forward(params, cfg, torch.from_numpy(tok).long())[0]
            t64 = T.forward(p64, cfg, torch.from_numpy(tok).long())[0]
            tl, t64 = tl.numpy(), t64.numpy()
            print(layers, seed, length, *(f"{v:.3e}" for v in (
                np.abs(tl - jl).max(), np.abs(jl).max(),
                np.abs(tl - t64).max(), np.abs(jl - t64).max())),
                flush=True)


if __name__ == "__main__":
    main()
