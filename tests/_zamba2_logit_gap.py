"""How far zamba2-2.7b's ``SMOKE`` logits in the port lie from the JAX
package's on the CPU, over seeds and prompt lengths: the table behind the
tolerance of ``tests/test_torch_models_zamba2.py``.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_zamba2_logit_gap.py

For each (seed, length), two prompts drawn as the test draws them, from the
JAX package's initial weights (``PRNGKey(0)``) on both sides:

* ``gap``: the port's train-mode logits against the JAX package's (jitted,
  as the test runs it);
* ``seq gap``: the same with both packages on the sequential SSD
  (``ssd_reference`` in place of ``_ssd_chunked``);
* ``port-f64`` and ``jax-f64``: each package's fp32 logits against a
  float64 forward of the port (its SSD's B and C products stay fp32).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

import _torch_model_parity as mp
from repro.models import ssm as jssm
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.tree import tree_map

DRAWS = [(1, 40), (2, 45), (3, 40), (4, 64), (5, 100), (6, 33), (7, 96)]


def _sequential(on: bool, saved=(jssm._ssd_chunked, ssm._ssd_chunked)):
    if on:
        jssm._ssd_chunked = lambda x, b, c, dt, la, chunk: \
            jssm.ssd_reference(x, b, c, dt, la)
        ssm._ssd_chunked = lambda x, b, c, dt, la, chunk: \
            ssm.ssd_reference(x, b, c, dt, la)
    else:
        jssm._ssd_chunked, ssm._ssd_chunked = saved


def main() -> None:
    torch.set_num_threads(1)
    jcfg, jparams, cfg, params = mp.carried("zamba2-2.7b")
    p64 = tree_map(lambda p: p.double() if p.is_floating_point() else p,
                   params)

    def logits(tok, p=params, jax_side=False):
        if jax_side:
            return np.asarray(mp._jforward(jparams, jcfg,
                                           jnp.asarray(tok))[0])
        return T.forward(p, cfg, torch.from_numpy(tok).long())[0].numpy()

    print("seed length gap seq_gap port-f64 jax-f64")
    for seed, length in DRAWS:
        tok = mp.prompts(cfg, 2, length, seed=seed)
        jl, tl, t64 = logits(tok, jax_side=True), logits(tok), logits(tok,
                                                                        p64)
        _sequential(True)
        mp._jforward.clear_cache()
        seq = np.abs(logits(tok) - logits(tok, jax_side=True)).max()
        _sequential(False)
        mp._jforward.clear_cache()
        print(seed, length, *(f"{v:.3e}" for v in (
            np.abs(tl - jl).max(), seq, np.abs(tl - t64).max(),
            np.abs(jl - t64).max())), flush=True)


if __name__ == "__main__":
    main()
