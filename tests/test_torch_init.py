"""``models.transformer.init_params`` draws each stacked repeat into its
slice of a leaf allocated once, so that init holds one repeat above the
weights.  Held here, at ``SMOKE`` for every ported configuration, against
drawing every repeat's tree and stacking them (the port's init before,
whose draws and order it keeps): bit for bit, from the same seed.  The
``meta`` template (``abstract_params``) has the same shapes and dtypes.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch import configs
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.tree import tree_flatten_with_path, tree_map
from _torch_threads import one_thread  # noqa: E402,F401

PORTED = sorted(configs._PORTED)


def _stacked_init(gen: torch.Generator, cfg) -> dict:
    """init_params as every repeat's tree drawn, then stacked."""
    v, d, cb = cfg.padded_vocab, cfg.d_model, cfg.n_codebooks

    def per_codebook(make):
        return make() if cb == 1 else torch.stack([make() for _ in range(cb)])

    def stage(st) -> dict:
        per = [{f"b{i}": T.init_block(gen, cfg, sp)
                for i, sp in enumerate(st.blocks)}
               for _ in range(st.repeat)]
        return per[0] if st.repeat == 1 else tree_map(
            lambda *xs: torch.stack(xs), *per)

    p = {"embed": per_codebook(lambda: layers.embed_init(gen, v, d))}
    if cfg.frontend is not None:
        p["frontend_proj"] = layers.dense_init(gen, cfg.frontend.embed_dim, d)
    p["stages"] = {f"s{i}": stage(st) for i, st in enumerate(cfg.stages)}
    p["final_norm"] = layers.rmsnorm_init(d)
    if not cfg.tie_embeddings:
        p["lm_head"] = per_codebook(lambda: layers.dense_init(gen, d, v))
    return p


@pytest.mark.parametrize("arch", PORTED)
def test_init_equals_stacked_repeats_bit_for_bit(arch):
    cfg = configs.get_config(arch, smoke=True)
    got = tree_flatten_with_path(
        T.init_params(torch.Generator().manual_seed(3), cfg))
    want = tree_flatten_with_path(
        _stacked_init(torch.Generator().manual_seed(3), cfg))
    assert got[0] == want[0]
    for path, a, b in zip(got[0], got[1], want[1]):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert torch.equal(a, b), path
    meta = tree_flatten_with_path(T.abstract_params(cfg))
    assert meta[0] == got[0]
    assert all(m.device.type == "meta" and m.shape == a.shape
               for m, a in zip(meta[1], got[1]))
