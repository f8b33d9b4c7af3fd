"""The port's dense GQA transformer and paged serving path against the JAX
package, at smollm-135m's SMOKE config with the JAX weights carried over
(``repro_torch.convert``) and the same NumPy prompts.

Tolerances: prefill and decode logits and KV caches to 1e-5 absolute (fp32
products, norms and online softmax summed in another order through two
layers; logits up to about 4, measured differences up to 3e-6).  Greedy
tokens exactly: the JAX engine's, the port's contiguous ``generate``'s, and a ragged batch's
against each request served alone.  Temperature sampling draws from a
``torch.Generator`` (JAX keys cannot be matched) and is checked by
invariants.  The scheduler is the JAX package's cases, on the port's copy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import ContinuousBatchingScheduler as JSched  # noqa: E402
from repro.serve import PagedKVSpec as JSpec  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import serve_requests as jserve  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import (ContinuousBatchingScheduler,  # noqa: E402
                               PagedKVSpec, Request, ServeEngine,
                               serve_requests)
from repro_torch.serve import kv_cache  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = 1e-5


@pytest.fixture(scope="module")
def smoke():
    jcfg = jconfigs.get_config("smollm-135m", smoke=True)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = configs.get_config("smollm-135m", smoke=True)
    params = convert.transformer_params_from_reference(jparams, "cpu")
    return jcfg, jparams, cfg, params


def _prompts(lengths, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lengths]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


SERVED = ("smollm-135m", "granite-3-2b", "granite-3-8b", "gemma3-27b",
          "musicgen-large", "granite-moe-1b-a400m", "deepseek-v2-236b",
          "llama-3.2-vision-11b", "zamba2-2.7b", "xlstm-1.3b")


@pytest.mark.parametrize("arch", SERVED)
@pytest.mark.parametrize("smoke_cfg", [False, True])
def test_config_copied_value_for_value(smoke_cfg, arch):
    want = jconfigs.get_config(arch, smoke=smoke_cfg)
    got = configs.get_config(arch, smoke=smoke_cfg)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "frontend" and a is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        elif f.name != "stages":
            assert a == b, f.name
    assert (got.hd, got.n_layers, got.padded_vocab) == \
        (want.hd, want.n_layers, want.padded_vocab)
    for st, jst in zip(got.stages, want.stages, strict=True):
        assert st.repeat == jst.repeat
        for b, jb in zip(st.blocks, jst.blocks, strict=True):
            assert (b.kind, b.has_mlp) == (jb.kind, jb.has_mlp)
            for spec in ("attn", "ssm", "xlstm"):
                got_spec, want_spec = getattr(b, spec), getattr(jb, spec)
                assert (got_spec is None) == (want_spec is None)
                if want_spec is not None:
                    assert dataclasses.asdict(got_spec) == \
                        dataclasses.asdict(want_spec)
            if jb.moe is None:
                assert b.moe is None
            else:
                kept = dataclasses.asdict(b.moe)
                assert {k: v for k, v in dataclasses.asdict(jb.moe).items()
                        if k in kept} == kept


def test_registry_refuses_what_is_not_ported():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert {configs.get_config(a).name for a in SERVED} == set(SERVED)
    assert set(SERVED) == set(configs.ARCH_IDS)
    with pytest.raises(ValueError, match="unknown"):
        configs.get_config("gpt-17")
    cfg = configs.get_config("smollm-135m", smoke=True)
    gen = torch.Generator().manual_seed(0)
    rwkv = dataclasses.replace(cfg, stages=configs.uniform_stages(
        configs.BlockSpec(kind="rwkv"), 2))
    with pytest.raises(ValueError, match="unknown block kind 'rwkv'"):
        T.init_params(gen, rwkv)
    with pytest.raises(ValueError, match="unknown block kind 'rwkv'"):
        T.init_cache(rwkv, 1, 8)
    for blk, match in ((configs.BlockSpec(attn=configs.AttnSpec(kind="mla")),
                        "GQA attention blocks only"),
                       (configs.BlockSpec(attn=configs.AttnSpec(
                           cross_attn=True)), "cross-attention")):
        served = dataclasses.replace(cfg,
                                     stages=configs.uniform_stages(blk, 2))
        with pytest.raises(ValueError, match=match):
            kv_cache.validate_config(served)
        assert "--legacy" in kv_cache.refusal(served)
    assert kv_cache.refusal(cfg) is None
    windowed = dataclasses.replace(cfg, stages=configs.uniform_stages(
        configs.BlockSpec(attn=configs.AttnSpec(sliding_window=8)), 2))
    with pytest.raises(ValueError, match="sliding-window"):
        kv_cache.validate_config(windowed)


# ---------------------------------------------------------------------------
# model: prefill and decode against the JAX package
# ---------------------------------------------------------------------------


def test_params_convert_leaf_for_leaf(smoke):
    jcfg, jparams, cfg, params = smoke
    back = convert.transformer_params_to_reference(params)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == 12    # embed, lm_head, final_norm, 9 block leaves
    for path, leaf in flat:
        got = back
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got, np.asarray(leaf))
    # the stage's 2 repeats stay stacked on the leading axis
    assert params["stages"]["s0"]["b0"]["attn"]["wq"].shape == (2, 96, 96)
    assert T.init_params(torch.Generator().manual_seed(0), cfg)[
        "stages"]["s0"]["b0"]["mlp"]["w_up"].shape == (2, 96, 256)


def test_prefill_and_decode_match_reference(smoke):
    jcfg, jparams, cfg, params = smoke
    tokens = np.array(_prompts((11, 11), cfg.vocab_size, seed=1))
    jlogits, _, jcaches = JT.forward(jparams, jcfg, jnp.asarray(tokens),
                                     mode="prefill", cache_len=16)
    logits, aux, caches = T.forward(params, cfg, torch.from_numpy(tokens),
                                    mode="prefill", cache_len=16)
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=TOL)
    last, _ = make_prefill_step(cfg)(params, torch.from_numpy(tokens))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlogits[:, -1]),
                               atol=TOL)
    want = jax.tree.map(np.asarray, jcaches)
    got = convert.tree_to_reference(caches)
    for key in ("k", "v", "pos"):
        np.testing.assert_allclose(got["s0"]["b0"][key],
                                   want["s0"]["b0"][key], atol=TOL)
    assert got["s0"]["b0"]["k"].shape == (2, 2, 16, 1, 32)

    # two decode steps from each side's own caches
    for step, tok in enumerate(([3, 200], [17, 5])):
        pos = np.full((2,), 11 + step, np.int32)
        jl, jcaches = JT.decode_step(jparams, jcfg, jnp.asarray(tok),
                                     jnp.asarray(pos), jcaches)
        lg, caches = T.decode_step(params, cfg, torch.tensor(tok),
                                   torch.from_numpy(pos), caches)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=TOL)
    got = convert.tree_to_reference(caches)["s0"]["b0"]
    want = jax.tree.map(np.asarray, jcaches)["s0"]["b0"]
    for key in ("k", "v", "pos"):
        np.testing.assert_allclose(got[key], want[key], atol=TOL)


def test_paged_pools_match_reference_scatter(smoke):
    """init_pools / scatter_prompt against the JAX package's, through
    the pools converter."""
    from repro.serve import kv_cache as jkv
    jcfg, jparams, cfg, params = smoke
    tokens = np.array(_prompts((12,), cfg.vocab_size, seed=2))
    _, _, jc = JT.forward(jparams, jcfg, jnp.asarray(tokens), mode="prefill",
                          cache_len=12)
    _, _, c = T.forward(params, cfg, torch.from_numpy(tokens),
                        mode="prefill", cache_len=12)
    jspec, spec = JSpec(4, 9, 4), PagedKVSpec(4, 9, 4)
    pages = np.array([5, 2, 7], np.int32)
    jpools = jkv.scatter_prompt(jkv.init_pools(jcfg, jspec), jc,
                                jnp.asarray(pages), cfg=jcfg, page_size=4)
    pools = kv_cache.scatter_prompt(kv_cache.init_pools(cfg, spec), c,
                                    torch.from_numpy(pages), cfg=cfg,
                                    page_size=4)
    want = convert.tree_from_reference(jpools, "cpu")
    for key in ("k_pages", "v_pages"):
        got, ref = pools["s0"]["b0"][key], want["s0"]["b0"][key]
        assert got.shape == ref.shape == (2, 9, 4, 1, 32)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=TOL)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def _serve(engine_cls, sched_cls, req_cls, serve, cfg, params, prompts,
           spec, n_slots, new_tokens, **kw):
    engine = engine_cls(cfg, params, kv_spec=spec, n_slots=n_slots, **kw)
    sched = sched_cls(n_slots, spec)
    fin = serve(engine, sched, [req_cls(prompt=p, max_new_tokens=new_tokens)
                                for p in prompts])
    return {tuple(r.prompt): r.tokens for r in fin}, engine, sched


def test_engine_greedy_tokens_equal_reference_engine(smoke):
    jcfg, jparams, cfg, params = smoke
    prompts = _prompts((5, 14), cfg.vocab_size, seed=3)
    want, _, _ = _serve(JEngine, JSched, JRequest, jserve, jcfg, jparams,
                        prompts, JSpec(4, 33, 6), 2, 7, temperature=0.0)
    got, engine, sched = _serve(ServeEngine, ContinuousBatchingScheduler,
                                Request, serve_requests, cfg, params,
                                prompts, PagedKVSpec(4, 33, 6), 2, 7)
    assert got == want
    assert all(len(t) == 7 for t in got.values())
    assert sched.pool.n_free == 32                # every page released
    assert engine.steps_run == 6                  # 7 tokens, 1 from prefill


def test_engine_matches_contiguous_generate_and_alone(smoke):
    """Paged == contiguous greedy decode; a ragged batch == each request
    served alone (the port's counterparts of the JAX package's tests)."""
    _, _, cfg, params = smoke
    prompts = _prompts((12, 3, 9), cfg.vocab_size, seed=4)
    spec = PagedKVSpec(page_size=4, n_pages=33, max_pages_per_slot=6)
    together, _, _ = _serve(ServeEngine, ContinuousBatchingScheduler,
                            Request, serve_requests, cfg, params, prompts,
                            spec, 2, 8)
    for p in prompts:
        want = generate(cfg, params, torch.tensor([p]), 8)[0].tolist()
        alone, _, _ = _serve(ServeEngine, ContinuousBatchingScheduler,
                             Request, serve_requests, cfg, params, [p], spec,
                             1, 8)
        assert together[tuple(p)] == alone[tuple(p)] == want


def test_engine_temperature_sampling_invariants(smoke):
    _, _, cfg, params = smoke
    prompts = _prompts((6, 10), cfg.vocab_size, seed=5)
    spec = PagedKVSpec(page_size=4, n_pages=33, max_pages_per_slot=8)
    runs = [_serve(ServeEngine, ContinuousBatchingScheduler, Request,
                   serve_requests, cfg, params, prompts, spec, 2, 16,
                   temperature=1.0, seed=seed)[0] for seed in (7, 7, 8)]
    assert runs[0] == runs[1]                     # same generator seed
    assert runs[0] != runs[2]
    for toks in runs[0].values():
        assert all(0 <= t < cfg.vocab_size for t in toks)
        assert len(set(toks)) > 4                 # draws differ across steps
    greedy = generate(cfg, params, torch.tensor([prompts[0]]), 16)
    assert runs[0][tuple(prompts[0])] != greedy[0].tolist()


# ---------------------------------------------------------------------------
# scheduler (tests/test_serve.py's cases, on the port's copy)
# ---------------------------------------------------------------------------


def _spec(ps=4, n_pages=9, m=4):
    return PagedKVSpec(page_size=ps, n_pages=n_pages, max_pages_per_slot=m)


def test_scheduler_admit_evict_refill():
    sched = ContinuousBatchingScheduler(2, _spec())   # 8 pages, 2 a request
    reqs = [Request(prompt=[1] * 4, max_new_tokens=4, arrival=0.0)
            for _ in range(4)]
    for r in reqs:
        sched.submit(r)
    adm = sched.admit(now=0.0)
    assert [s for s, _ in adm] == [0, 1]
    assert sched.pool.n_free == 4
    for i in range(4):
        done = sched.on_token(0, 7, now=0.1 + i * 0.01)
    assert done is reqs[0] and done.latency > 0
    assert sched.pool.n_free == 6
    adm = sched.admit(now=0.2)
    assert [s for s, _ in adm] == [0] and adm[0][1] is reqs[2]
    sched.slots[1].request.eos_id = 9
    assert sched.on_token(1, 9, now=0.3) is reqs[1]


def test_scheduler_respects_arrivals_and_pages():
    sched = ContinuousBatchingScheduler(2, _spec(n_pages=5))  # 4 pages
    sched.submit(Request(prompt=[1] * 8, max_new_tokens=8, arrival=0.0))
    sched.submit(Request(prompt=[1] * 4, max_new_tokens=4, arrival=5.0))
    adm = sched.admit(now=0.0)
    assert len(adm) == 1 and sched.pool.n_free == 0
    assert sched.admit(now=1.0) == []
    for i in range(8):
        sched.on_token(0, 3, now=2.0 + i * 0.1)
    assert sched.admit(now=4.0) == []     # arrival still in the future
    assert len(sched.admit(now=5.0)) == 1


def test_scheduler_static_mode_drains_before_refill():
    sched = ContinuousBatchingScheduler(2, _spec(n_pages=17),
                                        refill="static")
    for _ in range(3):
        sched.submit(Request(prompt=[1] * 4, max_new_tokens=2, arrival=0.0))
    assert len(sched.admit(now=0.0)) == 2
    sched.on_token(0, 1, 0.1)
    assert sched.on_token(0, 1, 0.2) is not None
    assert sched.admit(now=0.3) == []     # slot 1 still running
    sched.on_token(1, 1, 0.4)
    sched.on_token(1, 1, 0.5)
    assert len(sched.admit(now=0.6)) == 1


def test_scheduler_rejects_oversized_request():
    with pytest.raises(ValueError):
        ContinuousBatchingScheduler(1, _spec()).submit(
            Request(prompt=[1] * 20, max_new_tokens=20))
