"""The port's kernel checker and analysis CLI on the CPU
(``repro_torch.analysis.kernel_check``, ``entrypoints``, ``__main__``).

* Oracle coverage and launch arithmetic are clean on the tree; each
  fires on a seeded fault: a wrapper that launches with no plain version,
  a kernel without its estimator or its launch counter, a constant of a
  wrapper that no longer matches its CUDA source, a block width that
  leaves columns out.
* Every selftest fixture fires (a wrapper source without a plain
  version, an attention plan without a key tile, a resources record over
  the shared-memory limit, a sub-stochastic W_t), and a clean record
  raises nothing.
* ``main(["--device", "cpu"])`` returns 0 in process, naming the rules
  it did not run (the attention tile plans and the Hopper budgets need
  the card); a rule filter runs only the passes that check it; ``--json``
  writes the summary.

The two card rules read the built libraries: ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import json

import pytest

from repro_torch.analysis import entrypoints, kernel_check
from repro_torch.analysis.__main__ import main
from repro_torch.kernels import multi_hop_mix as mh
from repro_torch.obs import estimates
from _torch_threads import one_thread  # noqa: E402,F401


def test_kernel_checks_are_clean_on_the_tree():
    assert kernel_check.check_oracle_coverage() == []
    assert kernel_check.check_launch_arithmetic() == []


def _ops_source() -> str:
    return (kernel_check.KERNELS_DIR / "ops.py").read_text()


@pytest.mark.parametrize("fault, want", [
    # the CPU branch of the ring-mix wrapper gone
    (lambda s: s.replace("return [ref.ring_mix_ref(x, x.roll(1, 0)",
                         "return [(x, x.roll(1, 0)"),
     "ops.ring_mix_leaves: dispatches"),
    # a kernel nothing records an estimate for
    (lambda s: s.replace('_record("paged_decode"', '_record("paged"'),
     "no wrapper records an estimate under 'paged_decode'"),
    # a launch counter the launcher module does not have
    (lambda s: s.replace('"ring_mix": (_rm, "launches")',
                         '"ring_mix": (_rm, "calls")'),
     "ring_mix.calls is no launch counter"),
])
def test_oracle_coverage_fires_on_a_seeded_fault(fault, want):
    source = fault(_ops_source())
    assert source != _ops_source()
    found = kernel_check.check_oracle_coverage(source=source)
    assert any(want in str(f) for f in found), found


def test_oracle_coverage_fires_on_a_missing_estimator(monkeypatch):
    kernels = dict(estimates.KERNELS)
    del kernels["quant_mix"]
    kernels["fused_retract_v2"] = kernels["fused_retract"]
    monkeypatch.setattr(estimates, "KERNELS", kernels)
    found = [str(f) for f in kernel_check.check_oracle_coverage()]
    assert any("'quant_mix' has no estimator" in f for f in found), found
    assert any("fused_retract_v2" in f and "of no kernel" in f
               for f in found), found


def test_launch_arithmetic_fires_on_a_seeded_fault(monkeypatch):
    monkeypatch.setattr(mh, "MAX_REG_ROWS", 31)
    found = [str(f) for f in kernel_check.check_launch_arithmetic()]
    assert any("kMaxRegRows = 32 in multi_hop_mix.cu" in f
               for f in found), found
    monkeypatch.undo()
    # a width that is not the widest fitting one, and one that does not
    # fit at all
    monkeypatch.setattr(mh, "block_width", lambda n: 64 if n <= 32 else 32)
    found = [str(f) for f in kernel_check.check_launch_arithmetic()]
    assert any("not the widest" in f for f in found), found
    monkeypatch.setattr(mh, "block_width", lambda n: 256)
    found = [str(f) for f in kernel_check.check_launch_arithmetic()]
    assert any("does not fit" in f for f in found), found


def test_source_constants_and_mirrored_plans():
    """The constants the checker reads from the sources, and the rule over
    the attention plans, which it reads from ``flash_attention.cu``'s own
    plan functions on the card (no copy of them here): plans whose answers
    are known pass (smollm-135m's prefill, S = 256 at hd 64: 64 query rows
    and key tiles of 64 on the SIMT route; one tensor-core block of 4
    warps), and each fault fires: rows that leave queries out, no key
    tile, more than 4 warps, bytes over the limit."""
    assert kernel_check.source_constant("retract.cu", "kMaxR") == 256
    assert kernel_check.source_constant("leaves.cuh", "kMaxLeaves") == 16
    with pytest.raises(KeyError):
        kernel_check.source_constant("retract.cu", "kNoSuchThing")
    smem = kernel_check.source_constant("attention.cuh", "kMaxSmem")
    assert smem == 232448
    simt = {"case": "S=256 hd=64/64 fp32", "S": 256, "route": "simt",
            "rows": 64, "split": 64, "bytes": 100000}
    tc = dict(simt, route="tensor cores", rows=64, split=1)
    assert kernel_check.attention_tiling_findings([simt, tc], smem) == []
    for bad in (dict(simt, rows=0), dict(simt, split=0),
                dict(simt, bytes=smem + 1), dict(tc, rows=32, split=4),
                dict(tc, rows=24)):
        found = kernel_check.attention_tiling_findings([bad], smem)
        assert [f.rule for f in found] == ["attention-tiling"], bad
    assert kernel_check.CARD_RULES == ("attention-tiling", "hopper-budget")


def test_every_selftest_fixture_fires():
    assert entrypoints.selftest("cpu") == []
    clean = dict(entrypoints._OVER_SMEM, dyn_smem=1024)
    assert kernel_check.budget_findings([clean], 232448) == []
    over = [str(f) for f in kernel_check.budget_findings(
        [dict(clean, regs=256, threads=512, resident=0)], 232448)]
    assert len(over) == 3, over
    assert main(["--device", "cpu", "--selftest"]) == 0


def test_cli_on_the_cpu(capsys, tmp_path):
    path = tmp_path / "analysis.json"
    assert main(["--device", "cpu", "--json", str(path)]) == 0
    out = capsys.readouterr().out
    assert "not run on cpu: kernels/attention-tiling (needs a CUDA card)" \
        in out
    assert "not run on cpu: kernels/hopper-budget (needs a CUDA card)" in out
    assert "kernels      ok" in out and "contracts    ok" in out
    summary = json.loads(path.read_text())
    assert summary["n_findings"] == 0 and summary["passes"] == {
        "kernels": [], "contracts": []}
    assert summary["not_run"] == ["kernels/attention-tiling",
                                  "kernels/hopper-budget"]
    results, not_run = entrypoints.run_passes({"oracle-coverage"}, "cpu")
    assert results == {"kernels": []} and not_run == []
    results, not_run = entrypoints.run_passes({"hopper-budget"}, "cpu")
    assert results == {} and not_run == ["kernels/hopper-budget"]
    with pytest.raises(ValueError, match="read a CUDA card"):
        kernel_check.run(("hopper-budget",), "cpu")
    with pytest.raises(ValueError, match="attention-tiling read a CUDA"):
        kernel_check.run(("attention-tiling",), "cpu")
