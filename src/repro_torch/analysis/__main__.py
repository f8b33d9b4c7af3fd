"""CLI: ``python -m repro_torch.analysis [--device cuda|cpu] [--rules ...]
[--selftest] [--json PATH]`` (``src/repro/analysis/__main__.py``).

Runs every registered pass (``analysis.entrypoints.PASSES``) on the card
(``--device`` defaults to ``cuda``) and exits non-zero on any finding.
With ``--device cpu`` the rules that read a card (the attention forward's
tile plans and the kernels' Hopper budgets) are not run, and the CLI names each of them.  ``--selftest``
instead checks that every rule fires on its seeded known-bad fixture.
``--json`` writes the findings and the rules not run.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.analysis import entrypoints


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--device", default="cuda",
                    help="where the passes run (default cuda; cpu runs "
                         "the card-free rules and names the others)")
    ap.add_argument("--rules", nargs="*", default=None,
                    help="rule names to run (default: all); e.g. "
                         "--rules oracle-coverage hopper-budget")
    ap.add_argument("--selftest", action="store_true",
                    help="check that each rule fires on its seeded fixture")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the findings summary to PATH")
    args = ap.parse_args(argv)

    if args.selftest:
        failures = entrypoints.selftest(args.device)
        for f in failures:
            print(f"SELFTEST FAIL: {f}")
        if not failures:
            print("selftest ok: every rule caught its seeded fixture "
                  "(oracle-coverage, attention-tiling, hopper-budget, "
                  "doubly-stochastic)")
        return 1 if failures else 0

    rules = set(args.rules) if args.rules else None
    t0 = time.perf_counter()
    results, not_run = entrypoints.run_passes(rules, args.device)
    elapsed = time.perf_counter() - t0
    n_findings = 0
    for name, findings in results.items():
        print(f"{name:<12} "
              f"{'ok' if not findings else f'{len(findings)} finding(s)'}")
        for f in findings:
            print(f"  {f}")
        n_findings += len(findings)
    for rule in not_run:
        print(f"not run on {args.device}: {rule} (needs a CUDA card)")
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump({"device": args.device,
                       "rules": sorted(rules) if rules else "all",
                       "elapsed_s": round(elapsed, 2),
                       "passes": {n: [f.to_json() for f in fs]
                                  for n, fs in results.items()},
                       "not_run": not_run, "n_findings": n_findings},
                      fh, indent=1)
    print(f"{len(results)} passes, {n_findings} finding(s), "
          f"{elapsed:.1f} s on {args.device}")
    return 1 if n_findings else 0


if __name__ == "__main__":
    sys.exit(main())
