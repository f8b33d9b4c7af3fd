"""Kernel checker of the port (``src/repro/analysis/kernel_check.py``):
oracle coverage, launch arithmetic, Hopper budgets.

Three passes over the kernel layer:

- **Oracle coverage** (CPU; rule ``oracle-coverage``).  Reads
  ``kernels/ops.py`` with ``ast`` (no import side effects), as the JAX
  pass does: every function that dispatches to a CUDA launcher module
  (``<module>.launch*(...)``) must also call its plain version
  (``ref.*``, the CPU branch), and every kernel of ``ops._KERNELS`` must
  be recorded (``_record("<name>", ...)``) by a wrapper whose calls reach
  such a dispatch, have its counter in ``ops.launch_counts()`` (the
  launcher module's attribute) and its estimator in
  ``obs.estimates.KERNELS``; an estimator nothing records is stale.  The
  JAX pass's ``tune.py`` clause (an autotuned kernel needs
  ``tune.DEFAULTS`` and ``tune.SPACES`` entries) has no counterpart yet:
  the port has no autotuner (``kernels/tune.py`` is ROADMAP queue 1).
- **Launch arithmetic** (CPU; rule ``launch-arithmetic``), the
  counterpart of ``check_tiling``: the constants the Python wrappers share
  with the CUDA sources agree (read from ``csrc/``), and the wrappers'
  choices, re-derived over ragged (prime, one-off) shapes, leave no row
  or column out: ``multi_hop_mix.block_width`` (a multiple of 32 whose
  tile fits a block's shared memory), ``QUANT_BLOCK`` columns a block, the
  groups of ``leaves.MAX_LEAVES``, ``paged_decode.split_plan``,
  ``fused_retract``'s (r, r) stage (one block up to 32, clusters whose
  padded order ``CS * P`` covers r up to ``retract.MAX_R``, parsed from
  ``retract.cu``'s ``Cfg``s).
- **Attention tiling** (the card; rule ``attention-tiling``): the
  attention forward's tile choices, read from ``flash_attention.cu``'s
  own plan functions through ``repro_flash_attention_plan`` (host code
  of the built library, which only the card's machine builds) over
  ragged S and the head dims of both routes: every query row covered, a
  key tile found on the SIMT route, at most 4 warps a tensor-core block,
  the block's bytes within the card's limit.
- **Hopper budgets** (the card; rule ``hopper-budget``), the counterpart
  of ``check_vmem``: every kernel of the nine ``csrc/*.cu`` at the launch
  configurations the wrappers choose for the main paths' shapes and the
  edges of each route (:func:`budget_cases`), read through each library's
  ``repro_<kernel>_resources`` (``cudaFuncGetAttributes`` and the
  occupancy calculator): registers a thread <= 255, registers x threads
  <= 65,536 (one SM's file), static plus dynamic shared memory <= the
  card's opt-in limit a block (232,448 bytes on the H100, read from
  ``torch.cuda.get_device_properties``), and at least one resident block
  an SM (a cluster on the card, for a cluster launch).
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from repro_torch.analysis import Finding

__all__ = ["RULES", "check_oracle_coverage", "check_launch_arithmetic",
           "attention_plans", "attention_tiling_findings", "budget_cases",
           "budget_records", "budget_findings", "run"]

#: the rules of this module, in the order :func:`run` checks them; the
#: last two need a CUDA card
RULES = ("oracle-coverage", "launch-arithmetic", "attention-tiling",
         "hopper-budget")
CARD_RULES = ("attention-tiling", "hopper-budget")

KERNELS_DIR = Path(__file__).resolve().parents[1] / "kernels"
CSRC = KERNELS_DIR / "csrc"

REGS_PER_THREAD = 255      # Hopper: at most 255 registers a thread
REGS_PER_SM = 65536        # one SM's register file, 32-bit registers

#: ragged sizes the wrappers' arithmetic must cover: primes, one off a
#: tile, below a tile, aligned
RAGGED = (1, 2, 3, 7, 31, 32, 33, 63, 97, 127, 128, 129, 255, 256, 257,
          1009, 4093, 8191, 8192, 99991)


# ---------------------------------------------------------------------------
# oracle coverage: AST of kernels/ops.py
# ---------------------------------------------------------------------------


def _launchers(tree: ast.Module) -> dict[str, str]:
    """{alias: module} of the kernel launcher modules ops.py imports
    (``from repro_torch.kernels import <module> as <alias>``), without the
    plain versions (``ref``) and the shared leaf helpers."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and \
                node.module == "repro_torch.kernels":
            for a in node.names:
                if a.name not in ("ref", "leaves"):
                    out[a.asname or a.name] = a.name
    return out


def _dict_literal(tree: ast.Module, name: str) -> dict:
    """The module-level dict literal ``name = {"k": (alias, "attr")}`` as
    {k: (alias, attr)}."""
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets) and isinstance(node.value, ast.Dict):
            out = {}
            for k, v in zip(node.value.keys, node.value.values):
                if isinstance(k, ast.Constant) and isinstance(v, ast.Tuple):
                    alias, attr = v.elts
                    out[k.value] = (alias.id, attr.value)
            return out
    return {}


class _Scope:
    """What one function (or method) of ops.py does: the names it
    records under, the launcher calls it makes, whether it calls a plain
    version, and the module-level functions and classes it names."""

    def __init__(self, node: ast.AST, launchers: dict[str, str]):
        self.name = node.name
        consts = {}
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and isinstance(
                    sub.value, ast.Constant) and isinstance(
                    sub.value.value, str):
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        consts[t.id] = sub.value.value
        self.recorded, self.dispatch, self.names = set(), set(), set()
        self.has_ref = False
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name):
                self.names.add(sub.id)
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            if isinstance(f, ast.Name) and f.id == "_record" or (
                    isinstance(f, ast.Attribute) and f.attr == "record"
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "_est"):
                first = sub.args[0] if sub.args else None
                if isinstance(first, ast.Constant):
                    self.recorded.add(first.value)
                elif isinstance(first, ast.Name) and first.id in consts:
                    self.recorded.add(consts[first.id])
            if isinstance(f, ast.Attribute) and isinstance(f.value,
                                                           ast.Name):
                if f.value.id == "ref":
                    self.has_ref = True
                elif f.value.id in launchers and f.attr.startswith("launch"):
                    self.dispatch.add((f.value.id, f.attr))


def _scopes(tree: ast.Module, launchers: dict[str, str]):
    """({function name: _Scope}, {class name: [its method scopes]})."""
    funcs, classes = {}, {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            funcs[node.name] = _Scope(node, launchers)
        elif isinstance(node, ast.ClassDef):
            classes[node.name] = [_Scope(m, launchers) for m in node.body
                                  if isinstance(m, ast.FunctionDef)]
    return funcs, classes


def _reach(start: _Scope, funcs: dict, classes: dict) -> list[_Scope]:
    """``start`` and every function or class method of ops.py it names,
    transitively."""
    seen, todo, out = set(), [start], []
    while todo:
        s = todo.pop()
        if id(s) in seen:
            continue
        seen.add(id(s))
        out.append(s)
        for n in s.names:
            if n in funcs:
                todo.append(funcs[n])
            todo.extend(classes.get(n, ()))
    return out


def check_oracle_coverage(source: str | None = None) -> list[Finding]:
    """The oracle-coverage rule over ops.py's source (by default the
    port's own ``kernels/ops.py``)."""
    from repro_torch.kernels import ops
    from repro_torch.obs import estimates
    if source is None:
        source = (KERNELS_DIR / "ops.py").read_text()
    tree = ast.parse(source)
    launchers = _launchers(tree)
    kernels = _dict_literal(tree, "_KERNELS")
    funcs, classes = _scopes(tree, launchers)
    scopes = list(funcs.values()) + [m for ms in classes.values()
                                     for m in ms]
    findings = []
    if not kernels or not launchers:
        return [Finding("oracle-coverage", "ops.py",
                        "no _KERNELS table or no launcher import found: "
                        "scan broken?")]
    for s in scopes:
        if s.dispatch and not s.has_ref:
            findings.append(Finding(
                "oracle-coverage", f"ops.{s.name}",
                f"dispatches to {sorted(a for a, _ in s.dispatch)} with no "
                f"plain version (ref.*) beside it: the CPU path and the "
                f"card's check have nothing to run"))
    recorders = {}
    for s in funcs.values():
        for name in s.recorded:
            recorders.setdefault(name, []).append(s)
    for name, (alias, counter) in sorted(kernels.items()):
        where = f"ops._KERNELS[{name!r}]"
        if alias not in launchers:
            findings.append(Finding("oracle-coverage", where,
                                    f"launcher {alias!r} is not imported"))
            continue
        module = getattr(ops, alias)
        if not isinstance(getattr(module, counter, None), int):
            findings.append(Finding(
                "oracle-coverage", where,
                f"{launchers[alias]}.{counter} is no launch counter: "
                f"ops.launch_counts() cannot read it"))
        if name not in estimates.KERNELS:
            findings.append(Finding(
                "oracle-coverage", where,
                f"kernel {name!r} has no estimator in "
                f"obs.estimates.KERNELS"))
        if name not in recorders:
            findings.append(Finding(
                "oracle-coverage", where,
                f"no wrapper records an estimate under {name!r}"))
            continue
        reached = [r for s in recorders[name]
                   for r in _reach(s, funcs, classes)]
        if not any(alias == a for r in reached for a, _ in r.dispatch):
            findings.append(Finding(
                "oracle-coverage", f"ops.{recorders[name][0].name}",
                f"records {name!r} but reaches no launch of {alias}"))
    for name in sorted(set(estimates.KERNELS) - set(kernels)):
        findings.append(Finding(
            "oracle-coverage", f"estimates.KERNELS[{name!r}]",
            "registered estimator of no kernel in ops._KERNELS"))
    return findings


# ---------------------------------------------------------------------------
# launch arithmetic: the wrappers' choices over ragged shapes
# ---------------------------------------------------------------------------


def source_constant(file: str, name: str) -> int:
    """The integer ``constexpr <type> name = <int>;`` of ``csrc/file``."""
    text = (CSRC / file).read_text()
    m = re.search(rf"constexpr\s+[\w ]+?\s{name}\s*=\s*(\d+)\s*;", text)
    if m is None:
        raise KeyError(f"{file}: no integer constant {name}")
    return int(m.group(1))


def _retract_configs() -> dict[str, tuple[int, ...]]:
    """retract.cu's ``using CfgN = Cfg<CS, P, TR, TC, FULL>`` as
    {CfgN: (CS, P, TR, TC)}."""
    text = (CSRC / "retract.cu").read_text()
    return {m.group(1): tuple(int(m.group(i)) for i in range(2, 6))
            for m in re.finditer(
                r"using (Cfg\d+) = Cfg<(\d+), (\d+), (\d+), (\d+), \w+>;",
                text)}


def check_launch_arithmetic() -> list[Finding]:
    """The launch-arithmetic rule (CPU)."""
    from repro_torch.kernels import leaves, ops
    from repro_torch.kernels import multi_hop_mix as mh
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import retract as rt
    findings = []

    def bad(where, msg):
        findings.append(Finding("launch-arithmetic", where, msg))

    smem = source_constant("attention.cuh", "kMaxSmem")
    for what, got, file, name in (
            ("multi_hop_mix.MAX_REG_ROWS", mh.MAX_REG_ROWS,
             "multi_hop_mix.cu", "kMaxRegRows"),
            ("multi_hop_mix.MAX_REG_ROWS", mh.MAX_REG_ROWS,
             "multi_hop_mix_quant.cu", "kMaxRegRows"),
            ("multi_hop_mix.QUANT_BLOCK", mh.QUANT_BLOCK,
             "multi_hop_mix_quant.cu", "kRegThreads"),
            ("multi_hop_mix._MAX_SMEM", mh._MAX_SMEM, "retract.cu",
             "kMaxSmem"),
            ("multi_hop_mix._MAX_SMEM", mh._MAX_SMEM, "stiefel_project.cu",
             "kMaxSmem"),
            ("retract.MAX_R", rt.MAX_R, "retract.cu", "kMaxR"),
            ("paged_decode.CHUNK_KEYS", pd.CHUNK_KEYS, "paged_decode.cu",
             "kChunk"),
            ("leaves.MAX_LEAVES", leaves.MAX_LEAVES, "leaves.cuh",
             "kMaxLeaves"),
            ("ops._MAX_HEAD_DIM", ops._MAX_HEAD_DIM, "attention.cuh",
             "kMaxHeadDim"),
            ("ops._MAX_BWD_HEAD_DIM", ops._MAX_BWD_HEAD_DIM,
             "flash_attention_bwd.cu", "kMaxDim"),
            ("multi_hop_mix._MAX_SMEM", mh._MAX_SMEM, "attention.cuh",
             "kMaxSmem")):
        want = source_constant(file, name)
        if got != want:
            bad(what, f"{got} in the wrapper, {name} = {want} in {file}")

    # multi_hop_mix: the widest block of 32..256 columns whose (n, width)
    # fp32 tile fits (n > MAX_REG_ROWS), 64 threads in registers below;
    # every column of a leaf of f columns in ceil(f / width) blocks
    largest = smem // (32 * 4)
    for n in sorted(set(range(1, 70)) | {127, 128, 129, 227, 1009,
                                         largest, largest + 1}):
        try:
            width = mh.block_width(n)
        except ValueError:
            if n <= largest:
                bad(f"multi_hop_mix n={n}", "block_width raises for a ring "
                    "whose 32-column tile fits")
            continue
        if n > largest:
            bad(f"multi_hop_mix n={n}", f"block width {width} for a ring "
                f"whose 32-column tile ({n * 128} bytes) does not fit")
        if width % 32 or not 32 <= width <= 256:
            bad(f"multi_hop_mix n={n}", f"block width {width} is no "
                f"multiple of 32 in [32, 256]")
        if n > mh.MAX_REG_ROWS and (n * width * 4 > smem or (
                width < 256 and n * 2 * width * 4 <= smem)):
            bad(f"multi_hop_mix n={n}", f"block width {width}: not the "
                f"widest whose tile fits {smem} bytes")
        for f in RAGGED:
            blocks = -(-f // width)
            if blocks * width < f or (blocks - 1) * width >= f:
                bad(f"multi_hop_mix n={n} f={f}",
                    f"{blocks} blocks of {width} do not cover {f} columns")
    for f in RAGGED:
        blocks = -(-f // mh.QUANT_BLOCK)
        if blocks * mh.QUANT_BLOCK < f or (blocks - 1) * mh.QUANT_BLOCK >= f:
            bad(f"multi_hop_mix_quant f={f}", f"{blocks} blocks of "
                f"{mh.QUANT_BLOCK} do not cover {f} columns")
    # grouped launches: every leaf in exactly one group of <= MAX_LEAVES
    for count in RAGGED[:12]:
        groups = [list(range(at, min(at + leaves.MAX_LEAVES, count)))
                  for at in range(0, count, leaves.MAX_LEAVES)]
        if sorted(j for g in groups for j in g) != list(range(count)) or \
                any(len(g) > leaves.MAX_LEAVES for g in groups):
            bad(f"leaves count={count}", f"groups {groups} do not cover "
                f"the leaves once each")
    # paged_decode: chunks of whole pages (a page above CHUNK_KEYS cut into
    # CHUNK_KEYS-token pieces) that cover every key position once
    for m_pages in (1, 2, 3, 7, 16, 18, 97, 128):
        for ps in (1, 3, 8, 16, 33, 64, 100):
            chunk, n_chunks = pd.split_plan(m_pages, ps)
            keys = m_pages * ps
            whole = chunk % ps == 0 or (ps > pd.CHUNK_KEYS
                                        and chunk == pd.CHUNK_KEYS)
            if not (0 < chunk <= pd.CHUNK_KEYS and whole
                    and n_chunks * chunk >= keys
                    and (n_chunks - 1) * chunk < keys):
                bad(f"paged_decode m_pages={m_pages} page={ps}",
                    f"chunk {chunk} x {n_chunks} for {keys} keys")
    # fused_retract's (r, r) stage: one block of r * r threads up to
    # kSmallR, then the clusters in order of their padded order CS * P
    small = source_constant("retract.cu", "kSmallR")
    if 6 * small * small * 4 > smem or small * small > 1024:
        bad("fused_retract r<=kSmallR", f"one block of {small}^2 threads "
            f"and {6 * small * small * 4} bytes")
    cfgs = _retract_configs()
    orders = [cs * p for cs, p, _, _ in cfgs.values()]
    if sorted(orders) != orders or not orders or orders[-1] != rt.MAX_R:
        bad("fused_retract Cfg", f"padded orders {orders} of {list(cfgs)}: "
            f"not increasing to MAX_R = {rt.MAX_R}")
    for name, (cs, p, tr, tc) in cfgs.items():
        threads = (cs * p // tc) * (p // tr)
        if p % tr or (cs * p) % tc or not 32 <= threads <= 1024 or \
                threads % 32:
            bad(f"fused_retract {name}", f"Cfg<{cs}, {p}, {tr}, {tc}>: "
                f"{threads} threads, or rows not cut evenly")
        if cs > 8:
            bad(f"fused_retract {name}", f"a cluster of {cs} CTAs: above "
                f"the portable 8")
    for r in (*RAGGED[:15], small, small + 1, rt.MAX_R, rt.MAX_R + 1):
        if r <= small or r > rt.MAX_R:
            continue
        if not any(o >= r for o in orders):
            bad(f"fused_retract r={r}", f"no cluster of {orders} covers r")
    return findings


# ---------------------------------------------------------------------------
# attention tiling: flash_attention.cu's own plans (the built library)
# ---------------------------------------------------------------------------

# (hd, hdv) of the attention forward up to its largest head dim: the
# SIMT route's (hd 20, 24 / 40, MLA's 192 / 128, 256) and the
# tensor-core route's (multiples of 16 up to 128)
_TILE_DIMS = ((16, 16), (20, 20), (24, 40), (40, 24), (64, 64), (80, 80),
              (128, 128), (192, 128), (256, 256))


def attention_plans() -> list[dict]:
    """``repro_flash_attention_plan`` at every head-dim pair of
    _TILE_DIMS, ragged S and both dtypes (one head, one sequence: the
    smallest grid, where the tensor-core route splits the keys most):
    {case, S, route, rows, split, bytes}."""
    import ctypes

    from repro_torch.kernels import build
    fn = build.library("flash_attention").repro_flash_attention_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 4)()
    records = []
    for hd, hdv in _TILE_DIMS:
        for s in RAGGED[:15]:
            for bf16 in (0, 1):
                build.check("flash_attention", fn(1, s, 1, hd, hdv, bf16,
                                                  out))
                records.append({
                    "case": f"S={s} hd={hd}/{hdv} "
                            f"{'bf16' if bf16 else 'fp32'}",
                    "S": s, "route": ("simt", "tensor cores")[out[0]],
                    "rows": out[1], "split": out[2], "bytes": out[3]})
    return records


def attention_tiling_findings(records: list[dict], smem_limit: int
                              ) -> list[Finding]:
    """The attention-tiling rule over plan records: the query rows of a
    block cover S in ceil(S / rows) blocks, the SIMT route found a key
    tile (``split`` its key rows) and the tensor-core route at most 4
    warps (rows / 16 down the rows x ``split`` across the keys), the
    bytes within ``smem_limit``."""
    findings = []
    for rec in records:
        rows, split = rec["rows"], rec["split"]
        if rec["route"] == "simt":
            ok = split > 0
            shape = f"R={rows}, BK={split}"
        else:
            ok = rows % 16 == 0 and (rows // 16) * split <= 4
            shape = f"{rows // 16} x {split} warps"
        blocks = -(-rec["S"] // rows) if rows > 0 else 0
        if not ok or rows < 1 or blocks * rows < rec["S"] or \
                rec["bytes"] > smem_limit:
            findings.append(Finding(
                "attention-tiling", f"flash_attention {rec['route']} "
                f"{rec['case']}", f"{shape}, {rec['bytes']} bytes (limit "
                f"{smem_limit})"))
    return findings


# ---------------------------------------------------------------------------
# Hopper budgets: resources at the wrappers' launch configurations (card)
# ---------------------------------------------------------------------------

# (B, S, H, hd, hdv) of the attention forward on the main paths
# (smollm-135m prefill, decode wave and S = T = 4096; the served models'
# head dims: granite 64 / 128, zamba2 80, deepseek-v2's MLA 192 / 128 on
# the SIMT route, the SMOKE dims 16, 20 and 32) and its edges (hd 40 / 24
# on the SIMT route, hd 256)
_ATTN = ((1, 256, 9, 64, 64), (4, 1, 9, 64, 64), (1, 4096, 9, 64, 64),
         (1, 256, 32, 128, 128), (2, 1000, 32, 80, 80),
         (4, 256, 128, 192, 128), (2, 13, 4, 32, 32), (2, 13, 4, 16, 16),
         (2, 13, 4, 20, 20), (1, 256, 9, 40, 24), (1, 64, 4, 256, 256))
# (S, T, hd, hdv) of the attention backward: the LM trainer's step, the
# long and windowed cases, zamba2's hd 80, MLA's and cross-attention's
_ATTN_BWD = ((63, 63, 64, 64), (512, 512, 64, 64), (2048, 2048, 64, 64),
             (63, 63, 80, 80), (63, 63, 48, 32), (256, 1600, 128, 128),
             (37, 61, 40, 24), (63, 63, 128, 128))
# (G, hd) of the paged decode: smollm-135m 9:3, granite-3-2b / 8b 32:8 at
# hd 64 / 128, granite-moe 16:8, a SMOKE GQA
_PAGED = ((3, 64), (4, 64), (4, 128), (2, 64), (2, 32))
# (batch, d, r) of the Stiefel leaves: fair classification's fc1 and head
# (20 nodes), the stress shapes, smollm-135m's stacked LM leaves, and
# xlstm-1.3b's cut on 4 nodes
_STIEFEL = ((20, 784, 64), (20, 64, 3), (20, 1000, 37), (20, 4096, 99),
            (20, 4096, 128), (20, 4096, 256), (8, 576, 257),
            (240, 576, 576), (240, 576, 192), (4, 4096, 4096),
            (4, 4096, 2048))


def budget_cases() -> list[tuple[str, str, str, str, tuple]]:
    """(kernel, case, library, entry, args) of every launch configuration
    the budget pass reads: the configurations the wrappers choose at the
    main paths' shapes and at the edges of each route.  The routes that
    depend on the card (the Stiefel projection's cluster size, the int8
    kernel's shared memory) are asked of the built libraries."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels import multi_hop_mix as mh
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import retract as rt
    from repro_torch.kernels import stiefel_project as sp
    cases = [("ring_mix", "group", "ring_mix", "repro_ring_mix_resources",
              ()),
             ("quant_mix", "group", "quant_mix", "repro_quant_mix_resources",
              ())]
    largest = mh._MAX_SMEM // (32 * 4)
    for n in (*range(1, mh.MAX_REG_ROWS + 1), 33, 40, 64, 128, 227, 512,
              1024, largest):
        cases.append(("multi_hop_mix", f"n={n} width={mh.block_width(n)}",
                      "multi_hop_mix", "repro_multi_hop_mix_resources",
                      (n, mh.block_width(n))))
    quant = build.library("multi_hop_mix_quant")
    quant.repro_multi_hop_mix_quant_smem.restype = ctypes.c_longlong
    for n in range(1, mh.MAX_REG_ROWS + 1):
        for route, label in ((1, "on chip"), (2, "one warp")):
            cases.append(("multi_hop_mix_quant", f"n={n} {label}",
                          "multi_hop_mix_quant",
                          "repro_multi_hop_mix_quant_resources",
                          (n, route)))
    n = 1
    while quant.repro_multi_hop_mix_quant_smem(n) <= mh._MAX_SMEM:
        if n in (1, 3, 8, 20, 32, 33, 64) or \
                quant.repro_multi_hop_mix_quant_smem(n + 1) > mh._MAX_SMEM:
            cases.append(("multi_hop_mix_quant", f"n={n} global",
                          "multi_hop_mix_quant",
                          "repro_multi_hop_mix_quant_resources", (n, 0)))
        n += 1
    for g, hd in _PAGED:
        for m_pages, ps in ((1, 16), (18, 16), (128, 16)):
            _, n_chunks = pd.split_plan(m_pages, ps)
            for bf16 in (0, 1):
                cases.append((
                    "paged_decode", f"G={g} hd={hd} {m_pages * ps} keys "
                    f"{'bf16' if bf16 else 'fp32'}", "paged_decode",
                    "repro_paged_decode_resources",
                    (g, hd, hd, n_chunks, bf16)))
    for b, s, h, hd, hdv in _ATTN:
        for bf16 in (0, 1):
            cases.append((
                "flash_attention", f"B={b} S={s} H={h} hd={hd}/{hdv} "
                f"{'bf16' if bf16 else 'fp32'}", "flash_attention",
                "repro_flash_attention_resources", (b, s, h, hd, hdv, bf16)))
    for s, t, hd, hdv in _ATTN_BWD:
        tc = hd % 16 == 0 and hdv % 16 == 0
        for kernel, label in ((0, "dq"), (1, "dk dv"), (2, "group sum")):
            if kernel < 2 or tc:
                cases.append((
                    "flash_attention_bwd", f"S={s} T={t} hd={hd}/{hdv} "
                    f"{label}", "flash_attention_bwd",
                    "repro_flash_attention_bwd_resources",
                    (s, t, hd, hdv, kernel)))
    for batch, d, r in _STIEFEL:
        stage = ((2, "(r, r) stage"),) if r <= rt.MAX_R else (
            (3, "NS product"), (4, "sym"), (5, "form A"), (6, "scale"),
            (7, "finish"))
        for kernel, label in ((0, "Gram"), (1, "apply"), *stage):
            cases.append(("fused_retract", f"({batch}, {d}, {r}) {label}",
                          "retract", "repro_fused_retract_resources",
                          (batch, d, r, kernel)))
        onchip = sp.cluster_size(d, r) > 0
        for kernel, label in (((0, "on chip"),) if onchip
                              else ((1, "Gram"), (2, "apply"))):
            cases.append(("stiefel_project", f"({batch}, {d}, {r}) {label}",
                          "stiefel_project",
                          "repro_stiefel_project_resources",
                          (batch, d, r, kernel)))
    return cases


def budget_records(device: int = 0) -> list[dict]:
    """Every case of :func:`budget_cases` read on card ``device``: its
    kernel, case and resources (``build.resources``)."""
    import torch

    from repro_torch.kernels import build
    with torch.cuda.device(device):
        return [{"kernel": k, "case": c, **build.resources(lib, entry, *a)}
                for k, c, lib, entry, a in budget_cases()]


def budget_findings(records: list[dict], smem_limit: int) -> list[Finding]:
    """The hopper-budget rule over resource records."""
    findings = []
    for rec in records:
        where = f"{rec['kernel']} {rec['case']}"
        smem = rec["static_smem"] + rec["dyn_smem"]
        if rec["regs"] > REGS_PER_THREAD:
            findings.append(Finding(
                "hopper-budget", where, f"{rec['regs']} registers a thread "
                f"(at most {REGS_PER_THREAD})"))
        if rec["regs"] * rec["threads"] > REGS_PER_SM:
            findings.append(Finding(
                "hopper-budget", where, f"{rec['regs']} registers x "
                f"{rec['threads']} threads = "
                f"{rec['regs'] * rec['threads']} (an SM has "
                f"{REGS_PER_SM})"))
        if smem > smem_limit:
            findings.append(Finding(
                "hopper-budget", where, f"{rec['static_smem']} + "
                f"{rec['dyn_smem']} bytes of shared memory a block (the "
                f"card allows {smem_limit})"))
        if rec["resident"] < 1:
            unit = "cluster" if rec["cluster"] > 1 else "block"
            findings.append(Finding(
                "hopper-budget", where, f"no {unit} resident: the launch "
                f"cannot run"))
    return findings


def smem_limit(device: int = 0) -> int:
    """Bytes of shared memory one block may opt in to on card
    ``device``."""
    import torch
    return int(torch.cuda.get_device_properties(device)
               .shared_memory_per_block_optin)


def run(rules=RULES, device: str = "cuda") -> list[Finding]:
    """The kernel checker's rules in ``rules``; ``attention-tiling`` and
    ``hopper-budget`` read the card of ``device`` and raise for a CPU
    device (the caller leaves them out: ``entrypoints.run_passes`` names
    them as not run)."""
    findings = []
    if "oracle-coverage" in rules:
        findings += check_oracle_coverage()
    if "launch-arithmetic" in rules:
        findings += check_launch_arithmetic()
    card = [r for r in CARD_RULES if r in rules]
    if card:
        import torch
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"{', '.join(card)} read a CUDA card, not "
                             f"{dev}")
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        if "attention-tiling" in rules:
            findings += attention_tiling_findings(attention_plans(),
                                                  smem_limit(index))
        if "hopper-budget" in rules:
            findings += budget_findings(budget_records(index),
                                        smem_limit(index))
    return findings
