"""Repo-specific lint rules for the port's tree (DESIGN.md §12).

The port of ``repro.analysis.lint``.  Six AST rules encode conventions
that ordinary linters cannot know:

``packed-key-guard``
    Any module that packs integer keys by multiply-add or shift into a
    ``key``/``gseq``-named variable must carry an overflow guard — a
    ``_check_*_capacity`` helper or an explicit ``1 << 63`` capacity
    comparison.  Silent int64 wraparound in a packed key reorders
    merges without any exception.

``unseeded-random``
    No ``np.random.<fn>`` global-state draws, no stdlib
    ``random.<fn>`` module-level draws, and no draw from torch's
    global generator — ``torch.rand``/``randn``/``randint``/
    ``randperm``/``normal``/``bernoulli``/``multinomial`` or an
    in-place ``.normal_``/``.uniform_``/``.random_``/``.bernoulli_``/
    ``.exponential_`` called without ``generator=`` — so every run is
    replayable from its seeds (``np.random.default_rng(seed)``,
    ``random.Random(seed)``, a seeded ``torch.Generator``).  The torch
    half is the port's own: JAX draws only from explicit keys.

``oracle-coverage``
    Every ``_reference_*`` oracle defined in ``src/repro_torch`` must
    be exercised by at least one file under ``tests/`` — an
    unreferenced oracle silently stops pinning the fast path.

``wall-clock``
    No ``time.time()``/``time.monotonic()`` in the deterministic
    merge/ordering modules (:data:`DETERMINISTIC_MODULES`).  Result
    ordering there is defined by packed sequence numbers, never by
    wall-clock reads (``scheduler.py``'s flush deadline is wall-clock
    *by design* and is not in the list).

``patch-mutation``
    ``PlanPatch`` fields are only mutated inside
    ``repro_torch/dist/replan.py`` (``apply_plan_patch`` and the
    planners) — anywhere else, a staged patch is immutable until its
    barrier.

``docstring-coverage``
    Every public class, function, and public-class method in
    ``repro_torch/serve`` and ``repro_torch/dist`` carries a docstring.

Scope: every module of ``src/repro_torch``, the root ``chip_smoke.py``,
and each file under ``benchmarks/`` that imports ``repro_torch`` (the
reference's benches are the reference lint's); the last two get the
first four rules, as the reference's benches do.  ``tests/`` is read
for ``oracle-coverage`` only.

Run via ``python -m repro_torch.analysis`` (add ``--strict`` to exit
nonzero on findings — the CI gate).
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

#: Modules whose merge/ordering behavior must be wall-clock free.
DETERMINISTIC_MODULES = (
    "repro_torch/serve/decode.py",
    "repro_torch/serve/producers.py",
    "repro_torch/serve/drift.py",
    "repro_torch/serve/tiers.py",
    "repro_torch/dist/replan.py",
    "repro_torch/dist/shard_plan.py",
)

#: The only module allowed to mutate ``PlanPatch`` fields.
PATCH_MUTATION_MODULE = "repro_torch/dist/replan.py"

#: Packages whose public API must be fully docstringed.
DOCSTRING_PACKAGES = ("repro_torch/serve", "repro_torch/dist")

_MUTATORS = {"append", "extend", "insert", "pop", "clear", "remove", "sort"}
_SEEDED_NP = {"default_rng", "Generator", "SeedSequence", "BitGenerator",
              "Philox", "PCG64"}
_SEEDED_STDLIB = {"Random", "SystemRandom"}
#: torch functions and in-place methods that draw from the global
#: generator unless given ``generator=``
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal",
                "bernoulli", "multinomial"}
_TORCH_INPLACE_DRAWS = {"normal_", "uniform_", "random_", "bernoulli_",
                        "exponential_"}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding at ``path:line``."""

    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def _py_files(base: Path) -> List[Path]:
    return sorted(p for p in base.rglob("*.py") if p.is_file())


def _rel(path: Path, root: Path) -> str:
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def _is_key_name(name: str) -> bool:
    low = name.lower()
    return "key" in low or "gseq" in low


def _has_mult(node: ast.AST) -> bool:
    return any(
        isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mult)
        for n in ast.walk(node)
    )


def _packs_key(node: ast.Assign) -> bool:
    """``key = a * b + c`` / ``key = (x << s) | y`` style packing."""
    names = [t.id for t in node.targets if isinstance(t, ast.Name)]
    if not any(_is_key_name(n) for n in names):
        return False
    v = node.value
    if isinstance(v, ast.BinOp) and isinstance(v.op, (ast.Add, ast.BitOr)):
        if _has_mult(v.left) or any(
            isinstance(n, ast.BinOp) and isinstance(n.op, ast.LShift)
            for n in ast.walk(v)
        ):
            return True
    return False


def _module_has_capacity_guard(tree: ast.Module) -> bool:
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if n.name.startswith("_check_") and n.name.endswith("_capacity"):
                return True
        if isinstance(n, ast.Call):
            f = n.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else ""
            )
            if name.startswith("_check_") and name.endswith("_capacity"):
                return True
        if (isinstance(n, ast.BinOp) and isinstance(n.op, ast.LShift)
                and isinstance(n.left, ast.Constant) and n.left.value == 1
                and isinstance(n.right, ast.Constant)
                and n.right.value == 63):
            return True
    return False


def _module_aliases(tree: ast.Module, module: str) -> Set[str]:
    out = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            for a in n.names:
                if a.name == module:
                    out.add(a.asname or module)
    return out


def _stdlib_random_imported(tree: ast.Module) -> bool:
    return any(
        isinstance(n, ast.Import) and any(a.name == "random" for a in n.names)
        for n in ast.walk(tree)
    )


def _check_module(
    rel: str, tree: ast.Module, findings: List[Finding], *,
    in_src: bool,
) -> None:
    np_aliases = _module_aliases(tree, "numpy")
    # chip_smoke.py hands the torch module to its phases as a parameter
    # named ``torch``, so the bare name counts with the imported aliases
    torch_aliases = _module_aliases(tree, "torch") | {"torch"}
    has_stdlib_random = _stdlib_random_imported(tree)
    pack_sites: List[Tuple[int, str]] = []

    for node in ast.walk(tree):
        # -- packed-key-guard: collect packing sites -----------------------
        if isinstance(node, ast.Assign) and _packs_key(node):
            tgt = next(
                t.id for t in node.targets if isinstance(t, ast.Name)
            )
            pack_sites.append((node.lineno, tgt))

        # -- unseeded-random ----------------------------------------------
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            f = node.func
            # np.random.<fn>(...)
            if (isinstance(f.value, ast.Attribute)
                    and f.value.attr == "random"
                    and isinstance(f.value.value, ast.Name)
                    and f.value.value.id in np_aliases
                    and f.attr not in _SEEDED_NP):
                findings.append(Finding(
                    "unseeded-random", rel, node.lineno,
                    f"np.random.{f.attr}() draws from global state — "
                    f"use np.random.default_rng(seed)",
                ))
            # random.<fn>(...)
            elif (has_stdlib_random
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "random"
                    and f.attr not in _SEEDED_STDLIB):
                findings.append(Finding(
                    "unseeded-random", rel, node.lineno,
                    f"random.{f.attr}() draws from global state — "
                    f"use random.Random(seed)",
                ))
            # torch.<draw>(...) / x.<draw>_(...) without generator=
            elif (not any(k.arg == "generator" for k in node.keywords)
                    and ((f.attr in _TORCH_DRAWS
                          and isinstance(f.value, ast.Name)
                          and f.value.id in torch_aliases)
                         or f.attr in _TORCH_INPLACE_DRAWS)):
                findings.append(Finding(
                    "unseeded-random", rel, node.lineno,
                    f"{f.attr}() without generator= draws from torch's "
                    f"global generator — pass a seeded torch.Generator",
                ))

        # -- wall-clock ----------------------------------------------------
        if (rel.endswith(DETERMINISTIC_MODULES)
                and isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "time"
                and node.func.attr in ("time", "monotonic")):
            findings.append(Finding(
                "wall-clock", rel, node.lineno,
                f"time.{node.func.attr}() in a deterministic "
                f"merge/ordering module — ordering must come from packed "
                f"sequence numbers, not the clock",
            ))

        # -- patch-mutation ------------------------------------------------
        if in_src and not rel.endswith(PATCH_MUTATION_MODULE):
            tgt = None
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                tgts = (node.targets if isinstance(node, ast.Assign)
                        else [node.target])
                for t in tgts:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and _is_patch_name(t.value.id)):
                        tgt = (t.value.id, t.attr, node.lineno)
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _MUTATORS
                    and isinstance(node.func.value, ast.Attribute)
                    and isinstance(node.func.value.value, ast.Name)
                    and _is_patch_name(node.func.value.value.id)):
                tgt = (node.func.value.value.id,
                       f"{node.func.value.attr}.{node.func.attr}",
                       node.lineno)
            if tgt is not None:
                findings.append(Finding(
                    "patch-mutation", rel, tgt[2],
                    f"mutates {tgt[0]}.{tgt[1]} outside "
                    f"{PATCH_MUTATION_MODULE} — a staged PlanPatch is "
                    f"immutable until apply_plan_patch at the barrier",
                ))

    if pack_sites and not _module_has_capacity_guard(tree):
        for line, tgt in pack_sites:
            findings.append(Finding(
                "packed-key-guard", rel, line,
                f"packed-key arithmetic into {tgt!r} but the module has "
                f"no _check_*_capacity guard or 1 << 63 capacity check — "
                f"int64 wraparound would silently reorder merges",
            ))


def _is_patch_name(name: str) -> bool:
    return name == "patch" or name.endswith("_patch")


def _check_docstrings(
    rel: str, tree: ast.Module, findings: List[Finding]
) -> None:
    def need(node, qual: str) -> None:
        if not ast.get_docstring(node):
            kind = "class" if isinstance(node, ast.ClassDef) else "def"
            findings.append(Finding(
                "docstring-coverage", rel, node.lineno,
                f"public {kind} {qual} has no docstring",
            ))

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                need(node, node.name)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            need(node, node.name)
            for m in node.body:
                if (isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and not m.name.startswith("_")):
                    need(m, f"{node.name}.{m.name}")


def _imports_port(tree: ast.Module) -> bool:
    for n in ast.walk(tree):
        if isinstance(n, ast.Import) and any(
            a.name.split(".")[0] == "repro_torch" for a in n.names
        ):
            return True
        if (isinstance(n, ast.ImportFrom) and n.module
                and n.module.split(".")[0] == "repro_torch"):
            return True
    return False


def _parse(path: Path, rel: str, findings: List[Finding]):
    try:
        return ast.parse(path.read_text())
    except SyntaxError as exc:
        findings.append(Finding(
            "parse-error", rel, exc.lineno or 0, str(exc.msg)
        ))
        return None


def run_lint(root: Optional[Path] = None) -> List[Finding]:
    """Runs every lint rule over the port's part of a repo tree.

    Args:
      root: repo root containing ``src/repro_torch`` (and optionally
        ``chip_smoke.py``, ``benchmarks/`` and ``tests/``); ``None``
        locates the installed tree.

    Returns:
      All findings, sorted by path then line (empty = clean).
    """
    root = Path(root) if root is not None else _repo_root()
    findings: List[Finding] = []
    oracle_defs: Dict[str, Tuple[str, int]] = {}

    port = root / "src" / "repro_torch"
    for path in _py_files(port) if port.is_dir() else []:
        rel = _rel(path, root)
        tree = _parse(path, rel, findings)
        if tree is None:
            continue
        _check_module(rel, tree, findings, in_src=True)
        if rel.startswith(tuple(f"src/{p}" for p in DOCSTRING_PACKAGES)):
            _check_docstrings(rel, tree, findings)
        for node in ast.walk(tree):
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.name.startswith("_reference_")):
                oracle_defs.setdefault(node.name, (rel, node.lineno))

    # the smoke and the port's benches: the reference lint's rules for
    # benchmarks (no docstring, patch-mutation or oracle rules)
    drivers = [root / "chip_smoke.py"] if (root / "chip_smoke.py").is_file() else []
    if (root / "benchmarks").is_dir():
        drivers += _py_files(root / "benchmarks")
    for path in drivers:
        rel = _rel(path, root)
        tree = _parse(path, rel, findings)
        if tree is None:
            continue
        if rel == "chip_smoke.py" or _imports_port(tree):
            _check_module(rel, tree, findings, in_src=False)

    tests_dir = root / "tests"
    if oracle_defs and tests_dir.is_dir():
        test_text = "\n".join(
            p.read_text() for p in _py_files(tests_dir)
        )
        for name, (rel, line) in sorted(oracle_defs.items()):
            if name not in test_text:
                findings.append(Finding(
                    "oracle-coverage", rel, line,
                    f"{name} is not referenced by any file under tests/ — "
                    f"the oracle no longer pins the fast path",
                ))

    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))
