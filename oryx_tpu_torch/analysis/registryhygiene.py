"""Registry-subsystem hygiene pass (counterpart of
``oryx_tpu/analysis/registryhygiene.py``).

Runs `ruff check` over oryx_tpu_torch/registry/ when ruff is on PATH; in
environments without ruff (the CI image bakes no extra tools) it
degrades to a stdlib AST pass that still catches the high-signal
problems a subsystem boundary cares about: syntax errors, unused
imports, wildcard imports, and mutable default arguments.
"""

from __future__ import annotations

import ast
import shutil
import subprocess
from pathlib import Path

from oryx_tpu_torch.analysis.core import (
    REPO_ROOT,
    AnalysisPass,
    Finding,
    Module,
    finding_from_problem,
    register,
)

DEFAULT_TARGET = REPO_ROOT / "oryx_tpu_torch" / "registry"


def _ruff_lint(paths: list[Path]) -> tuple[int, list[str]]:
    proc = subprocess.run(
        ["ruff", "check", *[str(p) for p in paths]],
        capture_output=True,
        text=True,
        cwd=REPO_ROOT,
    )
    out = (proc.stdout + proc.stderr).strip()
    return proc.returncode, out.splitlines() if out else []


def _iter_py_files(paths: list[Path]):
    for p in paths:
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p


def _fallback_lint_file(path: Path) -> list[str]:
    problems: list[str] = []
    try:
        tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    except SyntaxError as e:
        return [f"{path}:{e.lineno}: syntax error: {e.msg}"]

    imported: dict[str, int] = {}  # local name -> lineno
    used: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                imported[(a.asname or a.name).split(".")[0]] = node.lineno
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                if a.name == "*":
                    problems.append(f"{path}:{node.lineno}: wildcard import")
                else:
                    imported[a.asname or a.name] = node.lineno
        elif isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            root = node
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name):
                used.add(root.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for default in [*node.args.defaults, *node.args.kw_defaults]:
                if isinstance(default, (ast.List, ast.Dict, ast.Set)):
                    problems.append(
                        f"{path}:{default.lineno}: mutable default argument"
                    )
    # names re-exported via __all__ count as used (registry/__init__.py)
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            used.add(node.value)
    for name, lineno in sorted(imported.items(), key=lambda kv: kv[1]):
        if name not in used and name != "annotations":
            problems.append(f"{path}:{lineno}: unused import {name!r}")
    return problems


def run_lint(paths: list[Path] | None = None) -> tuple[int, list[str], str]:
    """Returns (exit code, problem lines, engine used)."""
    paths = paths or [DEFAULT_TARGET]
    if shutil.which("ruff"):
        rc, lines = _ruff_lint(paths)
        return rc, lines, "ruff"
    problems: list[str] = []
    for f in _iter_py_files(paths):
        problems.extend(_fallback_lint_file(f))
    return (1 if problems else 0), problems, "ast-fallback"


@register
class RegistryHygienePass(AnalysisPass):
    pass_id = "registry"
    description = (
        "registry-subsystem hygiene: ruff when available, stdlib AST "
        "fallback (syntax/unused/wildcard/mutable-default)"
    )

    def run(self, modules: list[Module], targets: list[Path]) -> list[Finding]:
        _, problems, _ = run_lint()
        return [
            finding_from_problem(self.pass_id, "ORX402", p) for p in problems
        ]
