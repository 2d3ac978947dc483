"""Crash-durability hygiene (the static half of docs/durability.md); the
JAX package's ``oryx_tpu/analysis/durability.py``, rule for rule.

Every durable-state mutation in the repo is supposed to be one commit
sequence: same-directory sibling temp, file fsync, atomic rename,
parent-directory fsync. The kill-point sweep
(``oryx_tpu_torch/tools/crash_sweep.py``) proves the instrumented
sequences recover; this pass hunts the sequences that *skipped* the
protocol — the writes a sweep can't find because no crashpoint was ever
threaded through them.

Rules:

- ORX601 rename-without-fsync: a publish-by-rename (``os.replace``,
  ``os.rename``, ``shutil.move``, ``Path.replace``/``rename``) in a
  function that never fsyncs a directory. The rename itself is atomic
  but not durable — until the parent directory entry is synced, a crash
  can un-happen the publish *after* the caller acknowledged it. Call
  ``storage.fsync_dir(target.parent)`` after the rename, or use the
  commit helpers.
- ORX602 cross-filesystem temp: the rename source is tempfile-derived
  (``tempfile.mkstemp``/``mkdtemp``/``NamedTemporaryFile``/...). The
  global temp dir is routinely a different filesystem (tmpfs) than the
  target, where ``os.rename`` fails with EXDEV and ``shutil.move``
  silently degrades to copy+delete — a crash mid-copy leaves a
  half-written target. Stage into a same-directory hidden sibling
  (``storage._tmp_sibling``'s pattern) instead.
- ORX603 state write outside the commit helpers: a direct
  ``Path.write_text``/``write_bytes`` call. Pathlib writes truncate in
  place, fsync nothing, and tear under kill — durable state goes
  through ``storage.commit_bytes``/``commit_text``/``open_write``
  (calls through the ``storage`` module are recognized and exempt).

Deliberate violations — the corruption injectors, whose whole job is
manufacturing torn state — are baselined with justification comments,
not special-cased here.
"""

from __future__ import annotations

import ast
from pathlib import Path

from oryx_tpu_torch.analysis.core import AnalysisPass, Finding, Module, register

# module aliases whose .replace/.rename/.move are renames of paths
_RENAME_MODULE_CALLS = {
    ("os", "replace"),
    ("os", "rename"),
    ("shutil", "move"),
}
# module aliases whose attribute calls are never filesystem renames
_NON_FS_MODULES = {"dataclasses", "re", "string"}

_TEMPFILE_FACTORIES = {
    "mkstemp", "mkdtemp", "mktemp", "NamedTemporaryFile", "TemporaryFile",
    "SpooledTemporaryFile", "TemporaryDirectory", "gettempdir",
}


def _rename_source(call: ast.Call) -> ast.AST | None:
    """The expression being renamed, or None if this call is not a
    publish-by-rename site."""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    if isinstance(fn.value, ast.Name):
        if (fn.value.id, fn.attr) in _RENAME_MODULE_CALLS:
            return call.args[0] if call.args else None
        if fn.value.id in _NON_FS_MODULES:
            return None
    # Path.replace(target) / Path.rename(target): exactly one positional
    # argument (str.replace and friends take two, DataFrame.rename takes
    # keywords) — the base object is the rename source
    if fn.attr in ("replace", "rename") and len(call.args) == 1 and not call.keywords:
        return fn.value
    return None


def _is_tempfile_call(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and isinstance(node.func.value, ast.Name)
        and node.func.value.id == "tempfile"
        and node.func.attr in _TEMPFILE_FACTORIES
    )


def _calls_fsync_dir(fn_node: ast.AST) -> bool:
    for sub in ast.walk(fn_node):
        if isinstance(sub, ast.Call):
            callee = sub.func
            name = callee.attr if isinstance(callee, ast.Attribute) else (
                callee.id if isinstance(callee, ast.Name) else None
            )
            if name == "fsync_dir":
                return True
    return False


def _tainted_names(fn_node: ast.AST) -> set[str]:
    """Names bound (one level) from a tempfile factory result —
    including tuple unpacks like ``fd, name = tempfile.mkstemp()``."""
    out: set[str] = set()
    for sub in ast.walk(fn_node):
        if not isinstance(sub, ast.Assign):
            continue
        if not any(_is_tempfile_call(n) for n in ast.walk(sub.value)):
            continue
        for tgt in sub.targets:
            for n in ast.walk(tgt):
                if isinstance(n, ast.Name):
                    out.add(n.id)
    return out


def _mentions_taint(node: ast.AST, tainted: set[str]) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id in tainted:
            return True
        if _is_tempfile_call(n):
            return True
    return False


def _iter_scopes(tree: ast.AST):
    """(qualname, node) for every function, methods included; classes
    contribute their name to the qualname."""

    class V(ast.NodeVisitor):
        def __init__(self):
            self.stack: list[str] = []
            self.out: list[tuple[str, ast.AST]] = []

        def visit_ClassDef(self, node):
            self.stack.append(node.name)
            self.generic_visit(node)
            self.stack.pop()

        def visit_FunctionDef(self, node):
            qual = ".".join(self.stack + [node.name]) if self.stack else node.name
            self.out.append((qual, node))
            self.stack.append(node.name)
            self.generic_visit(node)
            self.stack.pop()

        visit_AsyncFunctionDef = visit_FunctionDef

    v = V()
    v.visit(tree)
    return v.out


def _direct_statements(fn_node: ast.AST):
    """Walk the function subtree minus nested function bodies, so each
    rename is attributed to its innermost scope exactly once."""
    nested: set[int] = set()
    for sub in ast.walk(fn_node):
        if sub is fn_node:
            continue
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            for inner in ast.walk(sub):
                if inner is not sub:
                    nested.add(id(inner))
    for sub in ast.walk(fn_node):
        if id(sub) not in nested:
            yield sub


@register
class DurabilityPass(AnalysisPass):
    pass_id = "durability"
    description = (
        "crash-durability hygiene: publish-by-rename must fsync the "
        "directory, rename sources must not be tempfile-derived, durable "
        "state goes through the storage commit helpers (ORX601-ORX603)"
    )

    def run(self, modules: list[Module], targets: list[Path]) -> list[Finding]:
        findings: list[Finding] = []
        for mod in modules:
            if mod.tree is None:
                continue
            for qual, fn in _iter_scopes(mod.tree):
                findings.extend(self._check_scope(mod, qual, fn))
            findings.extend(self._check_writes(mod))
        return findings

    def _check_scope(self, mod: Module, qual: str, fn: ast.AST) -> list[Finding]:
        out: list[Finding] = []
        renames = [
            (sub, src)
            for sub in _direct_statements(fn)
            if isinstance(sub, ast.Call) and (src := _rename_source(sub)) is not None
        ]
        if not renames:
            return out
        tainted = _tainted_names(fn)
        synced = _calls_fsync_dir(fn)
        flagged_601 = False
        for call, src in renames:
            if not synced and not flagged_601:
                flagged_601 = True  # one per scope is enough signal
                out.append(
                    Finding(
                        "durability",
                        "ORX601",
                        mod.path,
                        call.lineno,
                        qual,
                        f"{qual}() publishes by rename (line {call.lineno}) "
                        f"but never fsyncs a directory — the rename is not "
                        f"durable until the parent directory entry is "
                        f"synced; call storage.fsync_dir(target.parent) "
                        f"after it or use the storage commit helpers",
                    )
                )
            if _mentions_taint(src, tainted):
                out.append(
                    Finding(
                        "durability",
                        "ORX602",
                        mod.path,
                        call.lineno,
                        qual,
                        f"{qual}() renames a tempfile-derived path (line "
                        f"{call.lineno}) — the global temp dir can sit on a "
                        f"different filesystem, where the rename fails "
                        f"(EXDEV) or shutil.move degrades to a non-atomic "
                        f"copy; stage into a same-directory sibling instead",
                    )
                )
        return out

    def _check_writes(self, mod: Module) -> list[Finding]:
        out: list[Finding] = []
        scopes = _iter_scopes(mod.tree)
        seen: set[str] = set()

        def enclosing(node: ast.AST) -> str:
            best = "<module>"
            for qual, fn in scopes:
                for sub in ast.walk(fn):
                    if sub is node:
                        best = qual
            return best

        for sub in ast.walk(mod.tree):
            if not (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in ("write_text", "write_bytes")
            ):
                continue
            base = sub.func.value
            # calls through the storage module ARE the commit helpers
            if isinstance(base, ast.Name) and base.id == "storage":
                continue
            qual = enclosing(sub)
            if qual in seen:
                continue
            seen.add(qual)
            out.append(
                Finding(
                    "durability",
                    "ORX603",
                    mod.path,
                    sub.lineno,
                    qual,
                    f"{qual}() writes state with Path.{sub.func.attr} (line "
                    f"{sub.lineno}) — truncate-in-place, no fsync, tears "
                    f"under kill; route durable state through "
                    f"storage.commit_bytes/commit_text/open_write",
                )
            )
        return out
