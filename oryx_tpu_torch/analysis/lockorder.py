"""Static lock-order analyzer (the JAX package's
``oryx_tpu/analysis/lockorder.py``, rule for rule): build the
lock-acquisition nesting graph
and flag cycles (the static half of the TSan-lite watchdog in
oryx_tpu_torch/common/locks.py).

Edges come from two shapes, resolved per module:

- directly nested ``with`` statements over known locks
  (``with self._a: ... with self._b:`` adds a -> b);
- a call made while holding a lock, to a method/function *of the same
  class or module* that itself acquires a lock at any depth
  (``with self._a: self._flush()`` where ``_flush`` takes ``self._b``
  adds a -> b). One level of call indirection covers the repo's
  "caller holds the lock, helper takes the finer one" idiom without
  exploding into a whole-program alias analysis — the runtime watchdog
  owns the cross-module residue.

Lock identity is the canonical attribute (Condition aliases collapse,
matching the lockset pass), qualified as ``Class.attr`` / module
globals as ``<module>.name``. A cycle in the resulting digraph is
reported once per strongly-connected pair as ORX201.
"""

from __future__ import annotations

import ast
from pathlib import Path

from oryx_tpu_torch.analysis.core import AnalysisPass, Finding, Module, register
from oryx_tpu_torch.analysis.lockset import (
    _collect_lock_attrs,
    _module_locks,
    _self_attr,
)


def _canonical(expr: ast.AST, lock_attrs: dict, module_locks: set, cls: str) -> str | None:
    attr = _self_attr(expr)
    if attr is not None and attr in lock_attrs:
        return f"{cls}.{lock_attrs[attr]}"
    if isinstance(expr, ast.Name) and expr.id in module_locks:
        return f"<module>.{expr.id}"
    return None


class _Scope:
    """One class (or the module's function space): methods + lock names."""

    def __init__(self, name, methods, lock_attrs, module_locks):
        self.name = name
        self.methods = methods  # name -> FunctionDef
        self.lock_attrs = lock_attrs
        self.module_locks = module_locks
        # method -> set of lock names acquired anywhere in its body
        self.acquires: dict[str, set] = {}

    def locks_in(self, fn: ast.AST) -> set:
        out = set()
        for node in ast.walk(fn):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    c = _canonical(
                        item.context_expr, self.lock_attrs, self.module_locks, self.name
                    )
                    if c:
                        out.add(c)
        return out


def _edges_for_scope(scope: _Scope) -> dict[tuple, int]:
    """(src, dst) -> witness line."""
    for m, fn in scope.methods.items():
        scope.acquires[m] = scope.locks_in(fn)
    edges: dict[tuple, int] = {}

    def walk(node, held):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            newly = []
            for item in node.items:
                c = _canonical(
                    item.context_expr, scope.lock_attrs, scope.module_locks, scope.name
                )
                if c:
                    for h in held:
                        if h != c:
                            edges.setdefault((h, c), node.lineno)
                    newly.append(c)
            held = held + [c for c in newly if c not in held]
            for stmt in node.body:
                walk(stmt, held)
            return
        if isinstance(node, ast.Call) and held:
            callee = _self_attr(node.func)
            if callee is None and isinstance(node.func, ast.Name):
                callee = node.func.id
            inner = scope.acquires.get(callee, ()) if callee else ()
            for c in inner:
                for h in held:
                    if h != c:
                        edges.setdefault((h, c), node.lineno)
        for child in ast.iter_child_nodes(node):
            walk(child, held)

    for fn in scope.methods.values():
        for stmt in fn.body:
            walk(stmt, [])
    return edges


def module_lock_graph(mod: Module) -> dict[tuple, int]:
    """(src, dst) -> line for every observed nesting in this module."""
    if mod.tree is None:
        return {}
    module_locks = _module_locks(mod.tree)
    edges: dict[tuple, int] = {}
    top_fns = {
        n.name: n
        for n in mod.tree.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    scopes = [_Scope("<module>", top_fns, {}, module_locks)]
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef):
            methods = {
                n.name: n
                for n in node.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
            scopes.append(
                _Scope(node.name, methods, _collect_lock_attrs(node), module_locks)
            )
    for scope in scopes:
        edges.update(_edges_for_scope(scope))
    return edges


def _find_cycles(edges: dict[tuple, int]) -> list[tuple]:
    """Minimal cycle witnesses: (a, b) pairs where both a->b and a path
    b ->* a exist. Deduped on the unordered pair."""
    adj: dict[str, set] = {}
    for (a, b) in edges:
        adj.setdefault(a, set()).add(b)

    def reaches(src, dst):
        seen, work = {src}, [src]
        while work:
            cur = work.pop()
            if cur == dst:
                return True
            for nxt in adj.get(cur, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    work.append(nxt)
        return False

    seen_pairs = set()
    cycles = []
    for (a, b), line in sorted(edges.items(), key=lambda kv: kv[1]):
        pair = frozenset((a, b))
        if pair in seen_pairs:
            continue
        if reaches(b, a):
            seen_pairs.add(pair)
            cycles.append((a, b, line))
    return cycles


@register
class LockOrderPass(AnalysisPass):
    pass_id = "lockorder"
    description = (
        "static lock-acquisition nesting graph; cycles (potential "
        "deadlocks) are ORX201"
    )

    def run(self, modules: list[Module], targets: list[Path]) -> list[Finding]:
        findings = []
        for mod in modules:
            edges = module_lock_graph(mod)
            for a, b, line in _find_cycles(edges):
                findings.append(
                    Finding(
                        "lockorder",
                        "ORX201",
                        mod.path,
                        line,
                        f"{a}<->{b}",
                        f"lock-order cycle: {a} and {b} are acquired in "
                        f"both nesting orders (AB/BA deadlock hazard)",
                    )
                )
        return findings
