"""Torch hot-path hygiene pass: kernel builds and host syncs in loops.

The port's counterpart of the JAX package's ``jaxhot`` pass, under the
same codes and the same loop rule. The port has no ``jit``; what costs
it the same way is building or loading a kernel library (an ``nvcc``
or ``g++`` run, a ``dlopen``, a ``torch.compile`` trace) where a cached
handle would do, and a device->host sync inside a loop:

- ORX301 build-in-loop: a kernel library is built or loaded
  (``_build.build``, ``_build.load``, ``native.get_library``,
  ``ctypes.CDLL``, ``torch.compile``) inside a ``for`` / ``while``
  body.
- ORX302 host-sync-in-loop: inside a loop, ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize()`` or an event's
  ``.synchronize()``, or ``float(x)`` / ``int(x)`` / ``np.asarray(x)``
  where ``x`` is a tensor the same function produced with torch — the
  loop serializes on device->host transfers. Deliberate host
  orchestration points are baselined with a justification, not
  exempted by rule.
- ORX303 uncached-build: one of the ORX301 calls in a function with no
  caching idiom in sight: the function is not ``lru_cache``-decorated,
  stores the result in no module-level memo (a module dict, or a
  ``global`` it assigns) and not on ``self``, no caller memoizes the
  function's result into a module dict, and the callee is not itself a
  loader the pass found memoized (``_build.load`` and
  ``native.get_library`` keep their handles in module memos, so calling
  them is the caching idiom).

Only loops spelled ``for``/``while`` count; comprehensions over small
static tuples are the repo's unpacking idiom, not hot loops.
"""

from __future__ import annotations

import ast
from pathlib import Path

from oryx_tpu_torch.analysis.core import AnalysisPass, Finding, Module, register

# module.function names that build or load a kernel library
_BUILD_CALLS = {
    "_build.build",
    "_build.load",
    "native.get_library",
    "ctypes.CDLL",
    "torch.compile",
}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_SYNC_WRAPPERS = {"float", "int", "asarray"}


def _tail_name(expr: ast.AST) -> str | None:
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def _root_name(expr: ast.AST) -> str | None:
    while isinstance(expr, (ast.Attribute, ast.Subscript, ast.Call)):
        expr = expr.func if isinstance(expr, ast.Call) else expr.value
    return expr.id if isinstance(expr, ast.Name) else None


def _module_name(path: Path) -> str:
    """The name other modules import this one by: the file's stem, or the
    package's directory for an ``__init__.py``."""
    return path.parent.name if path.name == "__init__.py" else path.stem


def _aliases(tree: ast.Module, own: str) -> dict[str, str]:
    """Local name -> the qualified ``module.name`` it stands for, from the
    module's imports and its own top-level functions."""
    out: dict[str, str] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = f"{own}.{node.name}"
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name.rsplit(".", 1)[-1]
                else:
                    top = a.name.split(".", 1)[0]
                    out.setdefault(top, top)
        elif isinstance(node, ast.ImportFrom):
            base = (node.module or "").rsplit(".", 1)[-1]
            for a in node.names:
                local = a.asname or a.name
                # `from pkg import mod` names a module, `from mod import f` a function
                out[local] = f"{base}.{a.name}" if base else a.name
    return out


def _qualified_call(call: ast.Call, aliases: dict[str, str]) -> str | None:
    """``module.function`` a call resolves to, or None."""
    fn = call.func
    if isinstance(fn, ast.Name):
        return aliases.get(fn.id)
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
        base = aliases.get(fn.value.id, fn.value.id)
        return f"{base.rsplit('.', 1)[-1]}.{fn.attr}"
    return None


def _module_memos(tree: ast.Module) -> set:
    """Module-level names bound to a dict (memo candidates)."""
    out = set()
    for node in tree.body:
        value, targets = None, []
        if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            value, targets = node.value, [node.target]
        elif isinstance(node, ast.Assign):
            value, targets = node.value, node.targets
        if isinstance(value, ast.Dict) or (
            isinstance(value, ast.Call) and _tail_name(value.func) == "dict"
        ):
            out.update(t.id for t in targets if isinstance(t, ast.Name))
    return out


def _memoizes(fn: ast.AST, memo_dicts: set) -> bool:
    """Does ``fn`` keep something in a module-level memo: a store into a
    module dict, or an assignment to a name it declares ``global``?"""
    declared = {n for sub in ast.walk(fn) if isinstance(sub, ast.Global) for n in sub.names}
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Subscript) and _root_name(t) in memo_dicts:
                return True
            if isinstance(t, ast.Name) and t.id in declared:
                return True
    return False


def _lru_cached(fn: ast.AST) -> bool:
    for dec in fn.decorator_list:
        base = dec.func if isinstance(dec, ast.Call) else dec
        if _tail_name(base) in ("lru_cache", "cache"):
            return True
    return False


def _memoized_by_callers(tree: ast.Module, memo_dicts: set) -> set:
    """Top-level functions whose result some function stores into a
    module dict (``_memo[key] = builder(...)``)."""
    out = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
            continue
        if any(
            isinstance(t, ast.Subscript) and _root_name(t) in memo_dicts
            for t in node.targets
        ):
            name = _tail_name(node.value.func)
            if name is not None:
                out.add(name)
    return out


def _functions(tree: ast.Module):
    """(qualname, node) for top-level functions and methods of top-level
    classes; nested defs are walked as part of their enclosing one."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield f"{node.name}.{sub.name}", sub


def _loop_nodes(fn: ast.AST) -> set:
    """ids of every node lexically inside a for/while body of fn."""
    inside = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            for stmt in node.body + node.orelse:
                for child in ast.walk(stmt):
                    inside.add(id(child))
    return inside


def _produces_tensor(value: ast.AST, tainted: set) -> bool:
    """A torch call (``torch.topk(...)``), a tensor method on a tainted
    value (``scores.sum()``, ``x.to(dev)``), a slice of one, or a
    ``.cuda()`` copy of anything."""
    if isinstance(value, ast.Subscript):
        return _root_name(value) in tainted
    if not isinstance(value, ast.Call):
        return False
    root = _root_name(value.func)
    if root == "torch":
        return True
    if isinstance(value.func, ast.Attribute) and root in tainted:
        return value.func.attr not in _SYNC_METHODS
    return isinstance(value.func, ast.Attribute) and value.func.attr == "cuda"


def _tainted_names(fn: ast.AST) -> set:
    """Local names bound to tensors the function produced with torch,
    including tuple-unpack targets (to a fixed point: assignment order
    in the walk is not program order)."""
    tainted: set = set()
    assigns = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)]
    changed = True
    while changed:
        changed = False
        for node in assigns:
            if not _produces_tensor(node.value, tainted):
                continue
            for t in node.targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                for elt in elts:
                    if isinstance(elt, ast.Name) and elt.id not in tainted:
                        tainted.add(elt.id)
                        changed = True
    return tainted


def _assigned_to_self(fn: ast.AST) -> set:
    """ids of Call nodes whose result lands on a self attribute."""
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            if any(
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
                for t in node.targets
            ):
                out.add(id(node.value))
    return out


@register
class TorchHotPathPass(AnalysisPass):
    pass_id = "torchhot"
    description = (
        "torch hot-path hygiene: kernel libraries built or loaded in loops "
        "or without a cache, host syncs inside loops (ORX301/302/303)"
    )

    def run(self, modules: list[Module], targets: list[Path]) -> list[Finding]:
        parsed = [m for m in modules if m.tree is not None]
        # loaders whose own body memoizes what they build: calling one is
        # the caching idiom, wherever the call is
        memoized: set = set()
        for mod in parsed:
            own = _module_name(mod.path)
            aliases = _aliases(mod.tree, own)
            memo_dicts = _module_memos(mod.tree)
            for qual, fn in _functions(mod.tree):
                if "." in qual:
                    continue
                builds = any(
                    isinstance(n, ast.Call) and _qualified_call(n, aliases) in _BUILD_CALLS
                    for n in ast.walk(fn)
                )
                if builds and (_lru_cached(fn) or _memoizes(fn, memo_dicts)):
                    memoized.add(f"{own}.{qual}")
        findings: list[Finding] = []
        for mod in parsed:
            findings.extend(self._check_module(mod, memoized))
        return findings

    def _check_module(self, mod: Module, memoized: set) -> list[Finding]:
        tree = mod.tree
        aliases = _aliases(tree, _module_name(mod.path))
        memo_dicts = _module_memos(tree)
        by_callers = _memoized_by_callers(tree, memo_dicts)
        findings: list[Finding] = []
        for qualname, fn in _functions(tree):
            cached = (
                _lru_cached(fn)
                or _memoizes(fn, memo_dicts)
                or fn.name in by_callers
            )
            loops = _loop_nodes(fn)
            tainted = _tainted_names(fn)
            self_cached = _assigned_to_self(fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                in_loop = id(node) in loops
                target = _qualified_call(node, aliases)
                if target in _BUILD_CALLS:
                    if in_loop:
                        findings.append(
                            Finding(
                                "torchhot",
                                "ORX301",
                                mod.path,
                                node.lineno,
                                qualname,
                                f"{target}() inside a loop in {qualname}(): "
                                f"a kernel library built or loaded every iteration",
                            )
                        )
                    elif not (cached or target in memoized or id(node) in self_cached):
                        findings.append(
                            Finding(
                                "torchhot",
                                "ORX303",
                                mod.path,
                                node.lineno,
                                qualname,
                                f"{target}() result in {qualname}() is not cached "
                                f"(no lru_cache, module memo, or self attribute): "
                                f"built or loaded again per call",
                            )
                        )
                    continue
                if not in_loop:
                    continue
                callee = _tail_name(node.func)
                if isinstance(node.func, ast.Attribute) and callee in _SYNC_METHODS:
                    findings.append(
                        Finding(
                            "torchhot",
                            "ORX302",
                            mod.path,
                            node.lineno,
                            f"{qualname}:{callee}",
                            f"host sync .{callee}() inside a loop in "
                            f"{qualname}(): serializes the device pipeline",
                        )
                    )
                elif (
                    callee in _SYNC_WRAPPERS
                    and node.args
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id in tainted
                ):
                    findings.append(
                        Finding(
                            "torchhot",
                            "ORX302",
                            mod.path,
                            node.lineno,
                            f"{qualname}:{node.args[0].id}",
                            f"{callee}({node.args[0].id}) inside a loop in "
                            f"{qualname}() forces a device->host sync per "
                            f"iteration ({node.args[0].id} is a tensor made "
                            f"with torch)",
                        )
                    )
        return findings
