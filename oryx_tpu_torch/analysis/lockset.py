"""Lockset race detector (Eraser-style, adapted to Python AST); the JAX
package's ``oryx_tpu/analysis/lockset.py``, rule for rule.

Per class, the pass answers three questions and cross-checks them:

1. Which instance attributes are *locks*? (``self.X = threading.Lock()
   / RLock() / Condition()`` in any method; ``Condition(self._lock)``
   aliases X to the canonical underlying lock so ``with self._cv:`` and
   ``with self._lock:`` count as the same guard.)
2. Which methods run on *other threads*? (``threading.Thread(
   target=self.m)``, ``SupervisedThread(..., self.m, ...)``,
   ``layer.supervise("name", self.m)``, ``executor.submit(self.m)``,
   ``do_GET``-style handler methods, ``run`` on Thread subclasses —
   plus everything reachable from those through self-calls.)
3. Which attribute accesses happen under which locks? ``with
   self._lock:`` regions extend the current lockset; a method whose
   intra-class call sites *all* hold a lock inherits it (the repo's
   documented "caller holds ``_lock``" idiom); a ``with`` over an
   expression we can't resolve statically (e.g. a lock picked by a
   conditional) taints the region as *unknown* rather than unguarded,
   so dynamic-lock code doesn't false-positive.

Rules (all error severity; fire against the baseline):

- ORX101 mixed-guard write: an attribute accessed under its guard lock
  somewhere is *written* with no lock somewhere else (both outside
  ``__init__``). This is the Eraser condition: the candidate lockset
  for the attribute became empty.
- ORX102 unguarded cross-thread write: in a class with no relevant
  guard at all, an attribute is written from a thread-entry-reachable
  method and also accessed from a non-entry method.
- ORX103 cross-object write to a guarded private attribute: code
  outside class C writes ``obj._attr`` where ``C._attr`` is
  lock-guarded — bypassing C's own discipline (the pipeline
  ``layer._batch_count += 1`` bug shape).
- ORX105 module-global mixed write: a module global is written both
  inside and outside ``with <module lock>:`` (in functions declaring
  ``global``).

Attributes only ever written in ``__init__`` are immutable-after-init
and exempt; reads are never flagged on their own (GIL-atomic reads of
a published reference are the repo's accepted idiom — the analyzer
hunts lost updates and torn multi-field transitions, not volatile
reads).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path

from oryx_tpu_torch.analysis.core import AnalysisPass, Finding, Module, register

_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
# construction and finalization are single-threaded boundaries: the
# object is not yet / no longer shared when these run
_INIT_METHODS = {"__init__", "__new__", "__post_init__", "__init_subclass__", "__del__"}
_HANDLER_METHODS = {"do_GET", "do_POST", "do_PUT", "do_DELETE", "do_HEAD", "handle"}
_THREAD_CTORS = {"Thread", "SupervisedThread", "Timer"}
_SPAWN_METHODS = {"supervise", "submit", "start_new_thread", "spawn"}
_UNKNOWN = "<?>"


def _lock_factory_name(call: ast.AST) -> str | None:
    """'Lock' for threading.Lock(...) / Lock(...) / locks.OrderedLock()."""
    if not isinstance(call, ast.Call):
        return None
    fn = call.func
    name = None
    if isinstance(fn, ast.Attribute):
        name = fn.attr
    elif isinstance(fn, ast.Name):
        name = fn.id
    if name is None:
        return None
    if name in _LOCK_FACTORIES or name in ("OrderedLock", "OrderedRLock"):
        return "Condition" if name == "Condition" else "Lock"
    return None


def _self_attr(node: ast.AST) -> str | None:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


@dataclass
class Access:
    attr: str
    write: bool
    method: str
    line: int
    locks: frozenset


@dataclass
class ClassInfo:
    name: str
    path: Path
    lock_attrs: dict = field(default_factory=dict)  # attr -> canonical attr
    methods: dict = field(default_factory=dict)  # name -> ast.FunctionDef
    accesses: list = field(default_factory=list)
    entries: set = field(default_factory=set)  # thread-entry method names
    call_sites: dict = field(default_factory=dict)  # callee -> [frozenset locks]
    bases: list = field(default_factory=list)


def _collect_lock_attrs(cls: ast.ClassDef) -> dict:
    """attr -> canonical underlying lock attr (Condition(self._x) -> _x)."""
    locks: dict[str, str] = {}
    aliases: dict[str, str] = {}
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = _self_attr(node.targets[0])
            if tgt is None:
                continue
            kind = _lock_factory_name(node.value)
            if kind is None:
                continue
            locks[tgt] = tgt
            if kind == "Condition" and isinstance(node.value, ast.Call) and node.value.args:
                src = _self_attr(node.value.args[0])
                if src is not None:
                    aliases[tgt] = src
    for a, src in aliases.items():
        locks[a] = locks.get(src, src)
        locks.setdefault(src, src)
    return locks


class _MethodWalker(ast.NodeVisitor):
    """Walk one method body tracking the current lockset."""

    def __init__(self, info: ClassInfo, method: str, module_locks: set):
        self.info = info
        self.method = method
        self.module_locks = module_locks
        self.locks: tuple = ()

    # -- lock regions -------------------------------------------------
    def _canon(self, expr: ast.AST) -> str | None:
        attr = _self_attr(expr)
        if attr is not None and attr in self.info.lock_attrs:
            return "self." + self.info.lock_attrs[attr]
        if isinstance(expr, ast.Name) and expr.id in self.module_locks:
            return "mod." + expr.id
        return None

    def visit_With(self, node: ast.With) -> None:
        added = []
        for item in node.items:
            canon = self._canon(item.context_expr)
            if canon is not None:
                added.append(canon)
            elif _looks_like_lock(item.context_expr):
                added.append(_UNKNOWN)
        old = self.locks
        self.locks = old + tuple(a for a in added if a not in old)
        for stmt in node.body:
            self.visit(stmt)
        self.locks = old

    visit_AsyncWith = visit_With

    # -- accesses -----------------------------------------------------
    def _record(self, attr: str, write: bool, line: int) -> None:
        if attr in self.info.lock_attrs:
            return
        self.info.accesses.append(
            Access(attr, write, self.method, line, frozenset(self.locks))
        )

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is not None:
            self._record(attr, isinstance(node.ctx, (ast.Store, ast.Del)), node.lineno)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        # self.X[k] = v mutates the container held by X: count as a write
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            attr = _self_attr(node.value)
            if attr is not None:
                self._record(attr, True, node.lineno)
                self.visit(node.slice)
                return
        self.generic_visit(node)

    # -- calls / thread spawns ---------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        # self.m(...)
        callee = _self_attr(fn)
        if callee is not None and callee in self.info.methods:
            self.info.call_sites.setdefault(callee, []).append(frozenset(self.locks))
        # thread-entry registration: any self.m passed to a spawner
        ctor = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None
        )
        if ctor in _THREAD_CTORS or ctor in _SPAWN_METHODS:
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                m = _self_attr(arg)
                if m is not None and m in self.info.methods:
                    self.info.entries.add(m)
        self.generic_visit(node)

    # nested defs run in their own context; still record entry handoffs
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        old = self.locks
        # a closure may run on another thread; analyze it lock-free is
        # too pessimistic, with current locks too optimistic — keep the
        # enclosing lockset (the dominant repo idiom is inline helpers).
        for stmt in node.body:
            self.visit(stmt)
        self.locks = old

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = lambda self, node: self.generic_visit(node)  # noqa: E731


def _looks_like_lock(expr: ast.AST) -> bool:
    """Heuristic: `with <something lockish>:` — a name/attr containing
    'lock', 'cv', 'cond', or 'mu'. Anything else (files, contexts,
    tracing spans) is not a guard and must not taint the region."""
    label = None
    if isinstance(expr, ast.Attribute):
        label = expr.attr
    elif isinstance(expr, ast.Name):
        label = expr.id
    if label is None:
        return False
    low = label.lower()
    return any(tok in low for tok in ("lock", "_cv", "cond", "_mu", "mutex"))


def _module_locks(tree: ast.AST) -> set:
    out = set()
    for node in tree.body if isinstance(tree, ast.Module) else []:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name) and _lock_factory_name(node.value):
                out.add(tgt.id)
    return out


def _analyze_class(cls: ast.ClassDef, path: Path, module_locks: set) -> ClassInfo:
    info = ClassInfo(cls.name, path)
    info.bases = [
        b.attr if isinstance(b, ast.Attribute) else getattr(b, "id", "")
        for b in cls.bases
    ]
    info.lock_attrs = _collect_lock_attrs(cls)
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info.methods[node.name] = node
    subclasses_thread = any("Thread" in b for b in info.bases)
    handlerish = any("Handler" in b or "Server" in b for b in info.bases)
    for name, node in info.methods.items():
        if name in _HANDLER_METHODS and handlerish:
            info.entries.add(name)
        if name == "run" and subclasses_thread:
            info.entries.add(name)
        walker = _MethodWalker(info, name, module_locks)
        for stmt in node.body:
            walker.visit(stmt)
    return info


def _entry_reachable(info: ClassInfo) -> set:
    """Methods reachable from thread entries via self-calls."""
    reach = set(info.entries)
    # call graph: caller info is not tracked per-edge; approximate with
    # callee sets per method body
    callees: dict[str, set] = {m: set() for m in info.methods}
    for name, node in info.methods.items():
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                callee = _self_attr(sub.func)
                if callee in info.methods:
                    callees[name].add(callee)
    changed = True
    while changed:
        changed = False
        for m in list(reach):
            for c in callees.get(m, ()):
                if c not in reach:
                    reach.add(c)
                    changed = True
    return reach


def _propagate_caller_locks(info: ClassInfo) -> dict:
    """Locks every call site of a method provably holds ('caller holds
    the lock' idiom). Entry methods are invoked lock-free by the runtime
    and get none."""
    inherited: dict[str, frozenset] = {}
    for _ in range(4):  # small fixpoint: chains are short
        changed = False
        for m in info.methods:
            if m in info.entries or m in _INIT_METHODS:
                continue
            sites = info.call_sites.get(m)
            if not sites:
                continue
            eff = None
            for s in sites:
                # a caller's own inherited locks extend its sites too —
                # handled by rerunning the loop with updated accesses
                eff = s if eff is None else (eff & s)
            eff = frozenset(eff or ())
            if inherited.get(m, None) != eff:
                inherited[m] = eff
                changed = True
        if not changed:
            break
    return inherited


def analyze_module(mod: Module) -> tuple[list[ClassInfo], list[Finding]]:
    """All ClassInfos plus the module-global (ORX105) findings."""
    if mod.tree is None:
        return [], []
    module_locks = _module_locks(mod.tree)
    infos = [
        _analyze_class(node, mod.path, module_locks)
        for node in ast.walk(mod.tree)
        if isinstance(node, ast.ClassDef)
    ]
    findings = _check_module_globals(mod, module_locks)
    return infos, findings


def _check_module_globals(mod: Module, module_locks: set) -> list[Finding]:
    if not module_locks:
        return []
    writes: dict[str, list] = {}  # global -> [(guarded, line)]
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        declared = {
            n for sub in ast.walk(node) if isinstance(sub, ast.Global) for n in sub.names
        }
        if not declared:
            continue

        class W(ast.NodeVisitor):
            def __init__(self):
                self.locks = ()

            def visit_With(self, w):
                added = [
                    "mod." + i.context_expr.id
                    for i in w.items
                    if isinstance(i.context_expr, ast.Name)
                    and i.context_expr.id in module_locks
                ]
                if not added and any(
                    _looks_like_lock(i.context_expr) for i in w.items
                ):
                    added = [_UNKNOWN]
                old = self.locks
                self.locks = old + tuple(added)
                for s in w.body:
                    self.visit(s)
                self.locks = old

            visit_AsyncWith = visit_With

            def visit_Name(self, n):
                if n.id in declared and isinstance(n.ctx, ast.Store):
                    writes.setdefault(n.id, []).append((bool(self.locks), n.lineno))

        w = W()
        for stmt in node.body:
            w.visit(stmt)
    out = []
    for name, ws in sorted(writes.items()):
        if name in module_locks:
            continue
        guarded = [line for ok, line in ws if ok]
        unguarded = [line for ok, line in ws if not ok]
        if guarded and unguarded:
            out.append(
                Finding(
                    "lockset",
                    "ORX105",
                    mod.path,
                    unguarded[0],
                    f"<module>.{name}",
                    f"module global {name!r} is written under the module "
                    f"lock (line {guarded[0]}) and without it "
                    f"(line {unguarded[0]})",
                )
            )
    return out


def _check_class(info: ClassInfo) -> list[Finding]:
    inherited = _propagate_caller_locks(info)
    reach = _entry_reachable(info)
    findings: list[Finding] = []

    # effective lockset per access
    by_attr: dict[str, list[Access]] = {}
    eff_locks: dict[int, frozenset] = {}
    for i, a in enumerate(info.accesses):
        eff = a.locks | inherited.get(a.method, frozenset())
        eff_locks[i] = eff
        by_attr.setdefault(a.attr, []).append(a)

    for attr, accesses in sorted(by_attr.items()):
        post_init_writes = [
            a for a in accesses if a.write and a.method not in _INIT_METHODS
        ]
        if not post_init_writes:
            continue  # immutable after construction
        idx = {id(a): eff_locks[i] for i, a in enumerate(info.accesses)}
        guarded = [
            a
            for a in accesses
            if a.method not in _INIT_METHODS
            and any(lk != _UNKNOWN for lk in idx[id(a)])
        ]
        unknown = [a for a in accesses if _UNKNOWN in idx[id(a)]]
        naked_writes = [
            a for a in post_init_writes if not idx[id(a)]
        ]
        guarded_writes = [a for a in guarded if a.write]
        naked_entry_reads = [
            a
            for a in accesses
            if not a.write
            and a.method in reach
            and a.method not in _INIT_METHODS
            and not idx[id(a)]
        ]
        if guarded and naked_writes:
            locks_used = sorted(
                {lk for a in guarded for lk in idx[id(a)] if lk != _UNKNOWN}
            )
            w = naked_writes[0]
            findings.append(
                Finding(
                    "lockset",
                    "ORX101",
                    info.path,
                    w.line,
                    f"{info.name}.{attr}",
                    f"attribute {attr!r} is guarded by "
                    f"{'/'.join(locks_used)} elsewhere but written "
                    f"without a lock in {w.method}() "
                    f"(line {w.line}); candidate lockset is empty",
                )
            )
            continue
        if guarded_writes and naked_entry_reads and info.entries:
            # writes keep the discipline but a hot-path thread reads the
            # attribute lock-free: lost-update-adjacent (stale/torn view)
            r = naked_entry_reads[0]
            locks_used = sorted(
                {lk for a in guarded_writes for lk in idx[id(a)] if lk != _UNKNOWN}
            )
            findings.append(
                Finding(
                    "lockset",
                    "ORX104",
                    info.path,
                    r.line,
                    f"{info.name}.{attr}",
                    f"attribute {attr!r} is written under "
                    f"{'/'.join(locks_used)} but read lock-free on the "
                    f"{r.method}() thread (line {r.line})",
                )
            )
            continue
        if guarded or unknown or not info.entries:
            continue
        entry_writes = [a for a in naked_writes if a.method in reach]
        outside = [
            a for a in accesses if a.method not in reach and a.method not in _INIT_METHODS
        ]
        if entry_writes and outside:
            w = entry_writes[0]
            findings.append(
                Finding(
                    "lockset",
                    "ORX102",
                    info.path,
                    w.line,
                    f"{info.name}.{attr}",
                    f"attribute {attr!r} is written from thread entry "
                    f"{w.method}() (line {w.line}) with no lock and "
                    f"accessed from {outside[0].method}() "
                    f"(line {outside[0].line}) on other threads",
                )
            )
    return findings


def _check_cross_object(
    modules: list[Module], guarded_attrs: dict
) -> list[Finding]:
    findings = []
    for mod in modules:
        if mod.tree is None:
            continue
        for node in ast.walk(mod.tree):
            target = None
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            else:
                continue
            for target in targets:
                if not isinstance(target, ast.Attribute):
                    continue
                base = target.value
                if isinstance(base, ast.Name) and base.id in ("self", "cls"):
                    continue
                attr = target.attr
                owner = guarded_attrs.get(attr)
                if owner is None or not attr.startswith("_"):
                    continue
                findings.append(
                    Finding(
                        "lockset",
                        "ORX103",
                        mod.path,
                        node.lineno,
                        f"{owner}.{attr}",
                        f"write to {attr!r} from outside its class "
                        f"bypasses the lock that guards {owner}.{attr}",
                    )
                )
    return findings


@register
class LocksetPass(AnalysisPass):
    pass_id = "lockset"
    description = (
        "Eraser-style race detector: attributes accessed both inside and "
        "outside their guarding lock (ORX101/102/103/105)"
    )

    def run(self, modules: list[Module], targets: list[Path]) -> list[Finding]:
        findings: list[Finding] = []
        guarded_attrs: dict[str, str] = {}
        infos_per_mod = []
        for mod in modules:
            infos, global_findings = analyze_module(mod)
            findings.extend(global_findings)
            infos_per_mod.append(infos)
            for info in infos:
                inherited = _propagate_caller_locks(info)
                for i, a in enumerate(info.accesses):
                    eff = a.locks | inherited.get(a.method, frozenset())
                    if any(lk != _UNKNOWN for lk in eff):
                        guarded_attrs.setdefault(a.attr, info.name)
        for infos in infos_per_mod:
            for info in infos:
                findings.extend(_check_class(info))
        findings.extend(_check_cross_object(modules, guarded_attrs))
        return findings
