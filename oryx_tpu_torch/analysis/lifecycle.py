"""Resource-lifecycle analysis (ownership + release obligations); the JAX
package's ``oryx_tpu/analysis/lifecycle.py``, rule for rule.

The lambda architecture runs for weeks; a leaked thread, bus consumer,
shm guard slot, mmap, socket, or device-resident fold-in session per
restart/chaos event is a slow death. This pass walks the AST hunting
*acquisition sites* and checks that every acquired resource has a
reachable — and idempotent — release path.

What counts as an acquisition (the repo's resource vocabulary):

- ``threading.Thread`` / ``SupervisedThread`` / ``Timer`` construction
- broker handles: ``*.consumer(...)`` (guard slots, sockets,
  server-side sessions) and long-lived ``*.producer(...)`` handles held
  on ``self`` (local producers are almost always ``with``-scoped)
- raw OS resources: ``open``/``*.open``, ``mmap.mmap``,
  ``socket.socket``/``create_connection``, ``subprocess.Popen``
- device-resident fold state: ``FoldInSession`` /
  ``PartitionedFoldInSession`` (HBM buffers live as long as the ref)
- shm ring attach (``_Ring(...)``) and broker/layer/server objects that
  own rings and threads (``ShmBroker``, ``*Layer``, ``*Server``)

Ownership model: a resource assigned to ``self.X`` (or stored into a
``self.X`` container) is *owned by the class* — some method must release
it (call ``close/stop/join/...`` on it, pass it to a releaser like
``join_or_report_leak``, or explicitly drop the reference with
``self.X = None``). A resource bound to a local is *owned by the
function* unless it escapes (returned, yielded, stored on an object,
put in a container, or passed to another call — ownership transfer).

Rules:

- ORX501 exception-path leak: a function-local acquisition IS released
  later in the same function, but the release is not in a ``finally``
  (nor is the acquisition ``with``-managed) and statements that can
  raise sit between acquire and release — an exception strands it.
- ORX502 close-unreachable: a class owns a resource attribute no method
  ever releases.
- ORX503 non-idempotent double-close: a ``close()`` that releases owned
  resources with no idempotency idiom (no ``_closed``-flag check, no
  per-handle None-guard/pop) — double close from a driver + atexit
  double-releases guard slots / sockets.
- ORX504 thread without join/stop wiring: an owned thread object no
  method ever ``join``s (or hands to a joiner).
- ORX505 live-handle overwrite: ``self.X = <acquire>`` outside
  ``__init__`` with no preceding release or None-guard on ``self.X`` —
  the old handle is dropped live.
- ORX506 never-released local: a function-local acquisition that never
  escapes and is never released on ANY path.

Like the lockset pass, this errs quiet: one-level aliasing only, any
call that receives the handle counts as a release/transfer, and
``with``-managed acquisitions are always fine. What still fires is
either a real leak (fix it) or a deliberate design (baseline it with a
justification comment).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path

from oryx_tpu_torch.analysis.core import AnalysisPass, Finding, Module, register

_INIT_METHODS = {"__init__", "__new__", "__post_init__", "__enter__"}

# attribute-call names that release / tear down a resource
_RELEASE_METHODS = {
    "close", "stop", "shutdown", "join", "terminate", "kill", "release",
    "release_slot", "drain", "drop", "disconnect", "server_close", "wait",
    "communicate", "cancel", "unlink", "cleanup", "deinstrument",
}
# a method with one of these names is a teardown context: assigning None
# to an owned attr there counts as an explicit release (drop-the-ref is
# the only way to free GC-owned resources like fold-in sessions)
_TEARDOWN_METHODS = {"close", "stop", "shutdown", "reset", "clear", "teardown",
                     "drain", "__exit__", "__del__", "_reset", "release"}

_THREAD_CTORS = {"Thread", "SupervisedThread", "Timer"}
# constructor names (last dotted segment) -> resource kind
_ACQUIRE_CTORS = {
    "Thread": "thread",
    "SupervisedThread": "thread",
    "Timer": "thread",
    "Popen": "subprocess",
    "FoldInSession": "session",
    "PartitionedFoldInSession": "session",
    "_Ring": "ring",
    "ShmBroker": "broker",
}
# method-call names (x.consumer(...)) -> resource kind
_ACQUIRE_METHODS = {
    "consumer": "consumer",
    "mmap": "mmap",
    "socket": "socket",
    "create_connection": "socket",
}
_OPEN_NAMES = {"open"}
# class-name suffixes that denote resource-owning objects with close()
_ACQUIRE_SUFFIXES = (("Layer", "layer"), ("Server", "server"))


def _call_name(call: ast.Call) -> str | None:
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _acquire_kind(node: ast.AST) -> str | None:
    """Resource kind for an expression, or None. Recognizes direct
    constructor/factory calls only — wrappers are the caller's problem."""
    if not isinstance(node, ast.Call):
        return None
    name = _call_name(node)
    if name is None:
        return None
    if name in _ACQUIRE_CTORS:
        return _ACQUIRE_CTORS[name]
    if isinstance(node.func, ast.Attribute) and name in _ACQUIRE_METHODS:
        return _ACQUIRE_METHODS[name]
    if name in _OPEN_NAMES:
        return "file"
    for suffix, kind in _ACQUIRE_SUFFIXES:
        if name.endswith(suffix) and name != suffix:
            return kind
    return None


def _self_attr(node: ast.AST) -> str | None:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _mentions_self_attr(node: ast.AST, attr: str) -> bool:
    for sub in ast.walk(node):
        if _self_attr(sub) == attr:
            return True
        # getattr(self, "attr", ...) is a mention too — the defensive
        # spelling used before __init__ has run
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Name)
            and sub.func.id == "getattr"
            and len(sub.args) >= 2
            and isinstance(sub.args[0], ast.Name)
            and sub.args[0].id == "self"
            and isinstance(sub.args[1], ast.Constant)
            and sub.args[1].value == attr
        ):
            return True
    return False


def _mentions(node: ast.AST, attr: str, aliases: set) -> bool:
    """self.attr, getattr(self, "attr"), or a one-level local alias."""
    if _mentions_self_attr(node, attr):
        return True
    return any(
        isinstance(n, ast.Name) and n.id in aliases for n in ast.walk(node)
    )


def _can_raise(stmt: ast.stmt) -> bool:
    """Could this statement raise? Calls, raises, attribute chases —
    close enough; pure constants/pass/continue cannot."""
    for sub in ast.walk(stmt):
        if isinstance(sub, (ast.Call, ast.Raise, ast.Assert, ast.Subscript)):
            return True
    return False


# ---------------------------------------------------------------------------
# class-level ownership


@dataclass
class OwnedAttr:
    attr: str
    kind: str
    line: int
    method: str
    container: bool  # stored via self.X[...] = / self.X.append(...)


@dataclass
class ClassOwnership:
    name: str
    path: Path
    owned: dict = field(default_factory=dict)  # attr -> OwnedAttr (first site)
    methods: dict = field(default_factory=dict)  # name -> ast node
    released: set = field(default_factory=set)  # attrs with a release path
    joined: set = field(default_factory=set)  # thread attrs join()ed / handed off
    guarded_overwrites: set = field(default_factory=set)
    overwrites: list = field(default_factory=list)  # (attr, method, line)


def _attr_aliases(body: list[ast.stmt], attr: str) -> set:
    """Local names bound (one level) from an expression mentioning
    ``self.attr`` — loop vars iterating it, pops, direct reads."""
    names: set[str] = set()
    for stmt in body:
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Assign) and _mentions_self_attr(sub.value, attr):
                for tgt in sub.targets:
                    for n in ast.walk(tgt):
                        if isinstance(n, ast.Name):
                            names.add(n.id)
            elif isinstance(sub, (ast.For, ast.AsyncFor)) and _mentions_self_attr(
                sub.iter, attr
            ):
                for n in ast.walk(sub.target):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
            elif isinstance(sub, ast.comprehension) and _mentions_self_attr(
                sub.iter, attr
            ):
                for n in ast.walk(sub.target):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
    return names


def _method_releases(node: ast.AST, attr: str, aliases: set) -> tuple[bool, bool]:
    """(released, joined) for ``self.attr`` within one method body."""
    released = joined = False
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            fn = sub.func
            # self.X.close() / self.X[i].join() / alias.close() / alias.join()
            if isinstance(fn, ast.Attribute) and fn.attr in _RELEASE_METHODS:
                base = fn.value
                hit = _mentions_self_attr(base, attr) or (
                    isinstance(base, ast.Name) and base.id in aliases
                )
                if hit:
                    released = True
                    if fn.attr in ("join", "stop", "terminate", "kill", "cancel"):
                        joined = True
            # self.X (or alias/starred) passed to any call: handoff —
            # join_or_report_leak(self._t), atexit.register(c.close), ...
            for arg in list(sub.args) + [kw.value for kw in sub.keywords]:
                inner = arg.value if isinstance(arg, ast.Starred) else arg
                if _mentions_self_attr(inner, attr) or (
                    isinstance(inner, ast.Name) and inner.id in aliases
                ):
                    # reading an attr of it (self.X.foo as arg) is not a
                    # handoff; the bare handle (or something derived by
                    # subscript/iteration) is
                    if not (
                        isinstance(inner, ast.Attribute)
                        and _self_attr(inner) is None
                    ):
                        released = True
                        joined = True
    return released, joined


def _collect_class(cls: ast.ClassDef, path: Path) -> ClassOwnership:
    own = ClassOwnership(cls.name, path)
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            own.methods[node.name] = node

    for mname, mnode in own.methods.items():
        # one-level transfer: "x = Acquire(...)" then "self.attr = x"
        local_kinds: dict[str, str] = {}
        for sub in ast.walk(mnode):
            if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Call):
                k = _acquire_kind(sub.value)
                if k:
                    for tgt in sub.targets:
                        if isinstance(tgt, ast.Name):
                            local_kinds[tgt.id] = k
        for sub in ast.walk(mnode):
            # self.X = ACQ  /  self.X: T = ACQ  /  a = self.X = ACQ
            targets, value = [], None
            if isinstance(sub, ast.Assign):
                targets, value = sub.targets, sub.value
            elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
                targets, value = [sub.target], sub.value
            if value is None:
                continue
            kind = _acquire_kind(value)
            if kind is None and isinstance(value, ast.Name):
                kind = local_kinds.get(value.id)
            direct_kind = kind
            container = False
            if kind is None and isinstance(value, (ast.ListComp, ast.List)):
                # self.X = [ACQ for ...] / [ACQ, ...]
                for inner in ast.walk(value):
                    k = _acquire_kind(inner)
                    if k:
                        kind, container = k, True
                        break
            if kind is None:
                continue
            for tgt in targets:
                attr = _self_attr(tgt)
                if attr is not None:
                    own.owned.setdefault(
                        attr, OwnedAttr(attr, kind, sub.lineno, mname, container)
                    )
                    if direct_kind and mname not in _INIT_METHODS:
                        own.overwrites.append((attr, mname, sub.lineno, sub))
                elif isinstance(tgt, ast.Subscript):
                    attr = _self_attr(tgt.value)
                    if attr is not None:
                        own.owned.setdefault(
                            attr, OwnedAttr(attr, kind, sub.lineno, mname, True)
                        )
        # self.X.append(ACQ) / self.X.setdefault(k, ACQ)
        for sub in ast.walk(mnode):
            if not isinstance(sub, ast.Call):
                continue
            fn = sub.func
            if (
                isinstance(fn, ast.Attribute)
                and fn.attr in ("append", "add", "setdefault", "insert")
            ):
                attr = _self_attr(fn.value)
                if attr is None:
                    continue
                for arg in sub.args:
                    k = _acquire_kind(arg) or (
                        "thread"
                        if isinstance(arg, ast.Name)
                        and _local_is_thread(mnode, arg.id)
                        else None
                    )
                    if k:
                        own.owned.setdefault(
                            attr, OwnedAttr(attr, k, sub.lineno, mname, True)
                        )

    # release reachability: scan every method for each owned attr
    for attr in own.owned:
        for mname, mnode in own.methods.items():
            aliases = _attr_aliases(mnode.body, attr)
            released, joined = _method_releases(mnode, attr, aliases)
            if released:
                own.released.add(attr)
            if joined:
                own.joined.add(attr)
            # explicit drop in a teardown method: self.X = None / del
            if mname in _TEARDOWN_METHODS or any(
                t in mname for t in ("close", "stop", "shutdown")
            ):
                for sub in ast.walk(mnode):
                    if (
                        isinstance(sub, ast.Assign)
                        and isinstance(sub.value, ast.Constant)
                        and sub.value.value is None
                        and any(_self_attr(t) == attr for t in sub.targets)
                    ):
                        own.released.add(attr)
                        own.joined.add(attr)
                    elif isinstance(sub, ast.Delete) and any(
                        _self_attr(t) == attr for t in sub.targets
                    ):
                        own.released.add(attr)
                        own.joined.add(attr)
    return own


def _local_is_thread(fn_node: ast.AST, name: str) -> bool:
    for sub in ast.walk(fn_node):
        if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Call):
            cname = _call_name(sub.value)
            if cname in _THREAD_CTORS and any(
                isinstance(t, ast.Name) and t.id == name for t in sub.targets
            ):
                return True
    return False


def _check_overwrites(own: ClassOwnership) -> list[Finding]:
    """ORX505: re-acquire into an owned attr with no release/guard."""
    out = []
    flagged = set()
    for attr, mname, line, assign in own.overwrites:
        if own.owned[attr].method == mname and own.owned[attr].line == line:
            # the first (defining) acquisition — only re-acquisitions
            # outside init are overwrite candidates
            if mname in _INIT_METHODS:
                continue
        if (attr, mname) in flagged:
            continue
        mnode = own.methods[mname]
        safe = False
        # preceding release of self.attr in the same method — either
        # self.X.close()/alias.close(), or a bare self-release method
        # ("self.drop(); ... self._sock = sock" — release-before-reacquire)
        aliases = _attr_aliases(mnode.body, attr)
        for sub in ast.walk(mnode):
            if getattr(sub, "lineno", line) >= line:
                continue
            if isinstance(sub, ast.Call):
                fn = sub.func
                if (
                    isinstance(fn, ast.Attribute)
                    and fn.attr in _RELEASE_METHODS
                    and (
                        _mentions_self_attr(fn.value, attr)
                        or (isinstance(fn.value, ast.Name) and fn.value.id in aliases)
                        or (isinstance(fn.value, ast.Name) and fn.value.id == "self")
                    )
                ):
                    safe = True
        # or the assignment sits under a test mentioning self.attr (or a
        # local alias of it): "if self.X is None: self.X = acquire()",
        # "ps = self._s; if ps is None ...: ps = Acquire(); self._s = ps"
        for sub in ast.walk(mnode):
            if isinstance(sub, (ast.If, ast.IfExp, ast.While)) and _mentions(
                sub.test, attr, aliases
            ):
                # ast.IfExp carries single expression nodes where If/While
                # carry statement lists — normalize both arms to lists
                arm = sub.body if isinstance(sub.body, list) else [sub.body]
                orelse = getattr(sub, "orelse", [])
                if not isinstance(orelse, list):
                    orelse = [orelse]
                if any(s is assign for st in arm for s in ast.walk(st)) or any(
                    s is assign for st in orelse for s in ast.walk(st)
                ):
                    safe = True
        # or it's a conditional-expression guard on the same line
        if not safe and isinstance(assign.value, ast.IfExp):
            safe = _mentions(assign.value.test, attr, aliases)
        # or a guard clause earlier in the method bails out when the
        # handle is live: "if self.X is not None: raise/return"
        if not safe:
            for sub in ast.walk(mnode):
                if (
                    isinstance(sub, ast.If)
                    and getattr(sub, "lineno", line) < line
                    and _mentions(sub.test, attr, aliases)
                    and any(
                        isinstance(s, (ast.Raise, ast.Return)) for s in sub.body
                    )
                ):
                    safe = True
        if not safe:
            flagged.add((attr, mname))
            out.append(
                Finding(
                    "lifecycle",
                    "ORX505",
                    own.path,
                    line,
                    f"{own.name}.{attr}",
                    f"{mname}() re-acquires into {attr!r} without releasing "
                    f"or None-checking the live handle it may overwrite "
                    f"(line {line})",
                )
            )
    return out


def _check_double_close(own: ClassOwnership) -> list[Finding]:
    """ORX503: close() releases owned resources with no idempotency
    idiom (flag check, per-handle None-guard, pop-and-release)."""
    out = []
    close = own.methods.get("close")
    if close is None or not own.owned:
        return out
    direct = []  # owned attrs this close() releases directly
    for attr in own.owned:
        aliases = _attr_aliases(close.body, attr)
        released, _ = _method_releases(close, attr, aliases)
        if released:
            direct.append(attr)
    if not direct:
        return out
    # idiom 1: a closed/stopped flag tested anywhere in close()
    for sub in ast.walk(close):
        if isinstance(sub, (ast.If, ast.While, ast.IfExp)):
            for n in ast.walk(sub.test):
                a = _self_attr(n)
                if a and any(t in a for t in ("closed", "stopped", "shut", "done")):
                    return out
    # idiom 2: every directly-released attr is None-guarded or popped,
    # or nulled out after release
    for attr in direct:
        guarded = False
        for sub in ast.walk(close):
            if isinstance(sub, (ast.If, ast.IfExp)) and _mentions_self_attr(
                sub.test, attr
            ):
                guarded = True
            if (
                isinstance(sub, ast.Assign)
                and isinstance(sub.value, ast.Constant)
                and sub.value.value is None
                and any(_self_attr(t) == attr for t in sub.targets)
            ):
                guarded = True
            if isinstance(sub, ast.Call) and (
                isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "pop"
                and _mentions_self_attr(sub.func.value, attr)
            ):
                guarded = True
        if not guarded:
            out.append(
                Finding(
                    "lifecycle",
                    "ORX503",
                    own.path,
                    close.lineno,
                    f"{own.name}.close",
                    f"close() releases {attr!r} with no idempotency idiom "
                    f"(no closed-flag check, None-guard, or pop) — a second "
                    f"close() double-releases it",
                )
            )
            return out  # one finding per close() is enough signal
    return out


def _check_class(own: ClassOwnership) -> list[Finding]:
    findings: list[Finding] = []
    for attr, o in sorted(own.owned.items()):
        if o.kind == "thread":
            if attr not in own.joined and attr not in own.released:
                findings.append(
                    Finding(
                        "lifecycle",
                        "ORX504",
                        own.path,
                        o.line,
                        f"{own.name}.{attr}",
                        f"thread(s) stored in {attr!r} (line {o.line}) are "
                        f"never join()ed or handed to a joiner — stop/join "
                        f"wiring is missing",
                    )
                )
        elif attr not in own.released:
            findings.append(
                Finding(
                    "lifecycle",
                    "ORX502",
                    own.path,
                    o.line,
                    f"{own.name}.{attr}",
                    f"{o.kind} resource {attr!r} acquired in {o.method}() "
                    f"(line {o.line}) has no reachable release path in any "
                    f"method of {own.name}",
                )
            )
    findings.extend(_check_double_close(own))
    findings.extend(_check_overwrites(own))
    return findings


# ---------------------------------------------------------------------------
# function-local ownership


@dataclass
class _Local:
    name: str
    kind: str
    line: int
    stmt_idx: int  # index in the flattened statement order
    node: ast.stmt


class _FunctionScan:
    """Lifecycle of locals within one function body."""

    def __init__(self, fn: ast.AST, path: Path, qualname: str):
        self.fn = fn
        self.path = path
        self.qualname = qualname

    def findings(self) -> list[Finding]:
        acquires: list[_Local] = []
        order: list[ast.stmt] = []

        def flatten(body):
            for st in body:
                order.append(st)
                for f in ast.iter_child_nodes(st):
                    pass
        # flatten all statements in document order
        order = [
            n for n in ast.walk(self.fn) if isinstance(n, ast.stmt) and n is not self.fn
        ]
        order.sort(key=lambda n: (n.lineno, n.col_offset))

        with_managed: set[int] = set()  # id of Call nodes under a with-item
        for sub in ast.walk(self.fn):
            if isinstance(sub, (ast.With, ast.AsyncWith)):
                for item in sub.items:
                    for n in ast.walk(item.context_expr):
                        with_managed.add(id(n))

        for idx, st in enumerate(order):
            if isinstance(st, ast.Assign) and len(st.targets) == 1:
                tgt = st.targets[0]
                if isinstance(tgt, ast.Name):
                    kind = _acquire_kind(st.value)
                    if kind and id(st.value) not in with_managed:
                        acquires.append(_Local(tgt.id, kind, st.lineno, idx, st))

        out: list[Finding] = []
        for loc in acquires:
            state = self._classify(loc, order)
            if state == "leak":
                out.append(
                    Finding(
                        "lifecycle",
                        "ORX506",
                        self.path,
                        loc.line,
                        f"{self.qualname}.{loc.name}",
                        f"{loc.kind} {loc.name!r} acquired at line {loc.line} "
                        f"in {self.qualname}() is never released and never "
                        f"escapes — leaked on every path",
                    )
                )
            elif state == "exception-path":
                out.append(
                    Finding(
                        "lifecycle",
                        "ORX501",
                        self.path,
                        loc.line,
                        f"{self.qualname}.{loc.name}",
                        f"{loc.kind} {loc.name!r} (line {loc.line}) is "
                        f"released outside any finally block; an exception "
                        f"between acquire and release strands it — use "
                        f"try/finally or a context manager",
                    )
                )
        return out

    # -- helpers --------------------------------------------------------

    def _classify(self, loc: _Local, order: list[ast.stmt]) -> str | None:
        """'leak' | 'exception-path' | None (safe)."""
        releases: list[ast.stmt] = []  # statements releasing the local
        risky_between = False
        escaped = False
        rebound = False

        finally_stmts: set[int] = set()
        for sub in ast.walk(self.fn):
            if isinstance(sub, ast.Try):
                for st in sub.finalbody:
                    for n in ast.walk(st):
                        if isinstance(n, ast.stmt):
                            finally_stmts.add(id(n))
                for h in sub.handlers:
                    for st in h.body:
                        for n in ast.walk(st):
                            if isinstance(n, ast.stmt):
                                finally_stmts.add(id(n))

        for idx, st in enumerate(order):
            if idx <= loc.stmt_idx:
                continue
            for sub in ast.walk(st):
                if isinstance(sub, ast.Call):
                    fn = sub.func
                    if (
                        isinstance(fn, ast.Attribute)
                        and fn.attr in _RELEASE_METHODS
                        and isinstance(fn.value, ast.Name)
                        and fn.value.id == loc.name
                    ):
                        releases.append(st)
                        continue
                    for arg in list(sub.args) + [kw.value for kw in sub.keywords]:
                        inner = arg.value if isinstance(arg, ast.Starred) else arg
                        for n in ast.walk(inner):
                            if isinstance(n, ast.Name) and n.id == loc.name:
                                escaped = True
                elif isinstance(sub, (ast.Return, ast.Yield, ast.YieldFrom)):
                    v = getattr(sub, "value", None)
                    if v is not None:
                        for n in ast.walk(v):
                            if isinstance(n, ast.Name) and n.id == loc.name:
                                escaped = True
                elif isinstance(sub, ast.Assign):
                    # stored somewhere (attr/subscript/other name): transfer
                    if any(
                        isinstance(n, ast.Name) and n.id == loc.name
                        for n in ast.walk(sub.value)
                    ):
                        for t in sub.targets:
                            if not isinstance(t, ast.Name):
                                escaped = True
                            elif isinstance(t, ast.Name) and t.id != loc.name:
                                escaped = True  # aliased: give up
                    # rebound before release: original may be overwritten —
                    # conservatively stop tracking
                    if any(
                        isinstance(t, ast.Name) and t.id == loc.name
                        for t in sub.targets
                    ) and not releases:
                        rebound = True
                elif isinstance(sub, (ast.With, ast.AsyncWith)):
                    for item in sub.items:
                        for n in ast.walk(item.context_expr):
                            if isinstance(n, ast.Name) and n.id == loc.name:
                                escaped = True  # with x: manages it
        if escaped or rebound:
            return None
        if not releases:
            return "leak"
        if any(id(st) in finally_stmts for st in releases):
            return None
        # release exists but only on the straight-line path: risky iff a
        # raising statement sits between acquire and the first release
        first_release_idx = min(order.index(st) for st in releases)
        for idx in range(loc.stmt_idx + 1, first_release_idx):
            if _can_raise(order[idx]):
                risky_between = True
                break
        return "exception-path" if risky_between else None


# ---------------------------------------------------------------------------


def _iter_functions(tree: ast.AST):
    """(qualname, node) for module-level and nested functions NOT inside
    a class (class methods go through the ownership analysis)."""

    class V(ast.NodeVisitor):
        def __init__(self):
            self.stack: list[str] = []
            self.out: list[tuple[str, ast.AST]] = []

        def visit_ClassDef(self, node):
            pass  # methods handled by class analysis

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


@register
class LifecyclePass(AnalysisPass):
    pass_id = "lifecycle"
    description = (
        "resource-lifecycle analysis: acquisition sites must have "
        "reachable, exception-safe, idempotent release paths "
        "(ORX501-ORX506)"
    )

    def run(self, modules: list[Module], targets: list[Path]) -> list[Finding]:
        findings: list[Finding] = []
        for mod in modules:
            if mod.tree is None:
                continue
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ClassDef):
                    own = _collect_class(node, mod.path)
                    findings.extend(_check_class(own))
                    # locals inside methods still get the function scan
                    for mname, mnode in own.methods.items():
                        findings.extend(
                            _FunctionScan(
                                mnode, mod.path, f"{node.name}.{mname}"
                            ).findings()
                        )
            for qual, fn in _iter_functions(mod.tree):
                findings.extend(_FunctionScan(fn, mod.path, qual).findings())
        return findings
