"""oryxlint core: pass registry, finding model, baseline, runner, CLI.

One runner fronts every static check in the repo (the lockset race
detector, the lock-order analyzer, the JAX hot-path hygiene pass, and
the four legacy lints that used to live as separate tools/ scripts).
Tier-1 invokes it once (tests/analysis/test_tree_clean.py); operators
invoke it as ``python -m oryx_tpu_torch.analysis`` or ``oryx-tpu lint``.

Findings are keyed *without* line numbers —
``pass_id:relpath:code:symbol`` — so the checked-in baseline
(oryx_tpu/analysis/baseline.txt) survives unrelated edits to a file.
A baselined finding is suppressed; anything new fails the run. Passes
that model deliberate design decisions (e.g. per-level host syncs in
the batch trainers) are baselined with a justification comment rather
than weakening the rule.
"""

from __future__ import annotations

import argparse
import ast
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent.parent
DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.txt"
# the tree the AST passes walk by default: the package (its tools included)
DEFAULT_TARGETS = (REPO_ROOT / "oryx_tpu_torch",)


@dataclass
class Finding:
    """One problem one pass found at one place."""

    pass_id: str
    code: str  # stable rule id, e.g. ORX101
    path: Path
    line: int
    symbol: str  # the thing flagged (Class.attr, lock pair, call) — part of the baseline key
    message: str

    def key(self, root: Path = REPO_ROOT) -> str:
        try:
            rel = self.path.resolve().relative_to(root)
        except ValueError:
            rel = self.path
        return f"{self.pass_id}:{rel.as_posix()}:{self.code}:{self.symbol}"

    def render(self, root: Path = REPO_ROOT) -> str:
        try:
            rel = self.path.resolve().relative_to(root)
        except ValueError:
            rel = self.path
        return f"{rel.as_posix()}:{self.line}: {self.code} [{self.pass_id}] {self.message}"

    def as_json(self, root: Path = REPO_ROOT) -> dict:
        return {
            "pass": self.pass_id,
            "code": self.code,
            "path": str(self.path),
            "line": self.line,
            "symbol": self.symbol,
            "message": self.message,
            "key": self.key(root),
        }


@dataclass
class Module:
    """A parsed source file shared across AST passes (parse once)."""

    path: Path
    text: str
    tree: ast.AST | None
    error: str | None = None


class AnalysisPass:
    """Base class: subclass, set ``pass_id``, implement ``run``."""

    pass_id: str = "?"
    description: str = ""

    def run(self, modules: list[Module], targets: list[Path]) -> list[Finding]:
        raise NotImplementedError


_REGISTRY: dict[str, AnalysisPass] = {}


def register(p):
    """Class decorator (or instance call): adds the pass to the registry."""
    obj = p() if isinstance(p, type) else p
    _REGISTRY[obj.pass_id] = obj
    return p


def all_passes() -> dict[str, AnalysisPass]:
    _load_builtin_passes()
    return dict(_REGISTRY)


_loaded = False


def _load_builtin_passes() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    # import for side effect: each module register()s its pass
    from oryx_tpu_torch.analysis import (  # noqa: F401
        configkeys,
        deploymanifests,
        durability,
        lifecycle,
        lockorder,
        lockset,
        metricscatalog,
        registryhygiene,
        torchhot,
    )


def finding_from_problem(pass_id: str, code: str, problem: str) -> Finding:
    """Adapt a legacy ``path:lineno: message`` problem line to a Finding.

    The baseline symbol is the first quoted token in the message (the
    offending key/name), keeping the key line-number free like every
    other pass."""
    import re

    path, line, msg = Path("<unknown>"), 1, problem
    m = re.match(r"(?P<path>[^:]+):(?P<line>\d+):\s*(?P<msg>.*)", problem)
    if m:
        path, line, msg = Path(m.group("path")), int(m.group("line")), m.group("msg")
    else:
        m2 = re.match(r"(?P<path>[^:]+):\s*(?P<msg>.*)", problem)
        if m2 and "/" in m2.group("path"):
            path, msg = Path(m2.group("path")), m2.group("msg")
    q = re.search(r"'([^']+)'", msg)
    symbol = q.group(1) if q else ""
    return Finding(pass_id, code, path, line, symbol, msg)


def iter_py_files(targets: list[Path]) -> list[Path]:
    out: list[Path] = []
    for t in targets:
        if t.is_dir():
            out.extend(sorted(t.rglob("*.py")))
        elif t.suffix == ".py":
            out.append(t)
    # fixture trees carry seeded bugs on purpose; never scan them
    return [p for p in out if "fixtures" not in p.parts]


def parse_modules(targets: list[Path]) -> list[Module]:
    modules: list[Module] = []
    for f in iter_py_files(targets):
        try:
            text = f.read_text(encoding="utf-8")
        except OSError as e:
            modules.append(Module(f, "", None, error=f"unreadable: {e}"))
            continue
        try:
            tree = ast.parse(text, filename=str(f))
        except SyntaxError as e:
            modules.append(Module(f, text, None, error=f"syntax error: {e.msg}"))
            continue
        modules.append(Module(f, text, tree))
    return modules


# --------------------------------------------------------------------
# baseline


def load_baseline(path: Path | None) -> set[str]:
    if path is None or not path.exists():
        return set()
    keys: set[str] = set()
    for line in path.read_text(encoding="utf-8").splitlines():
        line = line.split("#", 1)[0].strip()
        if line:
            keys.add(line)
    return keys


def write_baseline(
    path: Path,
    findings: list[Finding],
    root: Path = REPO_ROOT,
    keep_lines: list[str] = (),
) -> None:
    """Write the baseline: ``keep_lines`` are verbatim entry lines carried
    over from the previous file (justification comments intact), then any
    finding keys not already among them."""
    lines = [
        "# oryxlint baseline: accepted findings, one key per line.",
        "# Key format: pass_id:relpath:code:symbol (line-number free, so",
        "# unrelated edits don't churn this file). Regenerate with:",
        "#   python -m oryx_tpu_torch.analysis --update-baseline",
        "# Entries should carry a trailing '# why accepted' comment.",
        "",
    ]
    kept_keys = {ln.split("#", 1)[0].strip() for ln in keep_lines}
    lines.extend(sorted(keep_lines, key=lambda ln: ln.split("#", 1)[0].strip()))
    for key in sorted({f.key(root) for f in findings} - kept_keys):
        lines.append(key)
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")


# --------------------------------------------------------------------
# runner


@dataclass
class RunResult:
    findings: list[Finding]  # unsuppressed
    suppressed: list[Finding]
    stale_baseline: set[str] = field(default_factory=set)

    @property
    def rc(self) -> int:
        return 1 if self.findings else 0


def run_passes(
    targets: list[Path] | None = None,
    select: set[str] | None = None,
    ignore: set[str] | None = None,
    baseline: Path | None = DEFAULT_BASELINE,
) -> RunResult:
    targets = [Path(t) for t in (targets or DEFAULT_TARGETS)]
    passes = all_passes()
    chosen = [
        p
        for pid, p in sorted(passes.items())
        if (select is None or pid in select) and (ignore is None or pid not in ignore)
    ]
    modules = parse_modules(targets)
    findings: list[Finding] = []
    for m in modules:
        if m.error:
            findings.append(
                Finding("parse", "ORX000", m.path, 1, m.path.name, m.error)
            )
    for p in chosen:
        findings.extend(p.run(modules, targets))
    keys = load_baseline(baseline)
    live = [f for f in findings if f.key() not in keys]
    supp = [f for f in findings if f.key() in keys]
    # an entry is stale only when this run could have re-fired it: its
    # pass ran, and its file was in the scan set or is gone from disk
    # entirely (a --select or explicit-path run must not report merely
    # out-of-scope entries as dead); non-.py surfaces belong to the
    # legacy passes, which scan their whole fixed surface when they run
    ran = {p.pass_id for p in chosen} | {"parse"}
    scanned = set()
    for m in modules:
        try:
            rel = m.path.resolve().relative_to(REPO_ROOT)
        except ValueError:
            rel = m.path
        scanned.add(rel.as_posix())
    stale = set()
    for k in keys - {f.key() for f in findings}:
        parts = k.split(":")
        if len(parts) < 4:
            stale.add(k)  # malformed entry: never matchable, surface it
            continue
        pid, rel = parts[0], parts[1]
        judgeable = (
            not rel.endswith(".py")
            or rel in scanned
            or not (REPO_ROOT / rel).exists()
        )
        if pid in ran and judgeable:
            stale.add(k)
    return RunResult(live, supp, stale)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="oryxlint",
        description="Unified static analysis for the oryx_tpu_torch tree.",
    )
    ap.add_argument("paths", nargs="*", help="files/dirs (default: oryx_tpu_torch/)")
    ap.add_argument(
        "--select", help="comma-separated pass ids to run (default: all)"
    )
    ap.add_argument("--ignore", help="comma-separated pass ids to skip")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument(
        "--baseline",
        type=Path,
        default=DEFAULT_BASELINE,
        help="baseline file (default: the checked-in one)",
    )
    ap.add_argument(
        "--no-baseline", action="store_true", help="report baselined findings too"
    )
    ap.add_argument(
        "--update-baseline",
        action="store_true",
        help="rewrite the baseline to accept every current finding",
    )
    ap.add_argument(
        "--list-passes", action="store_true", help="list registered passes and exit"
    )
    args = ap.parse_args(argv)

    if args.list_passes:
        for pid, p in sorted(all_passes().items()):
            print(f"{pid:18s} {p.description}")
        return 0

    targets = [Path(p) for p in args.paths] or None
    select = set(args.select.split(",")) if args.select else None
    ignore = set(args.ignore.split(",")) if args.ignore else None
    baseline = None if args.no_baseline else args.baseline

    if args.update_baseline:
        # MERGE, never clobber: a scoped run (--select / explicit paths)
        # must not drop accepted entries it couldn't re-judge. Entries
        # this run proved stale are pruned; everything else keeps its
        # line verbatim (justification comments survive); new findings
        # land as fresh unannotated keys.
        res = run_passes(targets, select, ignore, baseline=args.baseline)
        keep: list[str] = []
        if args.baseline.exists():
            for ln in args.baseline.read_text(encoding="utf-8").splitlines():
                key = ln.split("#", 1)[0].strip()
                if key and key not in res.stale_baseline:
                    keep.append(ln)
        write_baseline(args.baseline, res.findings, keep_lines=keep)
        print(
            f"oryxlint: baseline rewritten: {len(res.findings)} new, "
            f"{len(keep)} kept, {len(res.stale_baseline)} pruned"
        )
        return 0

    res = run_passes(targets, select, ignore, baseline)
    if args.json:
        print(
            json.dumps(
                {
                    "findings": [f.as_json() for f in res.findings],
                    "suppressed": len(res.suppressed),
                    "stale_baseline": sorted(res.stale_baseline),
                    "rc": res.rc,
                },
                indent=2,
            )
        )
    else:
        for f in res.findings:
            print(f.render())
        for key in sorted(res.stale_baseline):
            print(f"note: stale baseline entry (no longer fires): {key}")
        tail = f"{len(res.findings)} finding(s), {len(res.suppressed)} baselined"
        print(f"oryxlint: {'clean' if res.rc == 0 else tail}" + (f" ({tail})" if res.rc == 0 and res.suppressed else ""))
    return res.rc
