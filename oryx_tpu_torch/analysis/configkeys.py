"""Config-key pass: the silent-failure knob blocks (counterpart of
``oryx_tpu/analysis/configkeys.py``, against the port's reference.conf).

A mistyped key under these prefixes fails SILENTLY: the HOCON overlay
accepts any path, the subsystem only reads the keys it knows, and the
operator ships with the default behavior still on. The pass walks the
repo's Python/conf/markdown sources for dotted key references and
rejects any key the matching reference.conf block (the single source
of truth for each knob set) does not declare.

Linted prefixes:
  oryx.serving.scan.ann   — ANN tier of the serving scan (incl. maintain.*)
  oryx.serving.store.tier — tiered HBM/RAM/disk item store
  oryx.serving.ab         — online experiment traffic split (docs/experiments.md)
  oryx.serving.overload   — admission control / shed ladder
  oryx.fleet.autoscale    — predictive fleet autoscaler
  oryx.bus.shm            — shared-memory ring transport
  oryx.ml.gate.online     — evidence-gated online promotion
  oryx.speed.parse        — native columnar input parse stage
  oryx.speed.pipeline     — three-stage speed-layer pipeline
  oryx.tenancy            — multi-tenant lambda (oryx_tpu_torch/tenancy/)
  oryx.tracing            — distributed tracer (common/tracing.py)
"""

from __future__ import annotations

import re
from pathlib import Path

from oryx_tpu_torch.analysis.core import (
    REPO_ROOT,
    AnalysisPass,
    Finding,
    Module,
    finding_from_problem,
    register,
)

ANN_PREFIX = "oryx.serving.scan.ann"
LINTED_PREFIXES = (
    ANN_PREFIX,
    "oryx.bus.shm",
    "oryx.fleet.autoscale",
    "oryx.ml.gate.online",
    "oryx.serving.ab",
    "oryx.serving.native",
    "oryx.serving.overload",
    "oryx.serving.store.tier",
    "oryx.speed.parse",
    "oryx.speed.pipeline",
    "oryx.tenancy",
    "oryx.tracing",
)
# the package (its tools included), and the tests and docs that name its
# knobs; the repo's root tools/ belongs to the JAX package
DEFAULT_TARGETS = [
    REPO_ROOT / "oryx_tpu_torch",
    REPO_ROOT / "tests",
    REPO_ROOT / "docs",
]
# self-referential tooling: the analyzer's own sources describe key
# patterns, they don't consume knobs
_SELF_DIRS = (Path(__file__).resolve().parent,)

# dotted reference in code/docs/conf: <prefix>.<key>
_DOTTED = {
    prefix: re.compile(re.escape(prefix) + r"\.([A-Za-z0-9][A-Za-z0-9-]*)")
    for prefix in LINTED_PREFIXES
}


def known_keys(prefix: str) -> set[str]:
    """The knob set reference.conf declares under `prefix`."""
    from oryx_tpu_torch.common import config as C

    block = C.get_default().get_config(prefix)
    return set(block.as_dict().keys())


def known_ann_keys() -> set[str]:
    """The ANN knob set (kept for the original single-prefix API)."""
    return known_keys(ANN_PREFIX)


def _iter_source_files(paths: list[Path]):
    for p in paths:
        if p.is_dir():
            for ext in ("*.py", "*.conf", "*.md"):
                yield from sorted(p.rglob(ext))
        elif p.suffix in (".py", ".conf", ".md"):
            yield p


def _skip(path: Path) -> bool:
    rp = path.resolve()
    return any(str(rp).startswith(str(d) + "/") for d in _SELF_DIRS)


def _lint_file(path: Path, known: dict[str, set[str]]) -> list[str]:
    problems: list[str] = []
    try:
        text = path.read_text(encoding="utf-8")
    except OSError as e:  # unreadable file: surface, don't crash the gate
        return [f"{path}: unreadable: {e}"]
    for lineno, line in enumerate(text.splitlines(), 1):
        for prefix, pattern in _DOTTED.items():
            for m in pattern.finditer(line):
                key = m.group(1)
                if key not in known[prefix]:
                    problems.append(
                        f"{path}:{lineno}: unknown config key "
                        f"{prefix}.{key!r} (declared: "
                        f"{', '.join(sorted(known[prefix]))})"
                    )
    return problems


def run_lint(paths: list[Path] | None = None) -> tuple[int, list[str], str]:
    """Returns (exit code, problem lines, engine used)."""
    paths = paths or DEFAULT_TARGETS
    known = {prefix: known_keys(prefix) for prefix in LINTED_PREFIXES}
    problems: list[str] = []
    for f in _iter_source_files(paths):
        if _skip(f):
            continue
        problems.extend(_lint_file(f, known))
    return (1 if problems else 0), problems, "config-keys"


@register
class ConfigKeysPass(AnalysisPass):
    pass_id = "config-keys"
    description = (
        "dotted oryx.* knob references must exist in reference.conf "
        "(silent-failure prevention)"
    )

    def run(self, modules: list[Module], targets: list[Path]) -> list[Finding]:
        # the knob check has its own default target set (docs + tests
        # included); explicit CLI paths narrow it
        from oryx_tpu_torch.analysis import core as _core

        on_defaults = {Path(t).resolve() for t in targets} == {
            Path(t).resolve() for t in _core.DEFAULT_TARGETS
        }
        _, problems, _ = run_lint(None if on_defaults else list(targets))
        return [
            finding_from_problem(self.pass_id, "ORX401", p) for p in problems
        ]
