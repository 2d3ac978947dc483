"""Metric/span catalog pass: docs/observability.md vs the code, both
directions (counterpart of ``oryx_tpu/analysis/metricscatalog.py``,
over the port's source).

A metric that exists in code but not in the catalog is invisible to
operators (nobody alerts on a name they don't know exists); a cataloged
name that no longer exists in code is worse — a dashboard or alert
silently watching nothing. The pass checks literal registration and
span sites against the doc tables, placeholder families by fragment,
and the tracing knob table against reference.conf.

The analyzer's own package (oryx_tpu_torch/analysis/) is excluded from the
source scan: these files *describe* registration patterns in prose and
regexes without emitting telemetry.
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

DOC = REPO_ROOT / "docs" / "observability.md"
# the port's tools (oryx_tpu_torch/tools/fleet.py: recovery.seconds) lie
# inside the package
SOURCE_ROOTS = (REPO_ROOT / "oryx_tpu_torch",)
_SELF_DIR = Path(__file__).resolve().parent

# literal registration sites; f-strings deliberately don't match (their
# families are cataloged with <...> placeholders instead)
_METRIC_CALL = re.compile(r'\.(?:counter|gauge|histogram)\(\s*"([^"]+)"\s*\)')
_SPAN_CALL = re.compile(r'(?:tracing\.span|record_span)\(\s*\n?\s*"([^"]+)"')
_DOC_ROW = re.compile(r"^\|\s*`([^`]+)`")


def _sources() -> list[tuple[Path, str]]:
    return [
        (f, f.read_text(encoding="utf-8"))
        for root in SOURCE_ROOTS
        for f in sorted(root.rglob("*.py"))
        if _SELF_DIR not in f.resolve().parents
    ]


def code_names() -> tuple[dict[str, Path], dict[str, Path]]:
    """(metric name -> file, span name -> file) from literal call sites."""
    metrics: dict[str, Path] = {}
    spans: dict[str, Path] = {}
    for f, text in _sources():
        for name in _METRIC_CALL.findall(text):
            metrics.setdefault(name, f)
        for name in _SPAN_CALL.findall(text):
            spans.setdefault(name, f)
    return metrics, spans


def doc_names() -> tuple[set[str], set[str], set[str]]:
    """(metric, span, oryx.tracing knob) names cataloged in the doc.

    Section-driven: the knob table lives under '## Tracing', the span
    table under '### Span catalog', metric tables under
    '## Metric catalog'."""
    metrics: set[str] = set()
    spans: set[str] = set()
    knobs: set[str] = set()
    mode = None
    for line in DOC.read_text(encoding="utf-8").splitlines():
        if line.startswith("#"):
            if "Span catalog" in line:
                mode = "spans"
            elif "Metric catalog" in line:
                mode = "metrics"
            elif line.startswith("## Tracing"):
                mode = "knobs"
            elif line.startswith("## "):
                mode = None
            continue
        m = _DOC_ROW.match(line)
        if not m or mode is None:
            continue
        name = m.group(1)
        if name in ("metric", "span", "knob"):  # header rows
            continue
        if mode == "spans":
            spans.add(name)
        elif mode == "metrics":
            metrics.add(name)
        elif mode == "knobs":
            knobs.add(name)
    return metrics, spans, knobs


def _fragments(pattern: str) -> list[str]:
    """Literal fragments of a catalog entry around <...> placeholders."""
    return [frag for frag in re.split(r"<[^>]*>", pattern) if frag]


def _exists_in_code(pattern: str, blob: str) -> bool:
    if "<" in pattern:
        return all(frag in blob for frag in _fragments(pattern))
    return f'"{pattern}"' in blob or f"'{pattern}'" in blob


def tracing_knob_keys() -> set[str]:
    """reference.conf's oryx.tracing block (the knob source of truth)."""
    from oryx_tpu_torch.common import config as C

    return set(C.get_default().get_config("oryx.tracing").as_dict().keys())


def run_lint(code_names_fn=None) -> tuple[int, list[str], str]:
    """(exit code, problem lines, engine used). ``code_names_fn`` stands
    in for :func:`code_names` (tests seed the code's names with it)."""
    collect = code_names_fn or code_names
    problems: list[str] = []
    if not DOC.exists():
        return 1, [f"{DOC}: missing"], "lint_metrics"
    code_metrics, code_spans = collect()
    doc_metrics, doc_spans, doc_knobs = doc_names()
    blob = "\n".join(text for _, text in _sources())

    for name, f in sorted(code_metrics.items()):
        if name not in doc_metrics:
            problems.append(
                f"{f}: metric {name!r} is not cataloged in {DOC.name}"
            )
    for name, f in sorted(code_spans.items()):
        if name not in doc_spans:
            problems.append(
                f"{f}: span {name!r} is not cataloged in {DOC.name}"
            )
    for name in sorted(doc_metrics):
        if not _exists_in_code(name, blob):
            problems.append(
                f"{DOC.name}: cataloged metric {name!r} does not appear in "
                f"the code"
            )
    for name in sorted(doc_spans):
        if not _exists_in_code(name, blob):
            problems.append(
                f"{DOC.name}: cataloged span {name!r} does not appear in "
                f"the code"
            )

    knobs = {f"oryx.tracing.{k}" for k in tracing_knob_keys()}
    for knob in sorted(knobs - doc_knobs):
        problems.append(f"{DOC.name}: tracing knob {knob!r} is not cataloged")
    for knob in sorted(doc_knobs - knobs):
        problems.append(
            f"{DOC.name}: cataloged knob {knob!r} is not in reference.conf"
        )
    return (1 if problems else 0), problems, "lint_metrics"


@register
class MetricsCatalogPass(AnalysisPass):
    pass_id = "metrics"
    description = (
        "metric/span names vs docs/observability.md catalog, both "
        "directions, plus the tracing knob table"
    )

    def run(self, modules: list[Module], targets: list[Path]) -> list[Finding]:
        _, problems, _ = run_lint()
        return [
            finding_from_problem(self.pass_id, "ORX404", p) for p in problems
        ]
