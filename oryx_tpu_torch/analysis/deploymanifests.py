"""Deploy-manifest pass (counterpart of
``oryx_tpu/analysis/deploymanifests.py``, against the port's CLI, health
paths and reference.conf).

The deploy/ tree is the part of the repo no test executes: a GKE
manifest whose container args name a CLI command that doesn't exist, a
probe pointing at a health path the serving layer never registered, a
Dockerfile COPY of a directory that was renamed, or an `oryx.*` key in
the shipped ConfigMap that reference.conf stopped declaring — all fail
at DEPLOY time, on someone else's pager. This pass cross-checks the
manifests against the code's actual surfaces.
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

DEFAULT_TARGETS = [REPO_ROOT / "deploy"]

# endpoints the serving layer's router registers unconditionally
# (oryx_tpu_torch/serving/layer.py _ready/_healthz/_readyz/_metrics)
KNOWN_PROBE_PATHS = {"/ready", "/healthz", "/readyz", "/metrics"}

_ARGS_LINE = re.compile(r"""(?:args|command):\s*\[\s*["']([^"']+)["']""")
_PROBE_PATH = re.compile(r"httpGet:\s*\{?\s*path:\s*([^\s,}]+)")
_DOTTED_ORYX = re.compile(r"\boryx(?:\.[A-Za-z0-9_-]+)+")
_COPY = re.compile(r"^\s*COPY\s+(?:--[^\s]+\s+)*(.+)$")
_CASE_BRANCH = re.compile(r"^\s*([a-z|-]+)\)\s*$")
# script-local meta commands oryx-run.sh resolves itself, not via the CLI
_SCRIPT_META_COMMANDS = {"all", "*"}


def cli_commands() -> set[str]:
    """The port's CLI dispatch table (oryx_tpu_torch/cli.py COMMANDS)."""
    from oryx_tpu_torch.cli import COMMANDS

    return set(COMMANDS)


def known_config_keys() -> set[str]:
    """Every dotted key AND block prefix reference.conf declares —
    flattened from the raw tree (not to_properties, which drops
    null-valued keys like oryx.als.rescorer-provider-class)."""
    from oryx_tpu_torch.common import config as C

    keys: set[str] = set()

    def walk(node, path: str) -> None:
        if path:
            keys.add(path)
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)

    walk(C.get_default().as_dict(), "")
    return keys


def _lint_yaml(path: Path, text: str, commands: set[str], keys: set[str]) -> list[str]:
    problems: list[str] = []
    for lineno, line in enumerate(text.splitlines(), 1):
        m = _ARGS_LINE.search(line)
        if m and m.group(1) not in commands:
            problems.append(
                f"{path}:{lineno}: container command {m.group(1)!r} is not an "
                f"oryx_tpu_torch CLI command (have: {', '.join(sorted(commands))})"
            )
        for m in _PROBE_PATH.finditer(line):
            probe = m.group(1).strip("\"'")
            if probe not in KNOWN_PROBE_PATHS:
                problems.append(
                    f"{path}:{lineno}: probe path {probe!r} is not served "
                    f"(known: {', '.join(sorted(KNOWN_PROBE_PATHS))})"
                )
    problems.extend(_lint_config_keys(path, text, keys))
    return problems


def _lint_config_keys(path: Path, text: str, keys: set[str]) -> list[str]:
    problems: list[str] = []
    for lineno, line in enumerate(text.splitlines(), 1):
        for m in _DOTTED_ORYX.finditer(line):
            ref = m.group(0).rstrip(".")
            if ref == "oryx.conf":  # the config FILE name, not a key
                continue
            if ref not in keys:
                problems.append(
                    f"{path}:{lineno}: config key {ref!r} is not declared "
                    "in reference.conf"
                )
    return problems


def _lint_dockerfile(path: Path, text: str, commands: set[str]) -> list[str]:
    problems: list[str] = []
    for lineno, line in enumerate(text.splitlines(), 1):
        m = _COPY.match(line)
        if m:
            parts = m.group(1).split()
            for src in parts[:-1]:  # last token is the image destination
                if not (REPO_ROOT / src).exists():
                    problems.append(
                        f"{path}:{lineno}: COPY source {src!r} does not exist "
                        "in the repo (build context is the repo root)"
                    )
        m = re.match(r"^\s*CMD\s*\[\s*\"([^\"]+)\"", line)
        if m and m.group(1) not in commands:
            problems.append(
                f"{path}:{lineno}: CMD command {m.group(1)!r} is not an "
                f"oryx_tpu_torch CLI command"
            )
    return problems


def _lint_run_script(path: Path, text: str, commands: set[str]) -> list[str]:
    problems: list[str] = []
    in_dispatch = False
    for lineno, line in enumerate(text.splitlines(), 1):
        # only the COMMAND dispatch table names CLI commands; other case
        # blocks (option parsing) are out of scope
        if re.match(r'^\s*case\s+"\$\{?COMMAND\}?"', line):
            in_dispatch = True
            continue
        if in_dispatch and re.match(r"^\s*esac", line):
            in_dispatch = False
            continue
        if not in_dispatch:
            continue
        m = _CASE_BRANCH.match(line)
        if not m:
            continue
        for cmd in m.group(1).split("|"):
            if cmd and cmd not in commands and cmd not in _SCRIPT_META_COMMANDS:
                problems.append(
                    f"{path}:{lineno}: dispatches {cmd!r}, which is not an "
                    f"oryx_tpu_torch CLI command"
                )
    return problems


def _iter_files(paths: list[Path]):
    for p in paths:
        if p.is_dir():
            yield from sorted(f for f in p.rglob("*") if f.is_file())
        else:
            yield p


def run_lint(paths: list[Path] | None = None) -> tuple[int, list[str], str]:
    """Returns (exit code, problem lines, engine used)."""
    paths = paths or DEFAULT_TARGETS
    commands = cli_commands()
    keys = known_config_keys()
    problems: list[str] = []
    for f in _iter_files(paths):
        try:
            text = f.read_text(encoding="utf-8")
        except (OSError, UnicodeDecodeError) as e:
            problems.append(f"{f}: unreadable: {e}")
            continue
        if f.suffix in (".yaml", ".yml"):
            problems.extend(_lint_yaml(f, text, commands, keys))
        elif f.name == "Dockerfile":
            problems.extend(_lint_dockerfile(f, text, commands))
        elif f.suffix == ".sh":
            problems.extend(_lint_run_script(f, text, commands))
        elif f.suffix in (".md", ".conf"):
            problems.extend(_lint_config_keys(f, text, keys))
    return (1 if problems else 0), problems, "deploy-manifests"


@register
class DeployManifestsPass(AnalysisPass):
    pass_id = "deploy"
    description = (
        "deploy manifests cross-checked against CLI commands, probe "
        "endpoints, COPY sources, and reference.conf keys"
    )

    def run(self, modules: list[Module], targets: list[Path]) -> list[Finding]:
        _, problems, _ = run_lint()
        return [
            finding_from_problem(self.pass_id, "ORX403", p) for p in problems
        ]
