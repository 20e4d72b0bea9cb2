"""Analyzer core: findings, suppression parsing, baseline handling and
running the rules — the counterpart of spark_rapids_tpu/analysis/core.py.
Stdlib-only (ast/json/re), so the CLI (`python -m
spark_rapids_tpu_torch.analysis`) runs wherever the package imports.

Suppression grammar (one per line, same line as the finding or a
comment line directly above it)::

    # contract: ok <rule-id> — <why>

The justification is REQUIRED: an empty one still suppresses the base
finding but raises a ``suppression-empty`` finding of its own, so CI
fails until the why is written (a review's vigilance becomes a machine
check, including on the escape hatch).

Baseline file (spark_rapids_tpu_torch/analysis/baseline.json): accepted
pre-existing findings, fingerprinted WITHOUT line numbers so ordinary
edits don't churn it::

    {"version": 1,
     "findings": {"<rule>::<file>::<scope>::<key>":
                  {"count": 2, "why": "..."}}}

Every entry carries a justification too (``baseline-invalid`` fires on
an empty one), and a stale entry — a fingerprint the analyzer no longer
produces — is reported so fixes SHRINK the file instead of leaving
dead weight.
"""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

_SUPPRESS_RE = re.compile(
    r"#\s*contract:\s*ok\s+([A-Za-z0-9_.-]+)\s*(?:[—–-]+\s*(.*?))?\s*$")

#: the repo-relative path baseline-invalid findings name
BASELINE_REL = "spark_rapids_tpu_torch/analysis/baseline.json"

#: the why a `--baseline write` stamps on entries it adds — the tier-1
#: baseline lint rejects it, so an auto-written baseline cannot land
#: without a human justification per entry
UNREVIEWED_WHY = "UNREVIEWED — justify before commit"


class Finding:
    """One rule violation. ``fingerprint`` excludes the line number on
    purpose: baselines must survive unrelated edits to the file."""

    __slots__ = ("rule", "path", "line", "scope", "key", "message")

    def __init__(self, rule: str, path: str, line: int, scope: str,
                 key: str, message: str):
        self.rule = rule
        self.path = path
        self.line = line
        self.scope = scope
        self.key = key
        self.message = message

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}::{self.path}::{self.scope}::{self.key}"

    def to_dict(self) -> Dict[str, object]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "scope": self.scope, "key": self.key,
                "message": self.message,
                "fingerprint": self.fingerprint}

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} "
                f"[{self.scope}] {self.message}")

    def __repr__(self) -> str:  # debugging/pytest output
        return f"<Finding {self.render()}>"


class ModuleInfo:
    """One parsed source file plus its suppression table."""

    def __init__(self, abspath: Path, relpath: str):
        self.abspath = abspath
        self.path = relpath  # repo-relative posix path — the id rules use
        self.source = abspath.read_text()
        self.tree = ast.parse(self.source, filename=str(abspath))
        self.lines = self.source.splitlines()
        #: lineno -> list of (rule_id, why) suppressions on that line
        self.suppressions: Dict[int, List[Tuple[str, str]]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                self.suppressions.setdefault(i, []).append(
                    (m.group(1), (m.group(2) or "").strip()))

    def _comment_only(self, lineno: int) -> bool:
        if not (1 <= lineno <= len(self.lines)):
            return False
        return self.lines[lineno - 1].lstrip().startswith("#")

    def suppression_for(self, rule: str, line: int
                        ) -> Optional[Tuple[str, str, int]]:
        """The (rule, why, lineno) suppression covering a finding of
        `rule` anchored at `line`: same line, or a contiguous block of
        comment lines directly above the statement."""
        candidates = [line]
        up = line - 1
        while self._comment_only(up):
            candidates.append(up)
            up -= 1
        for ln in candidates:
            for rid, why in self.suppressions.get(ln, ()):
                if rid == rule:
                    return (rid, why, ln)
        return None


class AnalysisReport:
    """Everything one run produced, pre-baseline."""

    def __init__(self, root: Path):
        self.root = root
        self.findings: List[Finding] = []
        self.suppressed: List[Tuple[Finding, str, int]] = []  # (f, why, line)
        self.files_scanned = 0

    def sorted_findings(self) -> List[Finding]:
        return sorted(self.findings,
                      key=lambda f: (f.path, f.line, f.rule, f.key))


def _meta_suppression_findings(module: ModuleInfo,
                               known_rules: Iterable[str]) -> List[Finding]:
    """`suppression-empty` for justification-less suppressions and for
    suppressions naming a rule that does not exist (a typo'd id would
    otherwise silently fail to suppress AND never be noticed)."""
    out = []
    known = set(known_rules)
    for lineno, entries in sorted(module.suppressions.items()):
        for rid, why in entries:
            if not why:
                out.append(Finding(
                    "suppression-empty", module.path, lineno,
                    "<suppression>", rid,
                    f"suppression for {rid!r} has no justification — "
                    "write the why after the dash"))
            elif rid not in known:
                out.append(Finding(
                    "suppression-empty", module.path, lineno,
                    "<suppression>", rid,
                    f"suppression names unknown rule {rid!r} "
                    "(typo? it will never match a finding)"))
    return out


def analyze_paths(paths: Iterable[Path], root: Path,
                  registry=None, rules: Optional[Iterable[str]] = None
                  ) -> AnalysisReport:
    """Run every (selected) rule over `paths`. `root` anchors the
    repo-relative paths used in fingerprints; `registry` defaults to
    the engine's DEFAULT_REGISTRY."""
    from . import registry as reg_mod
    from .callgraph import ModuleGraph
    reg = registry if registry is not None else reg_mod.DEFAULT_REGISTRY
    selected = set(rules) if rules is not None else None
    report = AnalysisReport(root)
    modules: List[ModuleInfo] = []
    for p in paths:
        p = Path(p)
        try:
            rel = p.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = p.name
        modules.append(ModuleInfo(p, rel))
    report.files_scanned = len(modules)

    for module in modules:
        graph = ModuleGraph(module.tree)
        raw: List[Finding] = []
        for rule_id, meta in reg_mod.RULES.items():
            if meta.checker is None:
                continue  # meta rules (suppression/baseline lints)
            if selected is not None and rule_id not in selected:
                continue
            raw.extend(meta.checker(module, graph, reg))
        raw.extend(_meta_suppression_findings(module, reg_mod.RULES))
        for f in raw:
            if f.rule == "suppression-empty":
                report.findings.append(f)  # never suppressible
                continue
            sup = module.suppression_for(f.rule, f.line)
            if sup is not None:
                report.suppressed.append((f, sup[1], sup[2]))
            else:
                report.findings.append(f)
    return report


# -- baseline ----------------------------------------------------------------

def load_baseline(path: Path) -> Dict[str, Dict[str, object]]:
    if not Path(path).exists():
        return {}
    text = Path(path).read_text()
    if not text.strip():  # /dev/null or a truncated file = no baseline
        return {}
    data = json.loads(text)
    return dict(data.get("findings", {}))


def write_baseline(path: Path, findings: Iterable[Finding],
                   previous: Optional[Dict[str, Dict[str, object]]] = None
                   ) -> Dict[str, Dict[str, object]]:
    """`--baseline write`: accept the current findings. Existing
    justifications are preserved; NEW entries get the UNREVIEWED stamp
    the baseline lint rejects, so a human must justify each before it
    can land."""
    prev = previous if previous is not None else {}
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.fingerprint] = counts.get(f.fingerprint, 0) + 1
    entries = {}
    for fp in sorted(counts):
        why = prev.get(fp, {}).get("why", UNREVIEWED_WHY)
        entries[fp] = {"count": counts[fp], "why": why}
    Path(path).write_text(json.dumps(
        {"version": 1, "findings": entries}, indent=1, sort_keys=True)
        + "\n")
    return entries


def apply_baseline(findings: List[Finding],
                   baseline: Dict[str, Dict[str, object]]
                   ) -> Tuple[List[Finding], List[str], List[Finding]]:
    """Returns (new_findings, stale_fingerprints, baseline_lint).

    Per fingerprint, up to `count` occurrences are absorbed; the rest
    are new. Baseline slots the run did not consume are stale — an
    entry whose findings were (even partially) fixed must shrink its
    count or disappear. Entries with a missing/empty/UNREVIEWED why or
    a non-positive count come back as `baseline-invalid` findings."""
    remaining = {fp: int(e.get("count", 0)) for fp, e in baseline.items()}
    new: List[Finding] = []
    for f in findings:
        if remaining.get(f.fingerprint, 0) > 0:
            remaining[f.fingerprint] -= 1
        else:
            new.append(f)
    # ANY unconsumed slot is stale — a count=2 entry with one of its
    # findings fixed must shrink to 1, or the leftover slot would
    # silently absorb a future regression of the same fingerprint
    stale = sorted(fp for fp, n in remaining.items() if n > 0)
    lint: List[Finding] = []
    for fp, entry in sorted(baseline.items()):
        why = str(entry.get("why", "")).strip()
        if not why or why == UNREVIEWED_WHY:
            lint.append(Finding(
                "baseline-invalid", BASELINE_REL, 1, "<baseline>", fp,
                f"baseline entry {fp} lacks a justification"))
        if int(entry.get("count", 0)) < 1:
            lint.append(Finding(
                "baseline-invalid", BASELINE_REL, 1, "<baseline>", fp,
                f"baseline entry {fp} has a non-positive count"))
    return new, stale, lint
