"""The contract analyzer's CLI — the counterpart of tools/contract_check.py,
pointed at the port.

Runs the spark_rapids_tpu_torch.analysis rules over the port's package
and chip_smoke.py and reports findings not covered by a justified
suppression or the checked-in baseline.

Usage:
    python -m spark_rapids_tpu_torch.analysis [paths...]
        [--format text|json] [--baseline PATH | --baseline write]
        [--rules id,id,...]

Exit codes: 0 = clean (all findings suppressed/baselined, no stale or
invalid baseline entries), 1 = new findings / baseline problems,
2 = usage error. `--baseline write` accepts the current findings into
the baseline file (analysis/baseline.json), preserving existing
justifications and stamping new entries UNREVIEWED (the tier-1 baseline
lint rejects that stamp, so a human must justify each before it can
land); it refuses a run scoped by paths or rules. In-process use:
tests/test_torch_contract_check.py drives main() directly.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import core as acore
from .core import analyze_paths
from .scan import default_source_files, repo_root

ROOT = repo_root()
DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"


def build_report(paths=None, rules=None, registry=None):
    """Analyze `paths` (default: the port's scan set). Importable entry
    for tests and tooling."""
    files = [Path(p) for p in paths] if paths else \
        default_source_files(ROOT)
    expanded = []
    for p in files:
        if p.is_dir():
            expanded.extend(sorted(p.rglob("*.py")))
        else:
            expanded.append(p)
    return analyze_paths(expanded, ROOT, registry=registry, rules=rules)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_tpu_torch.analysis",
        description="AST-based engine contract analyzer (the port)")
    ap.add_argument("paths", nargs="*", help="files/dirs to analyze "
                    "(default: spark_rapids_tpu_torch/, chip_smoke.py)")
    ap.add_argument("--format", choices=("text", "json"),
                    default="text")
    ap.add_argument("--baseline", default=None,
                    help="baseline file, or the word 'write' to "
                    "accept current findings into the default file")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default all)")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code not in (0, None) else 0

    rules = [r.strip() for r in args.rules.split(",")] \
        if args.rules else None
    report = build_report(args.paths or None, rules=rules)
    findings = report.sorted_findings()

    if args.baseline == "write":
        if args.paths or args.rules:
            # a scoped run sees only a slice of the findings — writing
            # it would silently drop every out-of-scope entry AND its
            # hand-written justification
            print("contract analyzer: --baseline write requires the "
                  "full default scan set (no paths, no --rules)",
                  file=sys.stderr)
            return 2
        prev = acore.load_baseline(DEFAULT_BASELINE)
        entries = acore.write_baseline(DEFAULT_BASELINE, findings, prev)
        print(f"baseline: wrote {len(entries)} entr"
              f"{'y' if len(entries) == 1 else 'ies'} to "
              f"{DEFAULT_BASELINE}")
        for fp, e in entries.items():
            if e["why"] == acore.UNREVIEWED_WHY:
                print(f"  UNREVIEWED (justify before commit): {fp}")
        return 0

    baseline = acore.load_baseline(
        Path(args.baseline) if args.baseline else DEFAULT_BASELINE)
    new, stale, lint = acore.apply_baseline(findings, baseline)
    problems = new + lint

    if args.format == "json":
        print(json.dumps({
            "version": 1,
            "files_scanned": report.files_scanned,
            "findings": [f.to_dict() for f in new],
            "baseline_lint": [f.to_dict() for f in lint],
            "stale_baseline": stale,
            "suppressed": len(report.suppressed),
            "baselined": len(findings) - len(new),
            "exit": 1 if (problems or stale) else 0,
        }, indent=1, sort_keys=True))
    else:
        for f in new:
            print(f.render())
        for f in lint:
            print(f.render())
        for fp in stale:
            print(f"stale baseline entry (finding fixed — delete it "
                  f"or shrink its count): {fp}")
        print(f"contract analyzer: {report.files_scanned} files, "
              f"{len(new)} new finding(s), "
              f"{len(findings) - len(new)} baselined, "
              f"{len(report.suppressed)} suppressed, "
              f"{len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'}")
    return 1 if (problems or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
