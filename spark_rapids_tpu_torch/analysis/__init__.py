"""The engine contract analyzer, pointed at the port — the counterpart of
spark_rapids_tpu/analysis/.

An AST-based static-analysis pass over spark_rapids_tpu_torch/ and
chip_smoke.py: the bug classes the JAX package's reviews fixed by hand
(missed thread-local adoption at producer-thread spawns, conf reads from
the calling thread instead of the admitting ticket, event emission and
blocking calls while holding engine locks, budget counters left
asymmetric on failure branches), and three retargeted at the port's
idiom: a module-level tensor (`trace-module-tensor`), a host read inside
a body captured into a CUDA graph (`trace-host-sync`) and a kernel
launch or graph outside the dispatch ledger (`dispatch-ledger`). It runs
in tier-1 (tests/test_torch_contract_check.py) and as a CLI:

    python -m spark_rapids_tpu_torch.analysis [paths] [--format json]
        [--rules id,...] [--baseline PATH | --baseline write]

Structure:

* ``core``        — findings, suppressions, baseline, running the rules
* ``registry``    — THE rule registry: rule metadata plus the engine
                    contract data (named locks + partial order, adopt
                    helpers, cross-query conf entries, accounting pairs,
                    blocking and host-read calls)
* ``callgraph``   — per-module call-graph resolution shared by rules
* ``scan``        — source-file discovery + conf-key literal scanning
* ``rules_*``     — one module per rule family
* ``__main__``    — the CLI

Findings support ``# contract: ok <rule> — <why>`` suppressions
(justification required — an empty one is itself a finding) and a
checked-in baseline (analysis/baseline.json) whose every entry carries a
justification.
"""

from .core import (AnalysisReport, Finding, analyze_paths, apply_baseline,
                   load_baseline, write_baseline)
from .registry import DEFAULT_REGISTRY, RULES, ContractRegistry
from .scan import conf_key_literals, default_source_files

__all__ = [
    "AnalysisReport", "Finding", "analyze_paths", "apply_baseline",
    "load_baseline", "write_baseline", "DEFAULT_REGISTRY", "RULES",
    "ContractRegistry", "conf_key_literals", "default_source_files",
]
