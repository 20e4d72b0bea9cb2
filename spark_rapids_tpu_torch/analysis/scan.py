"""Source discovery and literal scanning — the counterpart of
spark_rapids_tpu/analysis/scan.py, pointed at the port: the default scan
set is the port's package and chip_smoke.py (tests and fixtures stay
out)."""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterator, List, Tuple, Union

_KEY_RE = re.compile(r"spark\.rapids\.[A-Za-z0-9_.]+$")

#: the port's package directory, relative to the repo root
PACKAGE = "spark_rapids_tpu_torch"


def repo_root(start: Path = None) -> Path:
    """The repo root: the directory holding spark_rapids_tpu_torch/."""
    here = Path(start) if start is not None else Path(__file__)
    return here.resolve().parents[2]


def default_source_files(root: Path = None) -> List[Path]:
    """The analyzer's default scan set: the port's package and
    chip_smoke.py, the port's run on the card."""
    root = Path(root) if root is not None else repo_root()
    files = sorted((root / PACKAGE).rglob("*.py"))
    smoke = root / "chip_smoke.py"
    if smoke.exists():
        files.append(smoke)
    return files


def conf_key_literals(source: Union[Path, ast.Module]
                      ) -> Iterator[Tuple[str, int]]:
    """String literals that ARE a conf key (the whole literal matches),
    with their line — f-strings/doc prose don't count."""
    tree = source if isinstance(source, ast.Module) \
        else ast.parse(Path(source).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and \
                isinstance(node.value, str) and \
                _KEY_RE.fullmatch(node.value.strip()):
            yield node.value.strip(), node.lineno
