"""The benchmark's own tests: they import the harness as benchmark/run.py
does (benchmark/ and the checkout's root on sys.path)."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)
