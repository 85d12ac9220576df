"""The harness's own tests, on the CPU at tiny sizes (``bench/tests/tiny.py``):
``python -m pytest bench/tests`` from the root of the checkout."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
