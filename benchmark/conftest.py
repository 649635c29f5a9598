"""The benchmark's CPU tests: its own directory and the checkout's root on
the import path, as benchmark/run.py puts them."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)
