"""The benchmark's own tests: ``python -m pytest octbench/tests`` from the
checkout's root (``tests/`` is the port's suite and does not collect
these).  Tests marked ``cuda`` run the harness on the card and skip
without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
