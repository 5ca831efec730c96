"""The benchmark's tests import ``port_bench`` and the program from the
checkout's root, and the tiny cell's helper from this folder."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for path in (HERE, os.path.dirname(os.path.dirname(HERE))):
    if path not in sys.path:
        sys.path.insert(0, path)
