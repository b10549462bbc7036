"""The benchmark's modules and the checkout on the import path."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for path in (HERE, BENCH, os.path.dirname(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)
