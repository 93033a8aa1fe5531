"""Shared example setup: make the package importable without an install."""

import pathlib
import sys

# `python examples/foo.py` puts examples/ (not the repo root) on sys.path.
_ROOT = str(pathlib.Path(__file__).resolve().parent.parent)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)
