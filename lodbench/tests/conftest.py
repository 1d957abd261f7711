"""Tests of the benchmark's harness (lodbench/), run from the repository's
root: python -m pytest lodbench/tests -q. Tests that need a CUDA card
carry the `cuda` marker and skip inside the test without one."""
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
torch.set_num_threads(2)
