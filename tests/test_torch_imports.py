"""Each kernel module, and each module of the session and read path,
of the port imports first in a fresh interpreter.

``repro_torch.core.pipeline`` imports the kernel modules, and a kernel
module imports ``repro_torch.core``, so the pipeline must take modules,
not their functions: a function asked for while its module is half
initialised raises ``ImportError``.  ``serving.dedup_service`` imports
``core.session``, which imports ``core.pipeline``: a second chain.  One
subprocess a module; none may pull in ``jax`` or ``repro``.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("module", ["minhash", "ngram", "fused_ingest",
                                    "byte_shingle"])
def test_kernel_module_imports_first_in_a_fresh_interpreter(module):
    proc = subprocess.run(
        [sys.executable, "-c", f"import repro_torch.kernels.{module}"],
        env={**os.environ, "PYTHONPATH": str(SRC)},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", ["core.session", "core.query",
                                    "core.sanitize", "core.retention",
                                    "core.bandstore", "core.streaming",
                                    "serving.dedup_service", "launch.dedup"])
def test_session_module_imports_first_without_jax(module):
    code = (f"import sys, repro_torch.{module}; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'repro')); "
            "assert not bad, bad")
    proc = subprocess.run(
        [sys.executable, "-c", code],
        env={**os.environ, "PYTHONPATH": str(SRC)},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
