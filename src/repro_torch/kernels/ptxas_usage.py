"""Print ptxas's resource report (registers, barriers, spills) for the
hand-written CUDA kernels of ``kernels/csrc``.

Run from the repository root on a machine with the CUDA toolkit:

    PYTHONPATH=src python3 -m repro_torch.kernels.ptxas_usage [name ...]

``name`` is a source of ``kernels/csrc`` without ``.cu`` (default: every
source).  Each source is compiled with :mod:`.build`'s flags plus
``-Xptxas -v`` into a temporary directory (the ``build/`` libraries are
not touched); the script prints ptxas's lines and exits non-zero if a
compile fails.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

from . import build


def main(names: list[str]) -> int:
    names = names or sorted(build.FLAGS)
    failed = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            cmd = build._command(name, Path(tmp) / f"lib{name}.so")
            t0 = time.perf_counter()
            run = subprocess.run(cmd[:1] + ["-Xptxas", "-v"] + cmd[1:],
                                 capture_output=True, text=True)
            print(f"== {name}.cu: nvcc exit {run.returncode} in "
                  f"{time.perf_counter() - t0:.1f} s")
            for line in (run.stdout + run.stderr).splitlines():
                if run.returncode or "ptxas" in line or "spill" in line:
                    print(line)
            failed += run.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
