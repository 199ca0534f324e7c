"""Repo-hygiene check: fail when generated files are tracked by git (port
of ``repro.analysis.hygiene``).

``.gitignore`` keeps *new* generated files out, but only a check that
runs in tier-1 keeps already-tracked ones from coming back.  Besides the
JAX package's bytecode and tool caches, the port produces the kernels'
build directory (``build/``, :mod:`repro_torch.kernels.build`), the
output directories of runs on the card (``chiprun_out/``,
``chip_scratch/``) and, through its
property tests, the ``hypothesis`` example database
(``.hypothesis/examples/``, ``.hypothesis/patches/``).  The database's
``constants/`` entry predates the port and is not forbidden.

Without git (an exported tree, as ``git archive`` makes for the card's
machine) there is nothing tracked, and the check passes with zero files.
"""
from __future__ import annotations

import os
import subprocess
import sys

# src/repro_torch/analysis/hygiene.py -> repo root is four levels up
REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))

# path fragments that must never be tracked; the port's own come last
FORBIDDEN = ("__pycache__/", ".pytest_cache/",
             ".hypothesis/examples/", ".hypothesis/patches/")
# top-level directories of generated output
FORBIDDEN_ROOTS = ("build/", "chiprun_out/", "chip_scratch/")
FORBIDDEN_SUFFIXES = (".pyc", ".pyo")


def tracked_files(repo_root: str = REPO_ROOT) -> list[str]:
    """``git ls-files`` of the repo (empty if git or the repository is
    unavailable)."""
    try:
        out = subprocess.run(
            ["git", "ls-files"], cwd=repo_root, check=True,
            capture_output=True, text=True)
    except (OSError, subprocess.CalledProcessError):
        return []
    return [line for line in out.stdout.splitlines() if line]


def is_junk(path: str) -> bool:
    """Whether a repo-relative path is generated output."""
    return (path.endswith(FORBIDDEN_SUFFIXES)
            or any(frag in path for frag in FORBIDDEN)
            or path.startswith(FORBIDDEN_ROOTS))


def tracked_junk(repo_root: str = REPO_ROOT) -> list[str]:
    """Tracked paths violating repo hygiene."""
    return [path for path in tracked_files(repo_root) if is_junk(path)]


def main() -> int:
    bad = tracked_junk()
    if bad:
        print("tracked files violating repo hygiene:", file=sys.stderr)
        for path in bad:
            print(f"  {path}", file=sys.stderr)
        print(f"fix with: git rm --cached {' '.join(bad[:5])} ...",
              file=sys.stderr)
        return 1
    print(f"hygiene OK ({len(tracked_files())} tracked files clean)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
