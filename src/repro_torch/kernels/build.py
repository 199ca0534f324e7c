"""Build and load the hand-written CUDA kernels of ``kernels/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with :mod:`ctypes` (no PyTorch
headers, so a build takes seconds).  Libraries go to ``build/`` at the repo
root, keyed by a hash of the source, the shared headers (``csrc/*.cuh``)
and the flags, and are built at first use — never at import.
:func:`build_all` starts one ``nvcc`` per source at once and waits for all
of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMMON = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
# per-source extra flags; the event step and the fused update must not
# contract mul-adds, so their arithmetic is bitwise their plain PyTorch
# versions; flash and decode attention keep nvcc's precise expf and
# division (no --use_fast_math)
FLAGS = {"buzen": [], "events": ["-fmad=false"],
         "fused_update": ["-fmad=false"], "flash_attention": [],
         "decode_attention": [], "threefry": []}

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def _command(name: str, out: Path) -> list[str]:
    return ([_nvcc()] + _ARCH + _COMMON + FLAGS[name]
            + ["-o", str(out), str(CSRC / f"{name}.cu")])


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu``'s library goes: the name carries a hash of
    the source, of every header of ``csrc`` (a source may include any of
    them, so a changed header never loads a stale library) and of the
    flags."""
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(
        src + " ".join(_ARCH + _COMMON + FLAGS[name]).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library exists; returns
    ``(process, tmp, final)`` or ``None``."""
    final = library_path(name)
    if final.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(_command(name, Path(tmp)),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, Path(tmp), final


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, final = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{out.decode()}")
    os.replace(tmp, final)  # atomic: a reader never sees a partial library


def build_all(names=tuple(FLAGS)) -> None:
    """Compile every missing library, all ``nvcc`` processes at once."""
    started = {name: _start(name) for name in names}
    errors = []
    for name, s in started.items():
        try:
            _finish(name, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
