"""Build the port's CUDA kernels on first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C entry point and compiles on its own:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/mpit_tpu_torch/<name>-<hash>.so csrc/<name>.cu

into ``build/mpit_tpu_torch/`` at the root of the checkout. The library's
name carries a hash of the source and the flags, so an edited source is
rebuilt and never confused with an old build. :func:`build_all` starts one
``nvcc`` for every source at once, so the build takes as long as the
slowest file. Nothing here runs at import: the CPU tests import every
module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mpit_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, per kernel
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are compiled on the machine with the card"
    )


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{tag}.so"


def _start(name: str):
    """Start compiling ``name`` unless its library is already built;
    returns ``(target, tmp, process)`` or None."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return target, tmp, proc


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Compile every named source (default: all of ``csrc/``) in parallel.
    Returns the compiler's output by name for the sources it compiled
    (``-Xptxas -v`` puts each kernel's resource use there); raises with
    that output if any build fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        jobs = [j for j in map(_start, names) if j is not None]
        outputs, errors = {}, []
        for target, tmp, proc in jobs:
            out, _ = proc.communicate()
            outputs[target.name] = out
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                errors.append(f"nvcc failed for {target.name}:\n{out}")
                continue
            os.replace(tmp, target)
        if errors:
            raise RuntimeError("\n".join(errors))
        return outputs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _loaded.setdefault(name, ctypes.CDLL(str(_target(name))))
    return lib
