"""Build the native broker with the host C++ compiler on first use.

One compiler call, as in ``mpit_tpu/native/build.py``:

    $CXX -O3 -std=c++17 -shared -fPIC -pthread \\
         -o build/mpit_tpu_torch/tagged_broker-<hash>.so src/tagged_broker.cpp

into ``build/mpit_tpu_torch/`` at the root of the checkout, beside the CUDA
builds of ``ops/_build.py``. The library's name carries a hash of the
source and the flags, so an edited source is rebuilt. ``$CXX`` names the
compiler, else ``g++`` or ``c++`` from ``PATH``. No compiler and no built
library raises :class:`NativeUnavailable`. Nothing runs at import.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

from mpit_tpu_torch.analysis.runtime import make_lock

SRC = Path(__file__).resolve().parent / "src" / "tagged_broker.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mpit_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_build_lock = make_lock("native.build._build_lock")


class NativeUnavailable(RuntimeError):
    """No built library and no way to build one."""


def compiler() -> Optional[str]:
    """The C++ compiler a build would run, or None."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is not None and shutil.which(cxx) is None:
        return None  # $CXX names nothing runnable
    return cxx


def lib_path() -> Path:
    """Where the library for this source and these flags is built."""
    tag = hashlib.sha256(
        SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"tagged_broker-{tag}.so"


def ensure_built(force: bool = False) -> str:
    """Return the path to the built library, building it if missing (or
    with ``force``). Raises :class:`NativeUnavailable` when it cannot."""
    with _build_lock:
        if not SRC.exists():
            raise NativeUnavailable(f"missing source {SRC}")
        target = lib_path()
        if target.exists() and not force:
            return str(target)
        cxx = compiler()
        if cxx is None:
            raise NativeUnavailable(
                "no C++ compiler found (set $CXX) and no built "
                f"{target.name}"
            )
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # per-process tmp: two processes may build at once (the lock is
        # per process); each promotes atomically, the last one wins whole
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(SRC)]
        try:
            subprocess.run(
                cmd, check=True, capture_output=True, text=True, timeout=120
            )
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
                OSError) as e:
            stderr = getattr(e, "stderr", "") or ""
            raise NativeUnavailable(
                f"native build failed: {' '.join(cmd)}\n{stderr}"
            ) from e
        os.replace(tmp, target)
        return str(target)
