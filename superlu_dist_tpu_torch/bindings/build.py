"""Build libslu_tpu_torch.so (the C/Fortran binding shim, see slu_tpu.h)
and the C client ``test_capi`` against it, with ``gcc``, into
``build/torch_capi/<hash of the sources and flags>/`` at the root of the
checkout (never beside the sources).  The build holds a file lock, so
concurrent first uses build once.  Nothing falls back: a failed build
raises ``RuntimeError`` with the compiler's output.

    python -m superlu_dist_tpu_torch.bindings.build    # prints both paths

A C program links with ``link_flags(lib)``: the library, the embedded
interpreter's (``python3-config --embed --ldflags``) and the rpaths of
both.  The embedded interpreter imports ``superlu_dist_tpu_torch``, so
the program runs with the checkout's root on ``PYTHONPATH``.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import sys
import sysconfig
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_ROOT = HERE.parents[1] / "build" / "torch_capi"
CC = "gcc"
LIB_NAME = "libslu_tpu_torch.so"


def _embed_libs() -> list:
    """The embedded interpreter's link flags (``python3-config --embed
    --ldflags`` of this interpreter) and its library's rpath."""
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION") or \
        f"{sys.version_info.major}.{sys.version_info.minor}"
    return [f"-L{libdir}", f"-lpython{ver}", "-ldl", "-lm",
            f"-Wl,-rpath,{libdir}"]


def link_flags(lib) -> list:
    """What a C or Fortran program adds to link against ``lib``."""
    return [str(lib), *_embed_libs(), f"-Wl,-rpath,{Path(lib).parent}"]


def _out_dir() -> Path:
    digest = hashlib.sha256(repr((CC, _embed_libs(),
                                  sysconfig.get_path("include"))).encode())
    for name in ("slu_tpu.h", "slu_tpu_capi.c", "test_capi.c"):
        digest.update((HERE / name).read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


def _run(cmd, what):
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"cannot build {what}: {' '.join(cmd)}: {e}") \
            from e
    if proc.returncode != 0:
        raise RuntimeError(f"building {what} failed ({' '.join(cmd)}, exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")


def build() -> tuple:
    """(library, client): ``libslu_tpu_torch.so`` and the ``test_capi``
    executable linked against it, built unless they exist for these
    sources and flags."""
    out_dir = _out_dir()
    lib, exe = out_dir / LIB_NAME, out_dir / "test_capi"
    if lib.exists() and exe.exists():
        return lib, exe
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (lib.exists() and exe.exists()):
            tag = os.getpid()
            tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
            _run([CC, "-O2", "-shared", "-fPIC",
                  f"-I{sysconfig.get_path('include')}", f"-I{HERE}", "-o",
                  str(tmp), str(HERE / "slu_tpu_capi.c"), *_embed_libs()],
                 LIB_NAME)
            os.replace(tmp, lib)
            tmp = out_dir / f"test_capi.{tag}.tmp"
            _run([CC, "-O2", str(HERE / "test_capi.c"), f"-I{HERE}", "-o",
                  str(tmp), *link_flags(lib)], "test_capi")
            os.replace(tmp, exe)
    return lib, exe


if __name__ == "__main__":
    print(*build(), sep="\n")
