"""Build and load the port's CUDA kernels.

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process,
all started together, for ``sm_90a`` (Hopper), and the objects are linked
into one shared library with a plain C interface that is loaded with
``ctypes``. No PyTorch header is compiled: a source that includes them takes
minutes to build where these take seconds. The library lands in
``kernels/_build/`` (listed in ``.gitignore``) under a name derived from the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. A failed build raises; nothing falls back.

Each C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing and returns ``cudaGetLastError()``;
:func:`check` turns a non-zero return into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

__all__ = ["build_info", "check", "kernel_fn", "library", "CSRC", "BUILD_DIR"]

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v prints each kernel's registers, shared memory and spills into
# the build log, which chip_smoke.py shows
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_fns: Dict[str, Any] = {}
_info: Dict[str, Any] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin): "
        "the CUDA kernels of paddle_tpu_torch are built from source at first use"
    )


def _sources() -> Sequence[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _build() -> Path:
    digest = _digest()
    lib_path = BUILD_DIR / f"libpaddle_tpu_torch_kernels-{digest}.so"
    log_path = BUILD_DIR / f"build-{digest}.log"
    if lib_path.exists():
        _info.update(path=str(lib_path), seconds=0.0, cached=True,
                     log=log_path.read_text() if log_path.exists() else "")
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(_sources(), objs)
        ]
        logs, failed = [], []
        for src, proc in zip(_sources(), procs):
            out, _ = proc.communicate()
            # the seconds since the build began by which this source was done (waited on in turn)
            logs.append(f"== nvcc {src.name} (rc {proc.returncode}, done by {time.perf_counter() - t0:.1f} s)\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / "lib.so"
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        logs.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("linking the kernel library failed:\n" + "\n".join(logs))
        log = "\n".join(logs)
        log_path.write_text(log)
        # atomic: another process building the same digest never sees half a file
        os.replace(tmp_lib, lib_path)
    _info.update(path=str(lib_path), seconds=time.perf_counter() - t0, cached=False, log=log)
    return lib_path


def library() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.ptt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.ptt_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def build_info() -> Dict[str, Any]:
    """Path, build seconds, whether it was cached, and the nvcc log."""
    library()
    return dict(_info)


def kernel_fn(name: str, argtypes: Sequence[Any]) -> Any:
    """The C entry point ``name`` with its ``argtypes`` set (pointers and the
    stream as ``c_void_p``, so ctypes never cuts a 64-bit value to 32)."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = library().ptt_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
