"""Build and load the hand-written Hopper kernels (`csrc/*.cu`).

Route: `nvcc` by hand into one shared library per source, each with a plain C
interface, loaded with `ctypes`. Sources are compiled in parallel — one
`nvcc` process per file, all started together — into `build/suo_kernels/`
at the repository root (listed in `.gitignore`), once, at first use. A
library newer than its source is reused.

Flags: `-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC --fmad=false`. `--fmad=false` keeps `a*b+c` as two rounded
operations, as PyTorch's separate elementwise kernels compute it in the plain
versions, so a kernel and its plain version agree to the last bits where
they run the same arithmetic in the same order.

Every C entry point returns `cudaGetLastError()` after its launch; `check`
raises on a non-zero code. Pointers cross as `ctypes.c_void_p` and the
stream as `torch.cuda.current_stream().cuda_stream`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "suo_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[str, object] = {}
build_log: dict[str, str] = {}  # source stem -> nvcc's output (ptxas -v)


def nvcc_path() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built on the machine with the card")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_all() -> float:
    """Compile every stale `csrc/*.cu` in parallel and load all libraries.
    Returns the seconds spent. Raises with nvcc's output if one fails."""
    with _lock:
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for src in _sources():
            out = BUILD_DIR / f"lib{src.stem}.so"
            if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[src.stem] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True),
                tmp, out,
            )
        failed = []
        for stem, (p, tmp, out) in procs.items():
            log, _ = p.communicate()
            build_log[stem] = log
            if p.returncode != 0:
                failed.append(f"--- {stem}.cu (exit {p.returncode}) ---\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for src in _sources():
            if src.stem not in _libs:
                _libs[src.stem] = ctypes.CDLL(str(BUILD_DIR / f"lib{src.stem}.so"))
        return time.perf_counter() - t0


def entry(stem: str, argtypes: list, symbol: str | None = None):
    """The C entry point `symbol` (default `suo_<stem>`) of `csrc/<stem>.cu`
    (building every kernel on first use), typed once with `argtypes` and an
    int (cudaError_t) return."""
    symbol = symbol or f"suo_{stem}"
    fn = _entries.get(symbol)
    if fn is None:
        if stem not in _libs:
            build_all()
        fn = getattr(_libs[stem], symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _entries[symbol] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry point's `cudaGetLastError()` was not cudaSuccess."""
    if err != 0:
        import torch

        name = torch.cuda.get_device_name() if torch.cuda.is_available() else "?"
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} on {name}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
