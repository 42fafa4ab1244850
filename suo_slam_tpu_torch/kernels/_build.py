"""Build and load the hand-written Hopper kernels (`csrc/*.cu`).

Route: `nvcc` by hand into one shared library per source, each with a plain C
interface, loaded with `ctypes`. Sources are compiled in parallel — one
`nvcc` process per file, all started together — into `build/suo_kernels/`
at the repository root (listed in `.gitignore`), once, at first use. A
library newer than its source and than every shared header (`csrc/*.cuh`:
`ba_common.cuh`, which `ba_edges.cu`, `ba_schur.cu`, `ba_lm.cu` and
`pnp_ransac.cu` include, `pnp_common.cuh`, which `pnp_hypotheses.cu` and
`pnp_ransac.cu` include, and `channel_vec.cuh`, which `bn_train.cu` and
`group_norm.cu` include) is reused.

Flags: `-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC --fmad=false`. `--fmad=false` keeps `a*b+c` as two rounded
operations, as PyTorch's separate elementwise kernels compute it in the plain
versions, so a kernel and its plain version agree to the last bits where
they run the same arithmetic in the same order.

Building, loading and typing an entry point happen under one re-entrant lock
(`_lock`): the pipelined evaluation's worker threads can reach a first launch
together in a fresh process, and must not run two sets of `nvcc` into one
`build/suo_kernels/` or type one entry point twice. The per-call path
(`entry` on a typed entry point) takes no lock. `stream()` is PyTorch's
current stream of the calling thread; a thread that set none (every worker
thread) gets the device's default stream, the one PyTorch's own operations
in that thread run on, so a launch stays ordered after the tensors it reads.

Libraries load as `ctypes.PyDLL`: an entry point only enqueues work, so the
call keeps the GIL rather than releasing and retaking it. Every C entry
point returns `cudaGetLastError()` after its launch; `check`
raises on a non-zero code. Pointers and the stream cross as plain ints
(`ptr`, `stream`) through `ctypes.c_void_p` argtypes, which every entry point
declares (`entry`): ctypes passes them as full 64-bit pointers.
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

_lock = threading.RLock()  # build_all, and entry's first lookup around it
_libs: dict[str, ctypes.PyDLL] = {}
_entries: dict[tuple, object] = {}
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


def stale(src: Path, out: Path) -> bool:
    """Whether `out`, the library of `src`, needs a build: it is missing, or
    older than `src` or than any header (`*.cuh`) beside it."""
    if not out.exists():
        return True
    built = out.stat().st_mtime
    return any(p.stat().st_mtime > built for p in (src, *src.parent.glob("*.cuh")))


def build_all() -> float:
    """Compile every stale `csrc/*.cu` in parallel and load all libraries.
    Returns the seconds spent. Raises with nvcc's output if one fails."""
    with _lock:
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for src in _sources():
            out = BUILD_DIR / f"lib{src.stem}.so"
            if not stale(src, out):
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
                # PyDLL: the call keeps the GIL (an entry point only enqueues a
                # launch), which saves its release and reacquisition per call
                _libs[src.stem] = ctypes.PyDLL(str(BUILD_DIR / f"lib{src.stem}.so"))
        return time.perf_counter() - t0


def entry(stem: str, argtypes: list, symbol: str | None = None):
    """The C entry point `symbol` (default `suo_<stem>`) of `csrc/<stem>.cu`
    (building every kernel on first use), typed once with `argtypes` and an
    int (cudaError_t) return."""
    fn = _entries.get((stem, symbol))  # the per-call path: one dict lookup
    if fn is None:
        with _lock:
            fn = _entries.get((stem, symbol))
            if fn is None:
                if stem not in _libs:
                    build_all()
                fn = getattr(_libs[stem], symbol or f"suo_{stem}")
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
                _entries[(stem, symbol)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry point's `cudaGetLastError()` was not cudaSuccess."""
    if err != 0:
        import torch

        name = torch.cuda.get_device_name() if torch.cuda.is_available() else "?"
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} on {name}")


def ptr(t) -> int:
    """A tensor's device address as a plain int, for a `ctypes.c_void_p`
    argtype: ctypes converts it to a full 64-bit pointer (an entry point
    without argtypes would raise on it rather than cut it)."""
    return t.data_ptr()


def stream(device: int | None = None) -> int:
    """PyTorch's current CUDA stream on `device` (an index; default the
    current device), as a plain int for a `ctypes.c_void_p` argtype: the raw
    stream query, no Stream object per call."""
    import torch

    if device is None:
        device = torch._C._cuda_getDevice()
    return torch._C._cuda_getCurrentRawStream(device)
