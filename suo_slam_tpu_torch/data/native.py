"""g++ builds of the port's host libraries (`native/<name>.cpp`).

`build_library(source)` compiles `native/<name>.cpp` into
`build/suo_native/lib<name>.so` at first use, and again when the source is
newer than the library: g++ -O3 (no -ffast-math), C++17. The library is
written under a temporary name and moved into place atomically, so a
concurrent build or load sees one whole library. A failed build raises
RuntimeError with the compiler's output; nothing falls back.

No torch here: the process loader's workers load these libraries.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "suo_native"


def build_library(source: Path, build_dir: Path = BUILD_DIR) -> Path:
    """The path of `build_dir/lib<name>.so` for `source` = `<name>.cpp`,
    built if it is missing or older than its source."""
    name = Path(source).stem
    so = Path(build_dir) / f"lib{name}.so"
    if not so.exists() or so.stat().st_mtime < Path(source).stat().st_mtime:
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.parent / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", str(source),
               "-o", str(tmp)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"{name} build failed ({' '.join(cmd)}):\n{r.stderr}")
        os.replace(tmp, so)
    return so
