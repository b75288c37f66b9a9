"""Build the CUDA kernels of `openstereo_tpu_torch/csrc/` with nvcc and load them.

Each `.cu` source becomes its own shared library with a plain C interface
(`extern "C"` launchers that return `cudaError_t`), loaded with ctypes. The
library's name carries a hash of its source and flags, so an edited source
is rebuilt and an unchanged one is reused. Libraries go to `build/kernels/`
at the repository root (listed in .gitignore).

Nothing is compiled at import time: `load(name)` builds on first use, and
`build_all()` starts one nvcc per source at once and waits for them all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("corr_volume", "fused_mbconv", "rel_attention", "gwc_volume")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source on the machine with the card")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _nvcc_cmd(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names=SOURCES) -> Dict[str, Path]:
    """Compile every missing library, one nvcc process per source, in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(_nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, building it if needed."""
    with _lock:
        if name not in _libs:
            path = build_all((name,))[name]
            _libs[name] = _declare(name, ctypes.CDLL(str(path)))
        return _libs[name]


def _declare(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "corr_volume":
        # left, right, out, B, C, H, W, D, dtype, stream
        lib.corr_volume_launch.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.corr_volume_launch.restype = i
    elif name == "fused_mbconv":
        # x, w1, b1, dw, b2, w2, b3, out, B, Cin, Ch, Cout, H, W, residual, dtype, stream
        lib.fused_mbconv_launch.argtypes = [p, p, p, p, p, p, p, p,
                                            i, i, i, i, i, i, i, i, p]
        lib.fused_mbconv_launch.restype = i
    elif name == "rel_attention":
        # q, k, v, ke, qe, out, raw (or None), B, W, E, nheads, masked, dtype, stream
        lib.rel_attention_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.rel_attention_launch.restype = i
    elif name == "gwc_volume":
        # left, right, out, B, C, H, W, D, G, dtype, stream
        lib.gwc_volume_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        lib.gwc_volume_launch.restype = i
    return lib
