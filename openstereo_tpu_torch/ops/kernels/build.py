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
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# each source and the launchers (`<entry>_launch`) it exports, one per wrapper
ENTRIES = {"cost_volume": ("corr_volume", "gwc_volume"), "fused_mbconv": ("fused_mbconv",),
           "rel_attention": ("rel_attention",)}
SOURCES = tuple(ENTRIES)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

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
    """The library's path, keyed by its source, the shared headers and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
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
        lib.with_suffix(".log").write_text(log)  # ptxas's registers, spills, shared memory
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: library_path(name) for name in names}


def ptxas_info(name: str) -> List[Dict[str, object]]:
    """Per kernel entry of library `name`, from the build's `-Xptxas=-v` log:
    registers, spill stores and loads (bytes), static shared memory (bytes)."""
    log = library_path(name).with_suffix(".log")
    entries: List[Dict[str, object]] = []
    for line in log.read_text().splitlines() if log.exists() else []:
        if "Compiling entry function" in line:
            entries.append({"entry": line.split("'")[1], "registers": None, "spill_stores": None,
                            "spill_loads": None, "smem": 0})
        elif entries and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill (stores|loads)", line)
            for n, kind in nums:
                entries[-1][f"spill_{kind}"] = int(n)
        elif entries and "Used" in line and "registers" in line:
            entries[-1]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            entries[-1]["smem"] = int(smem.group(1)) if smem else 0
    return entries


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, building it if needed."""
    with _lock:
        if name not in _libs:
            path = build_all((name,))[name]
            _libs[name] = _declare(name, ctypes.CDLL(str(path)))
        return _libs[name]


def _declare(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "cost_volume":
        # left, right, out, B, C, H, W, D, dtype, stream
        lib.corr_volume_launch.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.corr_volume_launch.restype = i
        # left, right, out, B, C, H, W, D, G, divisor, dtype, stream
        lib.gwc_volume_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
        lib.gwc_volume_launch.restype = i
    elif name == "fused_mbconv":
        # x, w1, b1, dw, b2, w2, b3, out, workspace (or None), B, Cin, Ch, Cout, H, W,
        # residual, splits, dtype, stream
        lib.fused_mbconv_launch.argtypes = [p, p, p, p, p, p, p, p, p,
                                            i, i, i, i, i, i, i, i, i, p]
        lib.fused_mbconv_launch.restype = i
        # B, H, W, Ch, dtype → the launcher's split count (0: no SM count)
        lib.fused_mbconv_splits.argtypes = [i, i, i, i, i]
        lib.fused_mbconv_splits.restype = i
    elif name == "rel_attention":
        # q, k, v, ke, qe, out, raw (or None), B, W, E, nheads, masked, dtype, stream
        lib.rel_attention_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.rel_attention_launch.restype = i
    return lib
