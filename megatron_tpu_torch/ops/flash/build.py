"""Build the CUDA kernels at first use and load them with ctypes.

Each kernel source in megatron_tpu_torch/csrc/ compiles with nvcc into
its own shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so <name>.cu

into megatron_tpu_torch/build/ (listed in .gitignore). The file name
carries a hash of the sources and flags, so an edited source never loads
a stale library. build() starts one nvcc per missing library, all at
once, and returns each build's seconds and the -Xptxas -v lines
(registers, shared memory, spills). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

#: library name -> source file in csrc/ (flash_bwd holds two kernels)
KERNELS = {"flash_fwd": "flash_fwd.cu", "flash_decode": "flash_decode.cu",
           "flash_bwd": "flash_bwd.cu"}
_HEADERS = ("masks.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the flash kernels are built "
            "from megatron_tpu_torch/csrc at first use on a CUDA host")
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (KERNELS[name],) + _HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet,
    one nvcc process each, all started together. Returns
    {name: {"path", "seconds", "ptxas", "cached"}}; raises RuntimeError
    with the compiler's output if any build fails."""
    names = list(names or KERNELS)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, dict] = {}
    procs = {}
    for name in names:
        path = lib_path(name)
        if path.exists():
            out[name] = {"path": str(path), "seconds": 0.0, "ptxas": [],
                         "cached": True}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / KERNELS[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.monotonic(), tmp, path)
    failed = []
    for name, (proc, t0, tmp, path) in procs.items():
        log, _ = proc.communicate()
        seconds = time.monotonic() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half
        out[name] = {"path": str(path), "seconds": seconds,
                     "ptxas": [ln.strip() for ln in log.splitlines()
                               if "ptxas" in ln or "spill" in ln],
                     "cached": False}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed (once per
    process; thread-safe)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _loaded[name] = lib
        return lib
