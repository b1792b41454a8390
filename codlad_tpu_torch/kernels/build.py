"""Build the CUDA sources under `csrc/` with plain `nvcc` and load them.

Each source becomes a shared library with a plain C interface, compiled
for Hopper (`sm_90a`) on first use and cached under `_build/` (git-ignored)
by a hash of the source and the flags. Sources build in parallel: one
`nvcc` per source, all started together. Nothing here includes PyTorch's
headers, so a build takes seconds, not minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("message_chain", "message_chain_bwd", "edge_ops", "fused_tp", "fused_tp_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    """Cached library path, keyed by the source, the shared headers of
    `csrc/` and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every stale source, all at once; return each source's
    compiler log (`-Xptxas -v`: registers, shared memory, spills). Raises
    if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{logs[name]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The compiled library for `csrc/<name>.cu`, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def timed_build(names=SOURCES) -> tuple[float, dict[str, str]]:
    """Build (or find cached) and load every source; (seconds, logs)."""
    t0 = time.perf_counter()
    logs = build(names)
    for name in names:
        load(name)
    return time.perf_counter() - t0, logs
