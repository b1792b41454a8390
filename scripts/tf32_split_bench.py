#!/usr/bin/env python3
"""Time the 3xTF32 split variants of the f32 message chains on one GPU.

    python3 scripts/tf32_split_bench.py

Builds scripts/tf32_split_bench.cu with nvcc (sm_90a) into a temporary
directory, runs it, and prints its lines (each variant's TF32 rate and share
of the H100's 495 TFLOP/s) and the card's name and power limit. The
kernels' split (csrc/chain_tf32.cuh) is variant 5.
"""

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main():
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    with tempfile.TemporaryDirectory() as tmp:
        exe = Path(tmp) / "tf32_split_bench"
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
                        "-o", str(exe), str(HERE / "tf32_split_bench.cu")], check=True)
        print(subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout,
              end="")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
