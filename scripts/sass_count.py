#!/usr/bin/env python3
"""SASS instructions of each kernel in the port's built libraries.

    python3 scripts/sass_count.py [build dir, default codlad_tpu_torch/_build]
                                  [--lib message_chain] [--ops FFMA,FMUL,FADD]

Runs on the machine with the CUDA toolkit (`cuobjdump` under
/usr/local/cuda/bin or on PATH) after the kernels are built
(`codlad_tpu_torch.kernels.build.timed_build()`); prints one line a kernel
of the libraries whose name holds `--lib` (default: the message chains):
library, instruction count, the count of each opcode named in `--ops`
(e.g. FFMA,FMUL,FADD: whether a product was contracted into a sum), mangled
name. A kernel's loop body larger than the SM's instruction cache streams
its instructions from L2 on every pass.
"""

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", nargs="?", default="codlad_tpu_torch/_build")
    ap.add_argument("--lib", default="message_chain")
    ap.add_argument("--ops", default="")
    args = ap.parse_args(argv)
    ops = [o for o in args.ops.split(",") if o]
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for lib in sorted(Path(args.root).glob(f"*{args.lib}*.so")):
        out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                             check=True).stdout
        name, n, seen = None, 0, dict.fromkeys(ops, 0)
        for line in out.splitlines() + ["Function : <end>"]:
            m = re.search(r"Function : (\S+)", line)
            if m:
                if name:
                    counts = "".join(f" {k}={v}" for k, v in seen.items())
                    print(f"{lib.name} {n}{counts} {name}")
                name, n, seen = m.group(1), 0, dict.fromkeys(ops, 0)
            elif re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
                n += 1
                op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
                if op and op.group(1) in seen:
                    seen[op.group(1)] += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
