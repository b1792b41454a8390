#!/usr/bin/env python3
"""SASS instructions of each kernel in the port's built message-chain libraries.

    python3 scripts/sass_count.py [build dir, default codlad_tpu_torch/_build]

Runs on the machine with the CUDA toolkit (`cuobjdump` under
/usr/local/cuda/bin or on PATH) after the kernels are built
(`codlad_tpu_torch.kernels.build.timed_build()`); prints one line a kernel:
library, instruction count, mangled name. A kernel's loop body larger than
the SM's instruction cache streams its instructions from L2 on every pass.
"""

import re
import shutil
import subprocess
import sys
from pathlib import Path


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    root = Path(argv[0] if argv else "codlad_tpu_torch/_build")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for lib in sorted(root.glob("*message_chain*.so")):
        out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                             check=True).stdout
        name, n = None, 0
        for line in out.splitlines() + ["Function : <end>"]:
            m = re.search(r"Function : (\S+)", line)
            if m:
                if name:
                    print(lib.name, n, name)
                name, n = m.group(1), 0
            elif re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
                n += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
