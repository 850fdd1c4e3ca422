#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's result as one JSON line, last on standard output, and the
numbers its correctness was judged by, last on standard error.  Needs the
CUDA devices the cell asks for; exits with a code other than 0 without them.
See ``perfbench/harness.py`` for what a run does.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(ROOT, ".perfbench_cache", _sub)
os.environ.setdefault("OMP_NUM_THREADS", "4")

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from perfbench import harness

    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
