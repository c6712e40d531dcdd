"""Run one cell of the port's benchmark once, on the card.

    python3 mgbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the compared numbers beside their
limits as its last lines on standard error, and one JSON object as the
last line of standard output.  Exits non-zero, with no result, where torch
sees no card (or fewer than the cell needs), where the port is missing,
or where JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the folder is a package of the checkout (`mgbench.trace`), not a root of
# its own, where `trace` would shadow the standard library's
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, ROOT)
# any kernel cache at a fixed path inside the checkout (the port builds its
# own kernels into its package's `_build/`)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".mgbench_cache",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".mgbench_cache",
                                              "triton")

from mgbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_process=T_PROCESS))
