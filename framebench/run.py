"""The benchmark of drts_tpu_torch: one cell of BENCHMARK.json per run.

    python3 framebench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. Prints one JSON line last on standard
output (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and ``checks`` last) and each compared
number beside its limit as the last lines of standard error. Every cache a
run builds stays inside the checkout at a fixed path: the port's kernel
library under ``drts_tpu_torch/build/`` and Triton's and PyTorch's
extension caches under ``framebench/.cache/`` (see ``CACHE_DIRS``).
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
CACHE_DIRS = {"TRITON_CACHE_DIR": os.path.join(HERE, ".cache", "triton"),
              "TORCH_EXTENSIONS_DIR": os.path.join(HERE, ".cache",
                                                   "torch_extensions")}


def main() -> int:
    for key, path in CACHE_DIRS.items():
        os.environ[key] = path
    # The checkout's root, not this folder, heads the import path: the
    # harness's packages are imported as framebench.*.
    sys.path[:] = [CHECKOUT] + [p for p in sys.path
                                if os.path.abspath(p or ".") != HERE]
    from framebench.harness import main as harness_main
    return harness_main.main(sys.argv[1:], T_START)


if __name__ == "__main__":
    sys.exit(main())
