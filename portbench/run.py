"""Run one cell of BENCHMARK.json on the card(s) of this machine.

    python3 portbench/run.py --workload C.random --seed 7 --seconds 30 --trace 0

The last line of standard output is the result: one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks`` (each number the
correctness check compared, beside its limit). The same checks end
standard error. A cell on several cards starts one process per card
itself; rank 0 prints the result.
"""

import time

T0 = time.time()  # set-up is counted from here (wall clock: the ranks share it)

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Every cache the program or PyTorch writes lives at a fixed path inside
# the checkout, so that only a cell's first run there builds anything.
# (pogema_torch builds its kernels into build/kernels/ of the checkout.)
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "portbench",
                                                           "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "portbench", "triton"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from portbench import harness

    sys.exit(harness.main(sys.argv[1:], float(os.environ.get("PORTBENCH_T0", T0))))
