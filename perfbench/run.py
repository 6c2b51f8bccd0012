"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout; the last line of standard output is the
result (``perfbench/README.md``).  Every cache the program or the
benchmark writes goes to fixed directories under the checkout's
``build/``.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path[:0] = [str(HERE), str(ROOT / "src")]

from harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main.main(sys.argv[1:], T_START))
