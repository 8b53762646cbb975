"""Entry point of the port's benchmark; see ``gpubench/harness.py``.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout. The port's kernels build into
``pcp_tpu_torch/_build``, and any PyTorch extension or Triton cache into
``gpubench/_cache``, both inside the checkout, so only a checkout's first
run builds.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "gpubench", "_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)

from gpubench.harness import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main(t_start=T_START))
