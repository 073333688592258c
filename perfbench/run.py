"""Run one cell of BENCHMARK.json once, on the card this process sees:

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and ``checks`` last); the numbers
compared with the plain reference, each with its limit, are the last
lines of standard error. Exits non-zero, printing no result, without
enough CUDA devices or when a JAX module got loaded.
"""
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout
_CACHE = os.path.join(ROOT, "build", "perfbench_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(_CACHE, _sub)
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
