"""Run one cell of the benchmark once and print its result as the last line:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See ``benchmark/harness/cli.py``. Every build and kernel cache sits at a
fixed path inside the checkout (``build/``), so only a checkout's first run
builds; nothing is written outside the checkout but under ``TMPDIR``.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
os.environ["USE_FLAX"] = "0"   # transformers must not load JAX or flax
os.environ["USE_JAX"] = "0"
os.environ["USE_TF"] = "0"
os.environ["USE_TORCH"] = "1"
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from benchmark.harness import cli

    sys.exit(cli.run(sys.argv[1:], t0=T0))
