"""Benchmark of the PyTorch/CUDA port (``src/repro_torch``): one run of
one cell.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout holding ``BENCHMARK.json``, ``bench/`` and
``src/``.  Prints the device on an earlier line, progress and the
numbers the check compares on standard error (those last, each beside its
limit), and one JSON object as the last line of standard output.  Exits
non-zero without a result when no CUDA device (or fewer than the cell
asks for) is present, or when a module of JAX or of the JAX package is
loaded.
"""
import os
import sys
import time


def _process_start() -> float:
    """``time.perf_counter()`` at this process's start (Linux), else now."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[_var] = os.path.join(ROOT, ".bench_cache", _dir)
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

if __name__ == "__main__":
    from bench.harness.cli import main
    sys.exit(main(sys.argv[1:], T_START, ROOT))
