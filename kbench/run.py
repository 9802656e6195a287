"""The benchmark's one command: one run of one cell of ``BENCHMARK.json``.

  python3 kbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints progress and, as its last lines, each number compared beside its
limit on standard error, and the result as one JSON object on the last line
of standard output. Exits non-zero, printing no result, where the cell's
CUDA devices are missing, where the port cannot be imported, or where JAX
or the JAX package was loaded. Caches (the kernels' build in
``build/kernels/``, the scheduler's decision store in ``kbench/.cache/``)
stay inside the checkout.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# top-level module names that must not be loaded, compared whole: the port's
# name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def prepare_environment() -> None:
    """Caches at fixed paths inside the checkout (the scheduler's
    decision store; Triton's, for any kernel of the port written in it),
    the port and the benchmark importable."""
    cache = ROOT / "kbench" / ".cache"
    os.environ["REPRO_TORCH_IPC_CACHE"] = str(cache / "ipc")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    args = parse(argv)
    prepare_environment()
    from kbench import harness
    cell = harness.load_cell(args.workload, trace=bool(args.trace))
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"kbench: the cell {cell.name!r} needs {cell.chips} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() {have}",
              file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"kbench: the port cannot be imported ({e}); run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", STARTED)
    found = forbidden_modules()
    if found:
        print(f"kbench: the run loaded {found}: nothing it runs may "
              "import JAX or the JAX package", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
