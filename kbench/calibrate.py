"""Readings to set a cell's limits from: the program's compared numbers
over many seeds, and the control's (the reference one precision lower put
in the program's place) over some of them, all in one process.

  python3 kbench/calibrate.py --workload <cell> --seeds 11,12,13 \
      --control 3 --seconds 3 --out calib.jsonl

Each seed is a whole run of the cell (set-up, a short window at the cell's
load, the check); one JSON line a seed goes to standard output and to
``--out``. The benchmark's own runs never compute the control.
``--fault <name>`` plants one of ``kbench/faults.py``'s faults in the port
for the whole process, to read it at the cell's size; ``--dtype float32``
serves the model in float32 instead of the configuration's dtype, a
witness of what the served precision alone does to the numbers.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[:0] = [str(Path(__file__).resolve().parent)]
import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--control", type=int, default=3,
                    help="how many of the first seeds also read the control")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--dtype", default=None)
    args = ap.parse_args(argv)
    run.prepare_environment()
    from kbench import faults, harness
    cell = harness.load_cell(args.workload, trace=False)
    if args.fault:
        faults.plant(args.fault)
    if args.dtype:
        cell.config["model"]["dtype"] = args.dtype
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    try:
        for i, seed in enumerate(seeds):
            started = STARTED if i == 0 else time.perf_counter()
            res = harness.run_cell(cell, seed, args.seconds, False, "cuda:0",
                                   started, control=i < args.control)
            line = json.dumps({
                "workload": cell.name, "seed": seed, "fault": args.fault,
                "dtype": cell.config["model"]["dtype"],
                "correct": res["correct"],
                "program": {k: c["value"] for k, c in res["checks"].items()},
                "control": res.get("control"),
                "metrics": {k: m["value"] for k, m in res["metrics"].items()},
                "device": res["device"]})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    found = run.forbidden_modules()
    if found:
        print(f"calibrate: loaded {found}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
