"""The readings a cell's limits are set from: the program and its control.

    python3 -m rdbench.control --workload <cell> --seeds <n> [<n> ...] [--numbers <name> ...] [--out FILE]

For each seed, in one process, the cell's builder (``readings`` in
``rdbench/builders/<builder>.py``) runs the program on clip 0 of the seed
at the cell's own size and call, and each number's control, one
precision step below the one its stage runs in, and computes the numbers
of the check: those the cell's ``limits`` name, or ``--numbers``.  A
sound limit lies above every program reading and below every control
reading.  Prints one JSON line a seed, then each number's range on each
side, and writes the rows to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run


def readings(name: str, seed: int, device: str = "cuda", bench_dir: str = run.HERE, numbers=None) -> dict:
    """Clip 0 of ``seed``: the program's numbers ``numbers`` (default: those
    the cell's ``limits`` name) and, for each, its control's."""
    spec = run.load_cell(name, bench_dir)
    names = set(numbers or spec["cell"]["limits"])
    return spec["builder"].readings(spec, seed, device, names)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--numbers", nargs="+", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    rows = []
    for seed in args.seeds:
        rows.append(readings(args.workload, seed, numbers=args.numbers))
        print(json.dumps(rows[-1]), flush=True)
    for side in ("program", "control", "faults"):
        for key in rows[0].get(side, {}):
            vals = [r[side][key] for r in rows]
            print(json.dumps({"side": side, "number": key, "min": min(vals), "max": max(vals)}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
