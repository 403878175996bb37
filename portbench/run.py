"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload nyt-fit --seed 7 --seconds 30 --trace 0

from the root of a checkout.  The cell, its configuration, its traffic mix
and its per-layer metrics are found by name (see `harness`).  Exits with 2,
printing no result, when this machine has fewer CUDA cards than the cell
asks for, and with 3 when a module of the JAX stack or the JAX package was
loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.use_checkout_caches()
    c = harness.cell(args.workload)
    try:
        line = harness.run_cell(c, seed=args.seed, seconds=args.seconds,
                                trace=bool(args.trace), t_start=T_START)
    except harness.NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    except ImportError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    harness.print_line(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
