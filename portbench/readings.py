"""The readings a cell's limits are set from, in one process.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--control-kind bfloat16] --seconds 3 \
        [--control-seconds 3] [--out FILE]

For each seed of ``--seeds`` a run of the program (a window of
``--seconds``, then the check), and for each of ``--control-seeds`` a run
of the plain reference in the program's place on the same inputs, as the
variant ``--control-kind`` of ``reference/msgibbs.py``'s ``VARIANTS``: the
control, one precision below the configuration's (``bfloat16`` for
float32), or a fault planted in its chains (``no_hooks``, ``one_sweep``,
``last_alone``), for a window of ``--control-seconds`` where the traffic
has one.  One JSON line a run, with every number the check compared;
``--out`` appends them to a file too.  The benchmark's own runs never run the reference in the
program's place.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control-kind", default="bfloat16")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seconds", type=float)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from portbench import core
    runs = ([(int(s), None) for s in args.seeds.split(",") if s]
            + [(int(s), args.control_kind)
               for s in args.control_seeds.split(",") if s])
    for seed, control in runs:
        t = time.perf_counter()
        c = core.cell(args.workload, seed, "cuda")
        seconds = (args.control_seconds if control and args.control_seconds
                   else args.seconds)
        out = core.run(c, seconds, False, t, control=control)
        line = json.dumps({"workload": c.name, "seed": seed,
                           "control": control, "correct": out["correct"],
                           "attempted": out["attempted"],
                           "checks": {k: v["value"]
                                      for k, v in out["checks"].items()},
                           "metrics": {k: v["value"]
                                       for k, v in out["metrics"].items()},
                           "seconds": time.perf_counter() - t})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
