"""The readings that a cell's limits are set from, on the card: for each
seed, the cell's runs at its own load for a window, then each kept step
read twice: the program against the reference (a sound run) and the
control, the reference computed with TF32 matmuls (the nearest precision
below the configuration's float32 with TF32 off), against the reference.
With ``--fault F`` the program runs with fault F of
:mod:`portbench.faults` planted and is read against the reference alone.

    python3 portbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] --out <file.jsonl> [--fault F] [--timing]

One JSON line a seed: every kept step's numbers in each mode, the worst
of each, and with ``--timing`` each run's step intervals (device events),
the host's time of each step's end of enqueue from the common start and
its context switches in the window.  The benchmark's own runs do not run
this.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import check, faults, run, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--timing", action="store_true")
    args = ap.parse_args(argv)
    modes = ("sound",) if args.fault else ("sound", "tf32")
    run.cache_dirs()
    c = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("control: needs the card", file=sys.stderr)
        return 2
    from rfs_slam_tpu_torch.ops.kernels import build

    build.load_all(c["config"]["kernels"])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        for seed in args.seeds:
            ns = argparse.Namespace(seed=seed, seconds=args.seconds, trace=0)
            start, got, errors = run.launch(c, ns, modes, args.fault)
            if errors or start is None:
                for e in errors:
                    print(e["error"], file=sys.stderr)
                return 1
            rows = [dict(run=g["index"], **r) for g in got
                    for r in g["readings"]]
            worst = {m: check.worst([r[m] for r in rows]) for m in modes}
            rec = {"workload": args.workload, "seed": seed,
                   "fault": args.fault,
                   "steps": sum(g["steps"] for g in got), "worst": worst,
                   "rows": rows}
            if args.timing:
                rec["timing"] = [
                    {"run": g["index"], "switches": g["switches"],
                     "intervals_ms": [round(x, 4) for x in g["intervals_ms"]],
                     "host_s": [round(x, 5) for x in g["host_s"]]}
                    for g in got]
            f.write(json.dumps(rec) + "\n")
            f.flush()
            print(json.dumps({"seed": seed, "fault": args.fault,
                              "worst": worst, "compared": len(rows),
                              "resampled": sum(r["sound"]["resampled"]
                                               for r in rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
