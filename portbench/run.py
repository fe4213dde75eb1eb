"""The benchmark of the PyTorch/CUDA port (``rfs_slam_tpu_torch``): one run
of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Starts the cell's runs, each its own process on the card, waits until all
have set up and warmed up, starts them together, and stops each at the
deadline; the window runs from the common start to the last run's end.
Then each run's sampled steps are recomputed by the plain reference
(``portbench/reference/``) and compared.  The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and ``check`` last (each
number compared beside its limit, also the last lines of standard error).
Exits 2 without a result where the card is missing, 1 where a run fails or
the process holds JAX or the JAX package.
"""

import time

T_PROCESS = time.monotonic()   # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import check, spec, stats, trace, worker  # noqa: E402

BARRIER_TIMEOUT = 300.0
START_LEAD_S = 0.1   # from the last run's arrival to the common start
RESULT_TIMEOUT = 330.0
OP_NAME_CHARS = 160   # a device operation's name in the breakdown


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths:
    the port's kernels build into ``build/kernels``, PyTorch's runtime-
    compiled kernels (``PYTORCH_KERNEL_CACHE_PATH``) and any extension or
    Triton build under ``build/portbench``."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = os.path.join(ROOT, "build", "portbench", sub)
        os.makedirs(os.environ[var], exist_ok=True)
    os.environ["USE_FLAX"] = "0"


def launch(c: dict, args, modes=("sound",), fault=None):
    """Spawn the cell's runs; returns ``(common start, results, errors)``
    (the start None where a run failed before it).  ``fault``, the name of
    one of :mod:`portbench.faults`, breaks the program in every run (for
    the readings that set the limits; the benchmark's runs plant none)."""
    import multiprocessing as mp

    n = c["traffic"]["runs"]
    ctx = mp.get_context("spawn")
    # ready, go, window closed, memory read
    barriers = [ctx.Barrier(n + 1) for _ in range(4)]
    start_value = ctx.Value("d", 0.0)
    results = ctx.Queue()
    procs = []
    for i in range(n):
        task = {"spec": c, "index": i, "seed": args.seed,
                "seconds": args.seconds, "trace": bool(args.trace),
                "device": "cuda:0", "threads": c["traffic"][
                    "threads_per_run"], "modes": list(modes),
                "fault": fault, "barrier_timeout": BARRIER_TIMEOUT}
        p = ctx.Process(target=worker.main,
                        args=(task, barriers, start_value, results))
        p.start()
        procs.append(p)
    got, errors = [], []
    try:
        try:
            barriers[0].wait(BARRIER_TIMEOUT)
            start_value.value = start = time.monotonic() + START_LEAD_S
            barriers[1].wait(BARRIER_TIMEOUT)
            barriers[2].wait(BARRIER_TIMEOUT + args.seconds)
            barriers[3].wait(BARRIER_TIMEOUT)
        except Exception:   # a run failed: its error is in the queue
            start = None
            for b in barriers:
                b.abort()
        while len(got) + len(errors) < n:
            kind, out = results.get(timeout=RESULT_TIMEOUT)
            (got if kind == "ok" else errors).append(out)
    finally:
        for p in procs:
            p.join(timeout=60)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return start, got, errors


def limits_of(c: dict) -> dict:
    return c["cell"]["check"]["limits"]


def judge(c: dict, got: list) -> tuple[dict, int, int, int]:
    """The worst of each number compared over every run's kept steps,
    the steps compared, those outside a limit and those in which the
    reference resampled."""
    lim = limits_of(c)
    rows = [r["sound"] for out in got for r in out["readings"]]
    failed = sum(not check.verdict(r, lim) for r in rows)
    return (check.worst(rows), len(rows), failed,
            sum(r["resampled"] for r in rows))


def end_to_end(c: dict, start: float, got: list) -> dict:
    """The cell's end-to-end values from its runs."""
    values = {
        "setup_s": start - T_PROCESS,
        "steps_per_s": stats.window_rate([g["steps"] for g in got], start,
                                         [g["end"] for g in got]),
        "step_ms_p95": stats.p95([x for g in got
                                  for x in g["intervals_ms"]]),
    }
    return {k: values[k] for k in c["end_to_end"]}


def per_layer(c: dict, got: list, card: dict) -> dict:
    """Each per-layer reader's value (a reader that finds nothing to read
    returns None, and the metric is left out)."""
    runs = [g["trace"] for g in got]
    out = {}
    for name in c["per_layer"]:
        v = spec.metric(name).read(runs, card)
        if v is not None:
            out[name] = v
    return out


def report_runs(got: list, start: float) -> None:
    """Each run's set-up stages, steps, progress and end, its own step
    intervals (95th percentile, the share over 1.5 times its median), the
    context switches of its process in the window, its traced stretch and
    its compared steps that differ, on standard error."""
    for g in got:
        st = g["stages"]
        line = (f"run {g['index']}: built {st[1][1] - st[0][1]:.2f} s, "
                f"warm {st[2][1] - st[1][1]:.2f} s, waited "
                f"{start - st[2][1]:.2f} s; {g['steps']} steps, end "
                f"{g['end'] - start:.3f} s")
        p = g["progress"]
        line += f"; steps by each 5 s {p[4::5]}"
        iv = g["intervals_ms"]
        if iv:
            med = statistics.median(iv)
            line += (f"; intervals p95 {stats.p95(iv):.2f} ms, over 1.5x "
                     f"median {sum(x > 1.5 * med for x in iv) / len(iv):.4f}")
        line += (f"; context switches voluntary {g['switches'][0]}, "
                 f"involuntary {g['switches'][1]}")
        t = g.get("trace")
        if t:
            line += (f"; stretch {t['traced_steps']} steps, "
                     f"{t['launches']} launches")
        print(line, file=sys.stderr)
        for r in g["readings"]:
            if r["sound"]["fields"]:
                print(f"run {g['index']} step {r['step']} (k {r['k']}): "
                      f"{r['sound']}", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    c = spec.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < c["chips"]:
        print(f"portbench: {args.workload} needs {c['chips']} CUDA "
              f"device(s); found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    from rfs_slam_tpu_torch.ops.kernels import build

    build.load_all(c["config"]["kernels"])   # the first run builds them
    card = card_line()
    start, got, errors = launch(c, args)
    if errors or start is None:
        for e in errors:
            print(f"run {e['index']} failed:\n{e['error']}", file=sys.stderr)
        return 1
    got.sort(key=lambda g: g["index"])
    bad = sorted(set(worker.loaded_forbidden()).union(
        *(g["forbidden"] for g in got)))
    if bad:
        print(f"portbench: JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 1

    report_runs(got, start)
    lim = limits_of(c)
    worst, compared, failed, resampled = judge(c, got)
    correct = failed == 0 and compared > 0
    units = c["units"]
    device = {"platform": "gpu", "kind": got[0].get("device_name", card),
              "count": c["chips"],
              "memory_peak_bytes": max(g["memory_used"] for g in got)}
    line = {"correct": correct,
            "attempted": sum(g["steps"] for g in got), "failed": failed}
    if args.trace:
        tc = trace.card([g["trace"] for g in got])
        values = per_layer(c, got, tc)
        device.update(busy_s=tc["busy_s"], window_s=tc["window_s"])
        line["breakdown"] = {
            "device_ops": [[n[:OP_NAME_CHARS], s]
                           for n, s in tc["ops"].most_common(10)],
            "idle_gaps": [[n, s] for n, s in tc["idle"].most_common(10)]}
    else:
        values = end_to_end(c, start, got)
    line["metrics"] = {k: {"value": v, "unit": units[k]}
                       for k, v in values.items()}
    line["device"] = device
    # an infinite gap (a field finite on one side only) prints as 1e300
    line["check"] = {k: {"value": worst[k] if math.isfinite(worst[k])
                         else 1e300, "limit": lim[k]}
                     for k in check.NUMBERS}
    line["check"]["steps_compared"] = compared
    line["check"]["steps_resampled"] = resampled
    print(f"portbench: {args.workload} seed {args.seed} on {card}: "
          f"{len(got)} runs", file=sys.stderr)
    for k in check.NUMBERS:
        v = worst[k]
        print(f"check {k} {v!r} limit {lim[k]!r}"
              f"{'' if v <= lim[k] else ' OVER'}", file=sys.stderr)
    print(f"check steps_compared {compared}", file=sys.stderr)
    print(f"check steps_resampled {resampled}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
