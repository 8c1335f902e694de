"""Readings that the limits of the correctness check are set from.

    python3 portbench/calibrate.py --workload D.serve --impl program --seeds 11,12,13 --seconds 6

For each seed, in one process: ``program`` makes a short run of the
cell and prints what its check compared; ``control`` prints what the
check compares when the cell's control takes the program's place (the
reference in the precision below the configuration's, or, where the
configuration states no precision, with one of its guarantees broken);
``half_batch`` and ``exchange`` plant that fault in the train step. One
JSON line per seed on standard output (rank 0), also appended to
``--out``. The benchmark's own runs never run this.
"""

import time

T0 = time.time()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    import argparse

    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--impl", default="program",
                    choices=("program", "control", "half_batch", "exchange"))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = harness.Cell(harness.load_manifest(), args.workload)
    rank = int(os.environ.get("PORTBENCH_RANK", "-1"))
    if cell.chips > 1 and rank < 0:
        return harness.launch("calibrate.py", argv, cell.chips, T0)
    world, rank = harness.join(cell, max(rank, 0)), max(rank, 0)
    driver = harness.load_module("drivers", cell.traffic["driver"])
    # Read every number the driver can compare, not only those the cell's
    # limits name.
    cell.limits = {**{n: float("inf") for n in getattr(driver, "NUMBERS", ())}, **cell.limits}
    for seed in [int(s) for s in args.seeds.split(",")]:
        ctx = harness.Context(cell, seed, "cuda", False, rank, world)
        t = time.time()
        if args.impl == "program" and cell.traffic["driver"] == "train":
            drv = driver.Driver(ctx)  # the checked steps are set-up's: no window needed
            drv.setup()
            drv.release()
            checks = drv.check()
        elif args.impl == "program":
            checks = harness.measure(ctx, args.seconds, t)[1]
        else:
            checks = driver.planted(ctx, args.impl, args.seconds, harness.measure)
        if rank == 0:
            line = json.dumps({"workload": cell.name, "impl": args.impl, "seed": seed,
                               "seconds": time.time() - t,
                               "checks": {n: v for n, v, _ in checks}})
            print(line, flush=True)
            if args.out:
                os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    if world > 1:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main(sys.argv[1:]))
