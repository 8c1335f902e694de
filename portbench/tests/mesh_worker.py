"""One gloo rank of a tiny data mesh on the CPU for the tests:
``mesh_worker.py <rank> <world> <port> <seed> <fault>``. Rank 0 prints
the checks and the bytes all-reduced as one JSON line."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def main(rank, world, port, seed, fault):
    import torch.distributed as dist

    from portbench import harness, reference
    from portbench.tests import tiny

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    cell = tiny.cell("D.train")
    cell.traffic["mesh"] = {"data": world, "model": 1}
    # Eight envs a rank: the CPU's BLAS sums a product of fewer than 8
    # rows in another order, and the sampled rollouts would part.
    cell.config["num_envs"] = 8 * world
    # On the CPU a rank's products of few rows round otherwise than one
    # process's, its bf16 policy parts from it and some sampled actions
    # with it: a sound two-rank run reads gaps of about 1e-3 here (against
    # 0.16-0.52 with a fault planted), so this size has limits of its own.
    cell.limits = {"loss_gap": 0.02, "grad_gap": 0.02, "change_gap": 0.02}
    ctx = harness.Context(cell, seed, "cpu", False, rank=rank, world=world)
    train = harness.load_module("drivers", "train")
    drv = train.Driver(ctx)
    if fault != "none":
        drv.patches = {"exchange": train.exchange_patch, "half_batch": train.half_batch_patch}[fault]()
    with reference.patched([]):
        run, checks = harness.measure(ctx, 0.0, 0.0, drv)
    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps({"checks": [[v, lim] for _, v, lim in checks],
                          "allreduce_bytes": run.counters["all_reduce_bytes"]}))


if __name__ == "__main__":
    r, w, p, s, f = sys.argv[1:]
    main(int(r), int(w), int(p), int(s), f)
