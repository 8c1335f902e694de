"""A rank of the gloo meshes of the distributed tests (``torch_mesh_parity.
spawn`` starts it with torchrun's environment).

    python tests/torch_mesh_worker.py <spec.json>

The spec names the output directory, a ``torch.save`` of ``{family:
params}``, the tasks ('train', 'empty', 'rollout', 'grads'), the (data,
model) meshes and the train flavours. Every rank runs every task on
every mesh (they are collective); rank 0 saves each result beside an
index, ``index<world>.json``, of ``[task, data, model(, flavour)]`` ->
file.
"""

import json
import os
import sys

import torch


def main():
    torch.set_num_threads(1)
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    import torch_mesh_parity as h

    from pogema_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed(backend="gloo", device="cpu")
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    params = torch.load(spec["params"], weights_only=True)
    index = {}

    def save(key, result):
        if rank == 0:
            path = os.path.join(spec["out"], "_".join(map(str, key)) + f"_w{world}.pt")
            torch.save(result, path)
            index[json.dumps(list(key))] = path

    plans = [(tuple(c), spec["tasks"]) for c in spec["cases"]]
    if "grads" in spec["tasks"]:  # and tensor parallelism alone
        plans.append(((1, world), ["grads"]))
    for case, tasks in plans:
        mesh = make_mesh(*case, device="cpu")
        for task in tasks:
            if task == "grads":
                save(("grads",) + case, h.run_grads(params, mesh))
            elif task == "rollout":
                save(("rollout",) + case, {str(b): h.run_rollouts(params, mesh, b)
                                           for b in h.ROLLOUT_ENVS})
            elif task == "empty":
                save(("empty",) + case, h.run_train("recurrent", params["recurrent"], mesh,
                                                    num_envs=4))
            else:
                for flavour in spec["flavours"]:
                    family = h.FLAVOURS[flavour][0]
                    save(("train",) + case + (flavour,),
                         h.run_train(flavour, params[family], mesh))
    if rank == 0:
        with open(os.path.join(spec["out"], f"index{world}.json"), "w") as f:
            json.dump(index, f)
    print(f"RESULT {rank} {len(index)}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
