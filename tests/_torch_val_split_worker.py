"""One rank of a gloo group for tests/test_torch_val_split.py: torch and
gens_torch only (no JAX), so that a rank starts in seconds.

    python tests/_torch_val_split_worker.py render <rank> <world> <port> \
        <payload> <out>
    RANK=r WORLD_SIZE=n MASTER_ADDR=localhost MASTER_PORT=p \
        python tests/_torch_val_split_worker.py main <out> <gens argv...>

``render``: ``payload`` (pickle) holds the port ``cfg``, the model
``state``, ``chunk`` and ``runs``, each a list of scenes (dicts of numpy
arrays: imgs, intrs, c2ws and the rays). For each run the rank takes its
validation group of that many scenes (``val_groups``); for each of the
group's scenes the leader builds it and broadcasts it with the rays, and
the group renders it split. Each rank pickles, per run, its group's ranks
and, per scene, the leader's render and every rank's render stats.

``main``: ``gens_torch.main.main(argv)``; pickles the runner's ``stats``,
``finetune_stats`` and ``metrics``.
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def render(rank, world, port, payload_path, out_path):
    import torch
    import torch.distributed as dist

    from gens_torch.models.gens import GenSModel
    from gens_torch.parallel.distributed import (ProcessEnv, initialize,
                                                 val_groups)
    from gens_torch.parallel.render_split import (RAY_KEYS, broadcast_scene,
                                                  split_render)

    with open(payload_path, "rb") as f:
        p = pickle.load(f)
    initialize(ProcessEnv(rank, world, f"localhost:{port}"), "gloo")
    model = GenSModel(p["cfg"].model)
    model.load_state_dict(p["state"])
    model.eval()
    device = torch.device("cpu")
    out = {"runs": []}
    for scenes in p["runs"]:
        group = val_groups(len(scenes))
        run = {"ranks": group.ranks, "scenes": {}}
        for idx in group.scenes:
            scene = rays = None
            if group.is_leader:
                item = {k: torch.from_numpy(v)
                        for k, v in scenes[idx].items()}
                with torch.no_grad():
                    scene = model.build_scene(item["imgs"], item["intrs"],
                                              item["c2ws"])
                rays = {k: item[k] for k in RAY_KEYS}
            if group.size > 1:
                scene, rays, _, _ = broadcast_scene(scene, rays, idx, group,
                                                    device)
            with torch.no_grad():
                rend, st = split_render(model.renderer, scene, rays,
                                        p["chunk"], group)
            run["scenes"][idx] = {"render": rend, "stats": st}
        out["runs"].append(run)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def main_run(out_path, argv):
    from gens_torch.main import main

    runner = main(argv)
    with open(out_path, "wb") as f:
        pickle.dump({"stats": runner.stats,
                     "finetune_stats": runner.finetune_stats,
                     "metrics": runner.metrics}, f)


if __name__ == "__main__":
    import torch

    torch.set_num_threads(1)
    if sys.argv[1] == "render":
        render(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
               sys.argv[6])
    else:
        main_run(sys.argv[2], sys.argv[3:])
