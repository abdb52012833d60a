"""One rank of a gloo group for tests/test_torch_parallel.py: torch and
gens_torch only (no JAX), so that a rank starts in seconds.

    python tests/_torch_mp_worker.py <rank> <world> <port> <payload> <out>

``payload`` (pickle) holds ``n_data``, ``n_view``, the port ``cfg``, the
model ``state``, ``batches`` (one batch of numpy arrays per data row),
``noise`` and ``sparse`` (one per data row, split over the view group
here), ``anneal`` and ``collectives`` (also check each collective
Function). The rank runs one :class:`ShardedTrainStep` and pickles its
metrics, the all-reduced gradients and the updated parameters to ``out``.
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def check_collectives(rank: int, world: int) -> dict:
    """Each collective Function on rank-dependent inputs, its value and the
    input's gradient under a rank-dependent cotangent."""
    import torch

    from gens_torch.parallel import collectives as col

    out = {}
    for name, fn in (("all_reduce_sum", col.all_reduce_sum),
                     ("all_gather_views", col.all_gather_views),
                     ("share_sum", col.share_sum)):
        g = torch.Generator().manual_seed(rank)
        x = torch.randn(3, 4, generator=g, dtype=torch.float64,
                        requires_grad=True)
        y = fn(x, None)
        ct = torch.randn(y.shape, generator=g, dtype=torch.float64)
        (y * ct).sum().backward()
        out[name] = {"x": x.detach().numpy(), "ct": ct.numpy(),
                     "y": y.detach().numpy(), "grad": x.grad.numpy()}
    return out


def main():
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    payload_path, out_path = sys.argv[4], sys.argv[5]

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from gens_torch.models.gens import GenSModel
    from gens_torch.parallel.distributed import (ProcessEnv, initialize,
                                                 make_layout)
    from gens_torch.parallel.sharded import ShardedTrainStep, shard

    with open(payload_path, "rb") as f:
        p = pickle.load(f)
    initialize(ProcessEnv(rank, world, f"localhost:{port}"), "gloo")
    out = {}
    if p["collectives"]:
        out["collectives"] = check_collectives(rank, world)
    layout = make_layout(p["n_data"], p["n_view"])
    model = GenSModel(p["cfg"].model)
    model.load_state_dict(p["state"])
    step = ShardedTrainStep(model, p["cfg"], 1, layout)
    row, col, nv = layout.data_row, layout.view_col, layout.n_view
    inputs = {k: torch.from_numpy(v) for k, v in p["batches"][row].items()}
    metrics = step(inputs, p["anneal"],
                   perturb_noise=shard(torch.from_numpy(p["noise"][row]),
                                       nv, col),
                   sparse_pts=shard(torch.from_numpy(p["sparse"][row]),
                                    nv, col))
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["grads"] = {k: q.grad.numpy() for k, q in model.named_parameters()
                    if q.grad is not None}
    out["params"] = {k: q.detach().numpy()
                     for k, q in model.named_parameters()}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
