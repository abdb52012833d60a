"""The readings that a cell's limits are set from, at the cell's own size,
on the card; the benchmark's own runs never run this.

    python benchmark/control.py --workload <name> --seeds 1,2,3 \\
        [--program] [--control] [--faults]

``--program``: the program's set-up, a window of ``--window`` seconds and
its check on each seed (the lower readings; for a mesh cell ``--scenes``
scenes, all compared). ``--control``: the plain reference in the program's
place in the nearest precision below the configuration's (fp8 where it
states bfloat16, TF32 for its float32 products), held against the
reference. ``--faults`` (training cells): the reference in the program's
place with half of the rays left out and the mean taken over the rest
(``half_batch``), or with each ray given its neighbour's rendered colour
(``altered``). With ``--program`` each of these is also read for the
window's last step, from the state the program's step started from. Witnesses: ``--witness``, the reference rounded to
bfloat16 where the configuration states it; ``--f32-program``, the program
with those places in float32. Prints one JSON line per seed and reading.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from harness import compare, core  # noqa: E402


def train_readings(cell, loop, seed, device, args):
    import torch

    from harness.weights import cell_weights

    out = []
    st = None
    if args.program:
        st = loop.setup(cell, seed, device)
        win = loop.window(st, args.window, False)
        out.append(("program", loop.check(st, win)))
    if args.f32_program:
        f32 = loop.setup(f32_cell(cell), seed, device)
        out.append(("program_f32", loop.check(f32, {})))
        del f32
    if st is not None:
        init, truth = st.init, st.ref_first
    else:
        init = {k: v.to("cpu") for k, v in
                cell_weights(cell, device).items()}
        truth = loop.reference_steps(cell, init, loop.make_pool(cell, seed),
                                     seed, device)
    pool = loop.make_pool(cell, seed)
    variants = []
    if args.control:
        variants.append(("control", dict(prec_kind="fp8", tf32=True)))
    if args.witness:
        variants.append(("reference_bf16", dict(prec_kind="bf16")))
    if args.faults:
        variants += [("half_batch", dict(fault="half_batch")),
                     ("altered", dict(fault="altered"))]
    for name, kw in variants:
        got = loop.reference_steps(cell, init, pool, seed, device, **kw)
        values = compare.train_numbers(got, truth, init)
        if st is not None:
            # the same in the program's place for the window's last step
            values.update(compare.last_step_numbers(
                loop.last_step_reference(st, **kw), st.ref_last,
                st.last["before"]["params"]))
        out.append((name, values))
        torch.cuda.empty_cache()
    return out


def mesh_readings(cell, loop, seed, device, args):
    import numpy as np

    out = []
    if args.program:
        st = loop.setup(cell, seed, device)
        done = [loop.run_scene(st) for _ in range(args.scenes)]
        out.append(("program", loop.check(st, {"compared": done})))
        if args.control:
            out.append(("control_mesh", mesh_stage_control(done, device)))
        del st, done
    if args.control:
        from harness.weights import cell_weights

        weights = {k: v.to("cpu") for k, v in
                   cell_weights(cell, device).items()}
        worst = {"volume": 0.0, "grid": 0.0}
        for i in range(1, args.scenes + 1):
            scene = loop.make_scene(cell, seed, i)
            truth = loop.reference_scene(cell, weights, scene, device)
            ctl = loop.reference_scene(cell, weights, scene, device,
                                       prec_kind="fp8", tf32=True)
            res = loop.dims(cell)["resolution"]
            pts = compare.grid_points(loop.sample_indices(cell, seed, i),
                                      res, [-1.0] * 3, [1.0] * 3)
            gap = float(np.max(np.abs(loop.sampled_sdf(ctl, pts, device)
                                      - loop.sampled_sdf(truth, pts,
                                                         device))))
            vol = compare.volume_gap(ctl["volumes"], truth["volumes"])
            worst = {"volume": max(worst["volume"], vol),
                     "grid": max(worst["grid"], gap)}
            del truth, ctl
        out.append(("control", worst))
    return out


def mesh_stage_control(done, device):
    """The isosurface stage's control: the reference isosurface of each
    program grid rounded to TF32's 10 mantissa bits, against the one of
    the grid as it is."""
    import torch

    from reference.gens_plain import round_mantissa
    from reference.isosurface import isosurface_stats

    worst = {"mesh_count": 0.0, "mesh_area": 0.0}
    for r in done:
        g = torch.from_numpy(r["grid"]).to(device)
        a = isosurface_stats(g, [-1.0] * 3, [1.0] * 3)
        b = isosurface_stats(round_mantissa(g, 10), [-1.0] * 3, [1.0] * 3)
        worst = {"mesh_count": max(worst["mesh_count"], float(
                     abs(a["n_tris"] - b["n_tris"])
                     + abs(a["n_verts"] - b["n_verts"]))),
                 "mesh_area": max(worst["mesh_area"],
                                  abs(a["area"] - b["area"])
                                  / max(a["area"], 1e-30))}
        del g
    return worst


def f32_cell(cell):
    """The cell with every bfloat16 place of its configuration in float32
    (a witness run of the program)."""
    import copy

    cell = copy.copy(cell)
    cell.config = copy.deepcopy(cell.config)
    m = cell.config["config"]["model"]
    m["volume"].update(dtype="float32", packed_bilerp="table")
    m["reg_network"]["dtype"] = "float32"
    m["sdf_network"].update(volume_dtype="float32", mlp_dtype="float32")
    m["color_network"].update(packed_bilerp=False, packed_dtype="float32",
                              mlp_dtype="float32")
    return cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--witness", action="store_true",
                    help="the reference rounded to bfloat16 where the "
                    "configuration states it, in the program's place")
    ap.add_argument("--f32-program", action="store_true",
                    help="the program with every bfloat16 place of the "
                    "configuration in float32")
    ap.add_argument("--scenes", type=int, default=3)
    ap.add_argument("--window", type=float, default=3.0)
    args = ap.parse_args(argv)
    core.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = core.Cell(args.workload)
    loop = cell.loop()
    readings = (train_readings if cell.traffic["loop"] == "train"
                else mesh_readings)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        for name, values in readings(cell, loop, seed, device, args):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": name, "values": values,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
