"""The readings that ``finetune-train``'s limits are set from, on the card;
the benchmark's own runs never run this.

    python benchmark/control_finetune.py --seeds 1,2,3 [--control] \\
        [--faults] [--window 3]

Each seed: the program's set-up, a window of ``--window`` seconds and its
check (the lower readings); with ``--control`` the plain finetune
reference in the program's place with its float32 products in TF32, the
nearest precision below the configuration's float32, in the steps and in
the build of the initial leaves (``build``); with ``--faults``
the reference in the program's place with the volumes' learning rates in
reverse order (``lr_vol_reversed``), with the finest volume given no
gradient (``volume_grad_dropped``), with each ray given its neighbour's
rendered colour (``altered``) or with the loss over half of the rays
(``half_batch``). Each of those is read for the first steps and for the
window's last step, from the state the program's step started from,
against the reference. Prints one JSON line per seed and reading.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from harness import core  # noqa: E402

WORKLOAD = "finetune-train"


def readings(cell, loop, seed, device, args):
    import torch

    st = loop.setup(cell, seed, device)
    win = loop.window(st, args.window, False)
    yield "program", loop.check(st, win)
    variants = []
    if args.control:
        variants.append(("control", dict(tf32=True)))
    if args.faults:
        variants += [(f, dict(fault=f)) for f in loop.FAULTS]
    init = loop.trained_init(st)
    for name, kw in variants:
        got = loop.reference_steps(cell, st.init, st.leaves0, st.views,
                                   st.vids, seed, device, **kw)
        got_last = loop.last_step_reference(st, **kw)
        values = {}
        if kw.get("tf32"):
            values["build"] = loop.build_gap(
                loop.reference_leaves(cell, st.init, loop.scene_inputs(
                    st.scene, device), device, tf32=True),
                {k: [t.to(device) for t in ts]
                 for k, ts in st.leaves0.items()})
        values.update(loop.numbers(got, st.ref_first, init, got_last,
                                   st.ref_last, st.last["before"]))
        yield name, values
        del got, got_last
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--window", type=float, default=3.0)
    args = ap.parse_args(argv)
    core.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = core.Cell(WORKLOAD)
    loop = cell.loop()
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        for name, values in readings(cell, loop, seed, device, args):
            print(json.dumps({"workload": WORKLOAD, "seed": seed,
                              "reading": name, "values": values,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
