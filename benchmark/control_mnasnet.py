"""The readings that ``mnasnet-train``'s limits are set from, on the card:
``control.py``'s training readings, with ``features1`` beside them; the
benchmark's own runs never run this.

    python benchmark/control_mnasnet.py --seeds 1,2,3 [--control] \\
        [--faults] [--window 3]

Each seed: the program's set-up, a window of ``--window`` seconds and its
check (the lower readings, ``features1`` with them); with ``--control``
the plain reference in the program's place in the nearest precision below
the configuration's (fp8 where it states bfloat16, TF32 for its float32
products: in the backbone, TF32 alone), its ``features1`` the reference
backbone under TF32 against the one without; with ``--faults`` the
reference with half of the rays or each ray given its neighbour's colour
(``control.py``), whose backbone is the reference's own. Prints one JSON
line per seed and reading.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import control  # noqa: E402
from harness import core  # noqa: E402

WORKLOAD = "mnasnet-train"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--window", type=float, default=3.0)
    args = ap.parse_args(argv)
    # control.train_readings' switches: the program always, no witnesses
    args.program, args.f32_program, args.witness = True, False, False
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
        for name, values in control.train_readings(cell, loop, seed, device,
                                                   args):
            if name == "control":
                values["features1"] = loop.control_features1(
                    cell, loop.cell_weights_mnasnet(cell, "cpu"), seed,
                    device)
            print(json.dumps({"workload": WORKLOAD, "seed": seed,
                              "reading": name, "values": values,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
