"""On-card probe of the bilinear sample's backward on the adaptive
aggregation's training step (gens_torch on one NVIDIA GPU).

    python3 scripts/adaptive_backward_probe.py

Writes chip_smoke.py's DTU-layout tree under build/, trains
confs/dtu.yaml for 3 steps under chip_smoke.OPTIONS["adaptive"] and under
the yaml as written (mean ‖ var), then times 6 more steps of each, in
turns, with ``gens_torch.ops.interp.bilerp`` (the gather through
``index_select``, whose backward is ``index_add_``) and with the same
function gathering by advanced indexing (``flat[idx]``, whose backward
sorts the indices and sums each run of equal ones in one warp), and
profiles one step of each. Prints one JSON line per config.
"""

import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
import gens_torch.models.volume as vol_mod  # noqa: E402
import gens_torch.ops.interp as interp  # noqa: E402
import gens_torch.ops.projection as proj_mod  # noqa: E402
from gens_torch.main import main as gens_main  # noqa: E402
from gens_torch.runner import get_dataset  # noqa: E402
from gens_torch.utils import libraries  # noqa: E402


def bilerp_advanced_indexing(image, xy):
    """``interp.bilerp`` with the gather as ``flat[idx]``."""
    H, W, C = image.shape
    x, y = xy[..., 0], xy[..., 1]
    x0f, y0f = torch.floor(x.detach()), torch.floor(y.detach())
    x0, y0 = x0f.long(), y0f.long()
    wx1, wy1 = x - x0f, y - y0f
    flat = image.reshape(H * W, C)
    out = None
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        ix, iy = x0 + dx, y0 + dy
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        vals = flat[iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)]
        w = ((wx1 if dx else 1.0 - wx1) * (wy1 if dy else 1.0 - wy1)
             * valid.to(wx1.dtype))
        term = vals * w[..., None]
        out = term if out is None else out + term
    return out


def use(fn) -> None:
    vol_mod.bilerp = fn
    proj_mod.bilerp = fn


def main() -> int:
    if not torch.cuda.is_available():
        print("adaptive_backward_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    libraries.build(libraries.cuda_libraries())
    tree = cs.write_dtu_tree(os.path.join(REPO, "build", "chip_smoke_dtu"))
    data = [f"{ds}.{k}" for ds in ("train_dataset", "val_dataset")
            for k in (f"data_dir={tree}", f'scene=["{cs.DTU_SCAN}"]')]
    sides = {"index_select": interp.bilerp,
             "advanced_indexing": bilerp_advanced_indexing}
    for name, opts in (("adaptive", cs.OPTIONS["adaptive"]),
                       ("mean_var", [])):
        use(sides["index_select"])
        runner = gens_main([
            "--conf", os.path.join(REPO, "confs", "dtu.yaml"), "--mode",
            "train", "--set",
            f"base_exp_dir={os.path.join(REPO, 'build', 'probe_' + name)}",
            "train_dataset.ref_view=[0,1,2]", "train.epochs=1"]
            + opts + data)
        inputs = runner._tensors(
            get_dataset(runner.cfg.train_dataset, "train")[0])
        res = {side: [] for side in sides}
        for side in ("index_select", "advanced_indexing",
                     "advanced_indexing", "index_select", "index_select",
                     "advanced_indexing"):
            use(sides[side])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = runner.step_fn(inputs, 1.0, generator=runner.generator,
                               timing=True)
            torch.cuda.synchronize()
            res[side].append({"ms": (time.perf_counter() - t0) * 1e3,
                              "phase_ms": m["phase_ms"]})
        for side, fn in sides.items():
            use(fn)
            res[side + "_profile"] = cs.profile_step(
                lambda: runner.step_fn(inputs, 1.0,
                                       generator=runner.generator))
        use(sides["index_select"])
        print(f"{name} probe: " + json.dumps({
            "run_steps_ms": [s["step_s"] * 1e3 for s in runner.train_stats],
            **res}), flush=True)
        del runner
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
