"""The quality protocol's training phases in the port with the JAX
package's gradient under ``sdf_network.packed_trilerp: true``
(tests/_reference_packed_grad.py installed): does that gradient explain
where the port's own runs leave the JAX records' bands (PERF.md §6-7)?

    python tests/_refgrad_train.py RUN [gens_torch.eval.quality_train flags]

``RUN`` names a recipe, run through ``gens_torch.eval.quality_train``:
``a_table`` phase a as ``QUALITY_r02.json`` ran it (seed 0, 1,500 steps);
``b_stage1`` the r04 stage-1 recipe of phase b (8,000 steps; ``--stop-at
N`` ends a segment, a later call with the same ``--out`` and
``--runs-dir`` resumes it); ``ft_r05`` the r05 finetune of the artifact
(2,000 steps at 480×640). The recipe's flags come first and the command
line's after them, so a flag given there wins. ``--out`` defaults to
``QUALITY_torch_<RUN>_refgrad.json``, whose ``config`` gets
``"gradient": "reference_packed"``. The run ends by printing its band
items (``band_items``), which

    python tests/_refgrad_train.py report QUALITY.json [--window A:B]

prints for any quality JSON, the JAX records' and the plain port runs'
included: phase a's last six curve rows, phase b's rows of steps A-B
(default the last 1,000 steps), phase ft's scores.
"""

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _reference_packed_grad import reference_packed_grad  # noqa: E402
from gens_torch.eval import quality_train as qt  # noqa: E402

PALLAS_BF16 = ["--agg-packed", "pallas", "--bf16", "--agg-remat",
               "save_gathers"]
RECIPES = {
    "a_table": ["--phase", "a", "--seed", "0", "--steps-a", "1500",
                "--inflight-every", "250"],
    "b_stage1": ["--phase", "b", "--steps-b", "8000", "--dims", "64",
                 "--hw", "128", "--samples", "32", "--rays", "512",
                 "--inflight-every", "500"] + PALLAS_BF16,
    "ft_r05": ["--phase", "ft", "--gen-ckpt",
               "artifacts/quality_gen_r05_sharpen.pkl", "--steps-ft", "2000",
               "--dims", "128", "--hw", "480", "--w", "640", "--samples",
               "64", "--rays", "512", "--mesh-res", "192"] + PALLAS_BF16,
}


def mean_of(rows, key):
    return float(np.mean([r[key] for r in rows]))


def band_items(results, window=None):
    """The numbers the bands of PERF.md §6 are stated on."""
    out = {}
    if results.get("overfit_curve"):
        c = results["overfit_curve"]
        by_step = {r["step"]: r for r in c}
        out["a"] = {
            "last6_psnr": mean_of(c[-6:], "psnr"),
            "last6_eikonal": mean_of(c[-6:], "eikonal_loss"),
            "last6_steps": [r["step"] for r in c[-6:]],
            "psnr_step0": by_step[0]["psnr"],
            "psnr_step25": by_step.get(25, {}).get("psnr"),
            **{k: results.get("overfit_" + k) for k in (
                "psnr", "acc_mean", "acc_p50", "acc_p90", "ms_per_step",
                "steps_done", "train_peak_mem_gb")}}
    if results.get("gen_curve"):
        c = results["gen_curve"]
        last = c[-1]["step"] + 1
        lo, hi = window or (last - 1000, last)
        rows = [r for r in c if lo <= r["step"] <= hi]
        eik = [r["eikonal_loss"] for r in c]
        span = 200 // (c[1]["step"] - c[0]["step"]) + 1
        out["b"] = {
            "window": [lo, hi], "rows": len(rows),
            **{f"mean_{k}": mean_of(rows, k) for k in (
                "psnr", "eikonal_loss", "loss", "color_loss",
                "sparse_loss", "mfc_loss")},
            "psnr_step0": c[0]["psnr"],
            "psnr_step25": next((r["psnr"] for r in c if r["step"] == 25),
                                None),
            "least_200_step_mean_eikonal": float(min(np.convolve(
                eik, np.ones(span) / span, "valid"))) if len(eik) >= span
            else None,
            **{k: results.get(k) for k in (
                "gen_ms_per_step", "gen_steps_done",
                "gen_k1_launches_per_step", "gen_k3_launches_eval",
                "gen_train_peak_mem_gb", "heldout_acc_mean", "heldout_psnr",
                "heldout_union_acc_mean", "heldout_union_psnr",
                "trained_acc_mean", "trained_psnr")}}
    if results.get("ft_curve"):
        c = results["ft_curve"]
        out["ft"] = {
            "psnr_first": c[0]["psnr"], "psnr_last": c[-1]["psnr"],
            "eikonal_last": c[-1]["eikonal_loss"],
            **{k: results.get(k) for k in (
                "ft_init_acc_mean", "ft_init_acc_p50", "ft_init_acc_p90",
                "ft_init_overall", "ft_acc_mean", "ft_acc_p50", "ft_acc_p90",
                "ft_comp_mean", "ft_overall", "ft_ms_per_step",
                "ft_steps_done", "ft_k3_launches", "ft_train_peak_mem_gb")}}
    return out


def report(argv):
    p = argparse.ArgumentParser("_refgrad_train.py report")
    p.add_argument("json")
    p.add_argument("--window", default=None, help="phase b's steps A:B")
    args = p.parse_args(argv)
    with open(args.json) as f:
        results = json.load(f)
    window = (tuple(int(x) for x in args.window.split(":"))
              if args.window else None)
    print(json.dumps({"config": results.get("config"),
                      **band_items(results, window)}, indent=1))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "report":
        return report(argv[1:])
    if not argv or argv[0] not in RECIPES:
        sys.exit(f"usage: {sys.argv[0]} {{{','.join(RECIPES)}}} [flags]"
                 f" | report QUALITY.json [--window A:B]")
    run, rest = argv[0], argv[1:]
    args = qt.parse_args(RECIPES[run] + rest)
    if "--out" not in rest:
        args.out = f"QUALITY_torch_{run}_refgrad.json"
        rest = rest + ["--out", args.out]
    with reference_packed_grad():
        qt.main(RECIPES[run] + rest)
    with open(args.out) as f:
        results = json.load(f)
    results["config"]["gradient"] = "reference_packed"
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print("band_items", json.dumps(band_items(results)), flush=True)
    return results


if __name__ == "__main__":
    main()
