"""Which stage of the held-out quality evaluation varies between two runs on
the same params in one process, on a card (no jax needed).

    python3 tests/_cudnn_determinism_probe.py default|cudnn|det

``default`` runs as the port does; ``cudnn`` sets
``torch.backends.cudnn.deterministic``; ``det`` adds
``torch.use_deterministic_algorithms(True)`` and
``CUBLAS_WORKSPACE_CONFIG=:4096:8``. Three runs of the stages of
``gens_torch.eval.quality.eval_scene`` on the artifact's params (the
feature net, the volume build alone and inside ``build_scene``, a 4,096-ray
render, the 192³ SDF grid): the max |difference| of each stage's tensors
between the first run and each later one; then two runs of
``gens_torch.eval.quality`` on the held-out sphere and the scores that
differ. Prints one ``DETPROBE`` JSON line.
"""

import json
import os
import sys

MODE = sys.argv[1] if len(sys.argv) > 1 else "default"
if MODE == "det":
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def flat(x):
    if torch.is_tensor(x):
        return [x]
    return [y for v in x for y in flat(v)]


def main() -> None:
    if MODE == "det":
        torch.use_deterministic_algorithms(True)
    if MODE in ("det", "cudnn"):
        torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gens_torch.convert import load_params
    from gens_torch.data.synthetic import make_scene
    from gens_torch.eval import quality
    from gens_torch.mesh.extract import eval_sdf_grid
    from gens_torch.models.gens import GenSModel

    dev = torch.device("cuda")
    pkl = os.path.join(REPO, "artifacts", "quality_gen_r05_sharpen.pkl")
    model = GenSModel(quality.build_config(128, 64).model)
    load_params(model, pkl)
    model = model.to(dev).eval()
    raw = make_scene(n_views=quality.EVAL_VIEWS, hw=(480, 640), n_rays=16,
                     seed=123, spread=quality.SPREAD,
                     **quality.scene_params(quality.SCENES["heldout"]))
    t = {k: torch.from_numpy(np.ascontiguousarray(raw[k])).to(dev)
         for k in ("imgs", "intrs", "c2ws", "near", "far")}
    gen = torch.Generator().manual_seed(0)
    rd = torch.nn.functional.normalize(
        torch.randn(4096, 3, generator=gen) * 0.1
        + torch.tensor([0.0, 0.0, 1.0]), dim=-1).to(dev)
    rd = (rd @ t["c2ws"][0, :3, :3].T).contiguous()
    ro = t["c2ws"][0, :3, 3].expand(4096, 3).contiguous()

    def run():
        with torch.no_grad():
            feats = model.extract_features(t["imgs"])
            vols, _ = model.build_volumes(feats, t["intrs"], t["c2ws"])
            scene = model.build_scene(t["imgs"], t["intrs"], t["c2ws"])
            color = model.renderer.render(ro, rd, t["near"], t["far"], scene,
                                          cos_anneal_ratio=1.0)["color_fine"]
            grid = eval_sdf_grid(model.renderer.sdf_fn_for_extraction(
                scene.volumes), [-1] * 3, [1] * 3, 192, dev, block=64)
            torch.cuda.synchronize()
        return {"features": flat(feats), "volumes": flat(vols),
                "scene_volumes": flat(scene.volumes), "color": [color],
                "grid": [torch.as_tensor(grid)]}

    out = {"mode": MODE, "card": torch.cuda.get_device_name(0), "runs": []}
    ref = run()
    for _ in range(2):
        cur = run()
        out["runs"].append({k: [float((a.float() - b.float()).abs().max())
                                for a, b in zip(ref[k], cur[k])]
                            for k in ref})
    res = []
    for _ in range(2):
        r = quality.main(["--ckpt", pkl, "--scenes", "heldout"])
        res.append({k: v for k, v in r.items() if k.startswith("heldout_")
                    and not k.endswith(("_s", "rays_per_s"))})
    out["quality_differ"] = {k: (res[0][k], res[1][k]) for k in res[0]
                             if res[0][k] != res[1][k]}
    print("DETPROBE " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
