"""Unseen scenes reconstructed back to back (the traffic mix's
``"loop": "mesh"``): per scene the calls the runner's validation makes for
its mesh, ``GenSModel.build_scene``, ``Renderer.sdf_fn_for_extraction``,
``mesh.extract.eval_sdf_grid`` at the configuration's resolution and
``mesh.extract.grid_to_mesh``, without writing the mesh.

Set-up loads the weights into the program's model, makes the scenes from
the seed, and warms the shapes on a scene of its own: one scene build, one
grid block, and an isosurface. The window takes the pool's scenes in turn,
round and round, and starts a scene only while the time so far plus the
last scene's fits in it, so it holds whole scenes only. It keeps the
outputs of two scenes: the last, and one drawn from the seed among all of
the window's (reservoir sampling); every other scene's outputs go before
the next scene starts, so the memory held does not grow with the count.

The check (after the window, with the program's model freed) rebuilds
those scenes' volumes with the plain reference and compares them, the SDF
at a seeded sample of grid points, and the program's mesh with the
reference isosurface of the program's grid. Every scene counts as failed
whose mesh is empty or has a vertex that is not finite.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np
import torch

from harness import compare, scenes
from harness.weights import cell_weights
from reference.isosurface import isosurface_stats, mesh_stats

KEYS = ("imgs", "intrs", "c2ws")


class State:
    pass


def dims(cell) -> Dict:
    cfg = cell.config["config"]
    ds = cfg[cell.traffic["dataset"]]
    return {"n_views": ds["num_src_view"] + 1, "hw": tuple(ds["img_hw"]),
            "resolution": cfg["mesh_resolution"]}


def make_scene(cell, seed: int, index: int) -> Dict:
    d = dims(cell)
    return scenes.make_scene(cell.traffic["scene"], d["n_views"], d["hw"],
                             seed, index)


def setup(cell, seed: int, device, weights=None) -> State:
    from gens_torch.config import config_from_dict
    from gens_torch.mesh.extract import grid_to_mesh
    from gens_torch.models.gens import GenSModel

    st = State()
    st.cell, st.seed, st.device = cell, seed, device
    st.cfg = config_from_dict(cell.config["config"])
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if weights is None:
        weights = cell_weights(cell, device)
    st.weights = {k: v.detach().to("cpu", copy=True)
                  for k, v in weights.items()}
    model = GenSModel(st.cfg.model).to(device).eval()
    model.load_state_dict(weights, strict=True)
    del weights
    st.model = model
    n = cell.traffic["pool"]
    # scene 0 warms the shapes; the window takes 1, 2, ...
    st.pool = [make_scene(cell, seed, i) for i in range(n + 1)]
    pin = device.type == "cuda"
    st.host = [{k: _host(s[k], pin) for k in KEYS} for s in st.pool]
    with torch.no_grad():
        x = {k: v.to(device) for k, v in st.host[0].items()}
        scene = model.build_scene(x["imgs"], x["intrs"], x["c2ws"])
        sdf_fn = model.renderer.sdf_fn_for_extraction(scene.volumes)
        block = cell.traffic["block"]
        pts = torch.rand((block ** 3, 3), device=device) * 2 - 1
        sdf_fn(pts)
        small = np.random.default_rng(0).standard_normal(
            (8, 8, 8)).astype(np.float32)
        grid_to_mesh(small, [-1, -1, -1], [1, 1, 1])
        del scene, sdf_fn, pts, x
    if device.type == "cuda":
        torch.cuda.synchronize()
    st.count = 0
    return st


def _host(a, pin: bool) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if pin else t


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def run_scene(st: State) -> Dict:
    """One reconstruction; its spans on the host clock and its outputs."""
    from gens_torch.mesh.extract import eval_sdf_grid, grid_to_mesh

    idx = st.count % (len(st.host) - 1) + 1
    st.count += 1
    dev, res = st.device, dims(st.cell)["resolution"]
    bmin, bmax = [-1.0] * 3, [1.0] * 3
    rec = torch.profiler.record_function
    _sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        x = {k: v.to(dev, non_blocking=True) for k, v in st.host[idx].items()}
        with rec("bench/build_scene"):
            scene = st.model.build_scene(x["imgs"], x["intrs"], x["c2ws"])
            _sync(dev)
        t1 = time.perf_counter()
        with rec("bench/mesh_grid"):
            sdf_fn = st.model.renderer.sdf_fn_for_extraction(scene.volumes)
            grid = eval_sdf_grid(sdf_fn, bmin, bmax, res, dev,
                                 block=st.cell.traffic["block"])
        t2 = time.perf_counter()
        with rec("bench/isosurface"):
            verts, tris = grid_to_mesh(grid, bmin, bmax)
        t3 = time.perf_counter()
    return {"index": idx, "volumes": scene.volumes, "grid": grid,
            "verts": verts, "tris": tris,
            "build_scene_s": t1 - t0, "mesh_grid_s": t2 - t1,
            "isosurface_s": t3 - t2, "scene_s": t3 - t0}


SPANS = ("build_scene_s", "mesh_grid_s", "isosurface_s", "scene_s")


def _sound(r: Dict) -> bool:
    return len(r["tris"]) > 0 and bool(np.isfinite(r["verts"]).all())


def window(st: State, seconds: float, trace: bool) -> Dict:
    pick = scenes.rng_for(st.seed, scenes.PICK)
    spans: List[Dict] = []
    failed = 0
    kept = last = None
    t0 = time.perf_counter()
    while True:
        if last is not kept:
            last = None
        last = run_scene(st)
        spans.append({k: last[k] for k in SPANS})
        failed += not _sound(last)
        if pick.integers(len(spans)) == 0:
            kept = last
        if time.perf_counter() - t0 + last["scene_s"] > seconds:
            break
    win = {"scenes": spans, "seconds": time.perf_counter() - t0,
           "failed": failed,
           "compared": [kept] + ([last] if last is not kept else [])}
    print(f"window: {len(spans)} scenes, compared "
          f"{[r['index'] for r in win['compared']]}", file=sys.stderr)
    return win


def trace(st: State, win: Dict) -> None:
    """Profiled scenes after the window: the device's activity alone, then
    with the host's operators."""
    from harness.trace import DeviceTrace

    tr = DeviceTrace(1)
    with tr.record_device(torch):
        run_scene(st)
    with tr.record_host(torch):
        run_scene(st)
    win["trace"] = tr


def end_to_end(st: State, win: Dict) -> Dict[str, float]:
    return {"mesh_scene_s": win["seconds"] / len(win["scenes"])}


def context(st: State, win: Dict) -> Dict:
    d = dims(st.cell)
    model = st.cell.config["config"]["model"]
    return {"scenes": win["scenes"], "trace": win.get("trace"),
            "scene_s": win["seconds"] / len(win["scenes"]),
            "model": model, "dims": d, "device": st.device,
            "block": st.cell.traffic["block"]}


def reference_scene(cell, weights, pool_scene: Dict, device, prec_kind=None,
                    tf32=False) -> Dict:
    """The plain reference's volumes of one scene and its SDF function."""
    mcfg = cell.config["config"]["model"]
    R = cell.reference
    prec = R.Precision(mcfg, prec_kind, tf32)
    with torch.device(device):
        ref = R.GenSPlain(mcfg)
    ref.load_state_dict({k: v.to(device) for k, v in weights.items()},
                        strict=True)
    ref.eval()
    x = {k: torch.from_numpy(np.ascontiguousarray(pool_scene[k])).to(device)
         for k in KEYS}
    with torch.no_grad(), R.precision(prec):
        scene = ref.build_scene(x["imgs"], x["intrs"], x["c2ws"], prec)
    return {"model": ref, "prec": prec, "volumes": scene["volumes"],
            "precision": R.precision}


def sampled_sdf(ref: Dict, pts: np.ndarray, device, chunk: int = 1 << 18
                ) -> np.ndarray:
    out = []
    with torch.no_grad(), ref["precision"](ref["prec"]):
        for i in range(0, len(pts), chunk):
            p = torch.from_numpy(pts[i:i + chunk]).to(device)
            out.append(ref["model"].sdf.sdf(p, ref["volumes"], ref["prec"])
                       .cpu().numpy())
    return np.concatenate(out)


def sample_indices(cell, seed: int, index: int) -> np.ndarray:
    res = dims(cell)["resolution"]
    g = scenes.rng_for(seed, scenes.GRID, index)
    return g.integers(0, res ** 3, size=min(cell.traffic["grid_sample"],
                                            res ** 3))


def scene_numbers(cell, seed: int, index: int, volumes, grid, verts, tris,
                  ref: Dict, device) -> Dict:
    """The compared quantities of one scene against the reference."""
    res = dims(cell)["resolution"]
    idx = sample_indices(cell, seed, index)
    pts = compare.grid_points(idx, res, [-1.0] * 3, [1.0] * 3)
    ref_sdf = sampled_sdf(ref, pts, device)
    prog_sdf = -grid.reshape(-1)[idx]
    g = torch.from_numpy(np.ascontiguousarray(grid)).to(device)
    ref_mesh = isosurface_stats(g, [-1.0] * 3, [1.0] * 3)
    del g
    return {"index": index,
            "volume": compare.volume_gap(volumes, ref["volumes"]),
            "grid": float(np.max(np.abs(prog_sdf - ref_sdf))),
            "prog_mesh": mesh_stats(verts, tris), "ref_mesh": ref_mesh}


def check(st: State, win: Dict) -> Dict[str, float]:
    dev = st.device
    done = win.pop("compared")
    del st.model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rows = []
    for r in done:
        ref = reference_scene(st.cell, st.weights, st.pool[r["index"]], dev)
        rows.append(scene_numbers(st.cell, st.seed, r["index"], r["volumes"],
                                  r["grid"], r["verts"], r["tris"], ref, dev))
        del ref
        r["volumes"] = None
    return compare.mesh_numbers(rows)
