"""What every run shares: the checkout's paths and cache directories, the
cell's parts found by name from BENCHMARK.json, the check for JAX in the
process, and the result line."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "gens_tpu")


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's nvcc and g++ builds go to build/gens_torch by its own
    rule)."""
    base = os.path.join(ROOT, "build", "benchmark_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(base, sub)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic mix,
    limits and the metric readers it reports, all found by name."""

    def __init__(self, name: str, root: str = ROOT):
        spec = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; known: "
                             f"{sorted(cells)}")
        self.spec, self.name, self.work = spec, name, cells[name]
        cfg = {c["name"]: c for c in spec["configs"]}[self.work["config"]]
        self.config = load_json(os.path.join(root, cfg["file"]))
        self.traffic = load_json(os.path.join(
            BENCH_DIR, "traffic", self.work["traffic"] + ".json"))
        self.limits = load_json(os.path.join(BENCH_DIR, "limits",
                                             name + ".json"))
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m.get("workloads", [name])]
        self.chips = self.work["chips"]
        # the plain reference module the configuration names
        self.reference = importlib.import_module(
            "reference." + self.config.get("reference", "gens_plain"))

    def loop(self):
        return load_module(os.path.join(BENCH_DIR, "loops",
                                        self.traffic["loop"] + ".py"))

    def reader(self, metric: str):
        return load_module(os.path.join(BENCH_DIR, "metrics",
                                        metric + ".py"))


def load_module(path: str):
    name = "bench_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def device_info(torch, count: int) -> Dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}


def checks_block(values: Dict[str, float], limits: Dict[str, float]
                 ) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit; a number passes when it is
    finite and at most its limit."""
    return {k: {"value": values[k], "limit": limits[k]} for k in limits}


def all_pass(block: Dict[str, Dict[str, float]]) -> bool:
    import math
    return all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
               for v in block.values())


def print_checks(block: Dict) -> None:
    for k, v in block.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr, flush=True)


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict,
                device: Dict, checks: Dict,
                breakdown: Optional[Dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
