"""Run one cell of the benchmark of gens_torch and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. ``--trace 0`` measures the cell's end-to-end metrics; ``--trace 1``
its per-layer metrics (each step or scene timed by phase, then, after the
peak memory is read, profiled slices: the device alone, then with the
host's operators). Every run then checks the window's outputs against the plain
reference (``benchmark/reference``) and prints each compared number beside
its limit, on standard error and as the result line's last key.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from harness import core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    core.set_cache_dirs()
    cell = core.Cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    return run(cell, args.seed, args.seconds, bool(args.trace), device,
               T_START)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, weights=None) -> int:
    """One run; ``weights`` (a state dict) replaces the configuration's
    (the CPU tests' tiny cells)."""
    import torch

    loop = cell.loop()
    cuda = device.type == "cuda"
    st = loop.setup(cell, seed, device, weights)
    setup_s = time.perf_counter() - t_start
    mem = 0
    if cuda:
        torch.cuda.synchronize()
        mem = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    win = loop.window(st, seconds, trace)
    device_info = {"platform": "cpu", "kind": "cpu", "count": 1}
    if cuda:
        win["peak_bytes"] = torch.cuda.max_memory_allocated()
        device_info = core.device_info(torch, cell.chips)
        device_info["memory_peak_bytes"] = int(max(mem, win["peak_bytes"]))
        if trace:
            loop.trace(st, win)
    attempted = win.get("steps", len(win.get("scenes", [])))
    breakdown = None
    if trace:
        ctx = loop.context(st, win)
        ctx["peak_bytes"] = win.get("peak_bytes")
        metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        tr = win.get("trace")
        if tr is not None:
            device_info["busy_s"] = tr.busy_s
            device_info["window_s"] = tr.window_s
            breakdown = tr.breakdown()
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for k, v in loop.end_to_end(st, win).items():
            unit = {m["name"]: m["unit"] for m in cell.end_to_end}[k]
            metrics[k] = {"value": v, "unit": unit}
    values = loop.check(st, win)
    checks = core.checks_block(values, cell.limits)
    core.print_checks(checks)
    bad = core.forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures gens_torch "
              "without JAX", file=sys.stderr)
        return 3
    correct = core.all_pass(checks) and win["failed"] == 0
    print(core.result_line(correct, attempted, win["failed"], metrics,
                           device_info, checks, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
