"""Phase a's training from one saved init in either package, on the CPU:
a diagnostic of the collapse some phase-a runs fall into (PERF.md, PR 11).

    # on any machine with the port: the port's seed-S init of phase a
    python tests/_phase_a_from_init.py --write-init S --init INIT.ckpt
    # then, with both packages (JAX on the CPU):
    python tests/_phase_a_from_init.py --init INIT.ckpt --mode M [--steps N]

``--mode``: ``portgen`` the port's step with its own draws (a CPU
generator seeded with the step, as ``gens_torch.eval.quality_train``
draws); ``port`` the port's step with the JAX step's draws passed in;
``plain`` / ``packed`` the JAX step (``make_train_step``) with
``sdf_network.packed_trilerp`` false / true. Every mode runs (a-table)
from the same params, batches and schedule, and prints the PSNR and the
Eikonal loss every 25 steps. A seed's init depends on the torch version,
so write it where the run to explain took place.

    # on the card: phase a's recipe changed one field at a time
    python tests/_phase_a_from_init.py --variants OUT.json [--seed 1] \
        [--steps 200] [recipe mfc0 warmup2 varlr_half]

``--variants`` runs ``gens_torch.eval.quality_train --phase a`` (a-table,
``--steps-a 1500``, stopped at ``--steps``, no evaluation) from the seed's
init once per variant, in one process, with one field of the recipe
changed: ``recipe`` none, ``mfc0`` ``train.loss.mfc_weight`` 0,
``warmup2`` ``train.warmup`` doubled to ``steps_a // 10``, ``varlr_half``
``train.lr_variance_mult`` 0.5. It writes every variant's curve (rows
every 25 steps) and segment to OUT.json.
"""

import argparse
import importlib.util
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gens_torch.eval import quality_train as qt  # noqa: E402
from gens_torch.eval.quality import scene_params  # noqa: E402


def port_steps(payload, cfg, batches, n, jax_draws):
    from gens_torch.convert import load_params
    from gens_torch.models.gens import GenSModel
    from gens_torch.train.step import TrainStep

    model = GenSModel(cfg.model)
    load_params(model, payload)
    step = TrainStep(model, cfg, 1)
    for s in range(n):
        if jax_draws:
            import jax

            pk, sk = jax.random.split(jax.random.PRNGKey(s))
            kw = {"perturb_noise": torch.from_numpy(np.array(
                      jax.random.uniform(pk, (512, 1)) - 0.5)),
                  "sparse_pts": torch.from_numpy(np.array(
                      jax.random.uniform(sk, (512, 3), minval=-1.0,
                                         maxval=1.0)))}
        else:
            kw = {"generator": torch.Generator().manual_seed(s)}
        m = step(batches[s % len(batches)],
                 min(1.0, s / cfg.train.anneal_end), False, **kw)
        yield s, float(m["psnr"]), float(m["eikonal_loss"])


def jax_steps(payload, batches, n, packed):
    import jax
    import jax.numpy as jnp

    from gens_tpu.models.gens import GenSModel
    from gens_tpu.train.step import TrainState, make_optimizer, make_train_step

    spec = importlib.util.spec_from_file_location(
        "quality_synthetic", os.path.join(REPO, "scripts",
                                          "quality_synthetic.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    cfg = script.build_config(1500)
    cfg.train.anneal_end = 1500 // 4
    cfg.model.sdf_network.packed_trilerp = packed
    model = GenSModel(cfg.model)
    _, step_fn = make_train_step(model, cfg, steps_per_epoch=1)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                          payload["params"])
    state = TrainState(params, make_optimizer(cfg.train, 1).init(params),
                       jnp.asarray(0, jnp.int32))
    items = [{k: jnp.asarray(v.numpy()) for k, v in b.items()}
             for b in batches]
    for s in range(n):
        state, m = step_fn(state, items[s % len(items)], jax.random.PRNGKey(s),
                           min(1.0, s / cfg.train.anneal_end),
                           use_match_features=False)
        yield s, float(m["psnr"]), float(m["eikonal_loss"])


VARIANTS = {
    "recipe": lambda cfg: None,
    "mfc0": lambda cfg: setattr(cfg.train.loss, "mfc_weight", 0.0),
    "warmup2": lambda cfg: setattr(cfg.train, "warmup",
                                   max(cfg.train.epochs // 10, 1)),
    "varlr_half": lambda cfg: setattr(cfg.train, "lr_variance_mult", 0.5),
}


def run_variants(out, names, seed, steps, device):
    """Phase a through its entry point, one recipe field changed a run."""
    import json
    import tempfile

    build_cfg = qt.build_cfg
    rows = {}
    try:
        for name in names:
            def patched(args, n_steps, change=VARIANTS[name]):
                cfg = build_cfg(args, n_steps)
                change(cfg)
                return cfg

            qt.build_cfg = patched
            with tempfile.TemporaryDirectory() as tmp:
                res = qt.main([
                    "--phase", "a", "--seed", str(seed), "--steps-a", "1500",
                    "--stop-at", str(steps), "--skip-eval",
                    "--device", device,
                    "--out", os.path.join(tmp, f"{name}.json"),
                    "--runs-dir", tmp])
            rows[name] = {"curve": res["overfit_curve"],
                          "segments": res["overfit_segments"]}
            with open(out, "w") as f:
                json.dump({"seed": seed, "steps": steps, "variants": rows},
                          f, indent=1)
    finally:
        qt.build_cfg = build_cfg


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--variants", default=None, metavar="OUT")
    p.add_argument("names", nargs="*", default=list(VARIANTS))
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--init", default=None)
    p.add_argument("--write-init", type=int, default=None, metavar="SEED")
    p.add_argument("--mode", choices=["portgen", "port", "plain", "packed"])
    p.add_argument("--steps", type=int, default=160)
    args = p.parse_args()
    if args.variants:
        run_variants(args.variants, args.names or list(VARIANTS), args.seed,
                     args.steps, args.device)
        return
    cfg = qt.build_cfg(qt.parse_args([]), 1500)
    cfg.train.anneal_end = 1500 // 4
    if args.write_init is not None:
        from gens_torch.models.gens import GenSModel
        from gens_torch.train.checkpoint import save_params_checkpoint

        torch.manual_seed(args.write_init)
        save_params_checkpoint(args.init, 0, GenSModel(cfg.model))
        return
    import jax

    jax.config.update("jax_platforms", "cpu")
    from gens_torch.convert import load_checkpoint

    payload = load_checkpoint(args.init)
    batches, _ = qt.pregen_batches(scene_params(0), 64, False, 0, (128, 128),
                                   512, 5, 0.5, torch.device("cpu"))
    if args.mode in ("portgen", "port"):
        rows = port_steps(payload, cfg, batches, args.steps,
                          args.mode == "port")
    else:
        rows = jax_steps(payload, batches, args.steps, args.mode == "packed")
    t0 = time.time()
    for s, psnr, eik in rows:
        if s % 25 == 0 or s == args.steps - 1:
            print(f"{args.mode} step {s} psnr {psnr:.3f} eik {eik:.4f} "
                  f"[{time.time() - t0:.0f}s]", flush=True)


if __name__ == "__main__":
    main()
