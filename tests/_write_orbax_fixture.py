"""Write artifacts/quality_gen_r05_sharpen.orbax/, the trained artifact's
params in gens_tpu's default checkpoint format (an orbax OCDBT directory),
with gens_tpu's own ``save_checkpoint`` (``use_orbax`` left at its
default) from the pickle's params, fp16 as stored, and its epoch and step.

    JAX_PLATFORMS=cpu python tests/_write_orbax_fixture.py [--out DIR]

chip_smoke.py reads the directory through the port (no orbax, tensorstore
or zstandard on the card's machine) and holds it to the pickle. Needs jax
and orbax; runs on the CPU in a few seconds.
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PICKLE = os.path.join(REPO, "artifacts", "quality_gen_r05_sharpen.pkl")
OUT = os.path.join(REPO, "artifacts", "quality_gen_r05_sharpen.orbax")


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from gens_tpu.train.checkpoint import load_checkpoint, save_checkpoint

    payload = load_checkpoint(PICKLE)
    save_checkpoint(args.out, {"epoch": int(payload["epoch"]),
                               "step": int(payload["step"]),
                               "params": payload["params"]})
    print("wrote", args.out)


if __name__ == "__main__":
    main()
