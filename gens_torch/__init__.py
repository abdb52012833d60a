"""gens_torch — GenS generalizable neural surface reconstruction in PyTorch
and CUDA, for one NVIDIA H100.

A port of the JAX package ``gens_tpu`` (kept beside it as the reference).
It imports torch, numpy, scipy and yaml, never jax or ``gens_tpu``. Public
functions keep the JAX layouts: (X, Y, Z, C) volumes, (V, H, W, C) feature
maps, (in, out) dense kernels at the parameter bridge (``convert.py``).

Entry points run on the card unless the caller asks for the CPU; a kernel
wrapper takes its plain PyTorch version only for tensors on the CPU.

Entry points: ``gens_torch.main`` (``--mode val|train|finetune``),
``gens_torch.eval.quality`` (the synthetic quality protocol on a
checkpoint), ``gens_torch.eval.chamfer`` (DTU Chamfer) and
``gens_torch.probes.gather`` (gather and scatter rates on the card). The
kernels are in ``csrc/`` with their wrappers and plain versions in
``ops/``: the fused SDF MLP (``fused_mlp.py``), the splat (``splat.py``),
the windowed bilerp forward (``window_fwd.py``) and the gather probes
(``gather.py``).
"""

__version__ = "0.1.0"
