"""mythos_tpu_torch: the PyTorch/CUDA port of mythos_tpu.

The JAX package ``mythos_tpu`` beside this one is the reference; every
module here mirrors the module of the same path there. This package
imports ``torch`` and ``numpy`` only (never ``jax``, ``chex`` or
``sympy``). Its hand-written CUDA kernels (``ops/csrc``) are built at
first use on a machine with ``nvcc``; on CPU tensors every kernel wrapper
runs the kernel's plain PyTorch twin instead.

Ported so far: the oxDNA2, oxRNA2 and oxDNA1 banded-stencil Langevin
paths (``entry.build_sim(mode="stencil")``, kernels K1/K2), the block
tier (``build_sim(mode="block")``, kernel K3), the small-system path
(``mode="pairs"``/``"dense"``), DiffTRe fitting (``optimization``:
``DiffTReObjective``, ``SimpleOptimizer``; the re-evaluation on kernels
K4/K5; ``examples/difftre_propeller_fit.py``), direct differentiation
through every simulator, and MARTINI bilayer NPT MD
(``simulators.martini.MartiniSimulator``, kernel K6). Every entry point
runs on the card unless the caller passes ``device="cpu"``.
"""
