"""mythos_tpu_torch: the PyTorch/CUDA port of mythos_tpu.

The JAX package ``mythos_tpu`` beside this one is the reference; every
module here mirrors the module of the same path there. This package
imports ``torch`` and ``numpy`` only (never ``jax``, ``chex`` or
``sympy``). Its hand-written CUDA kernels (``ops/csrc``) are built at
first use on a machine with ``nvcc``; on CPU tensors every kernel wrapper
runs the kernel's plain PyTorch twin instead.

Ported so far: the oxDNA2 banded-stencil Langevin main path
(``entry.build_sim(mode="stencil", model="dna2")``).
"""
