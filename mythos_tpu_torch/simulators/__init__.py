"""Simulators (port of mythos_tpu.simulators): the CUDA stencil simulator."""
