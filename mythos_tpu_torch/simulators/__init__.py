"""Simulators (port of mythos_tpu.simulators): the CUDA stencil and block
simulators (simulators.cuda) and the MARTINI point-particle simulator
(simulators.martini)."""
