"""User interfaces of the fitting loop (port of mythos_tpu.ui)."""
