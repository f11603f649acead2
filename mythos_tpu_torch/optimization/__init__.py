"""DiffTRe fitting (port of mythos_tpu.optimization)."""
