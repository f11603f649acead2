"""oxDNA1 pieces that oxDNA2 and oxRNA2 share (port of mythos_tpu.energy.dna1).

Only the geometry and the terms those models use are ported so far; the
dna1 model itself (its default energy) is not.
"""
