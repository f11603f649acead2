"""oxDNA1 pieces that oxDNA2 shares (port of mythos_tpu.energy.dna1).

Only the geometry and the terms the dna2 model uses are ported so far; the
dna1 model itself (its coaxial stacking and default energy) is not.
"""
