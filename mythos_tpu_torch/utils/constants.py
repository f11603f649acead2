"""Alphabets of the nucleic-acid models.

Counterpart of mythos_tpu/utils/constants.py (the entries the port uses).
"""

DNA_ALPHA = "ACGT"
RNA_ALPHA = "ACGU"

#: map char -> index; U aliases T (index 3)
NUCLEOTIDES_IDX: dict[str, int] = {nt: i for i, nt in enumerate(DNA_ALPHA)}
NUCLEOTIDES_IDX.update({nt: i for i, nt in enumerate(RNA_ALPHA)})
N_NT = len(DNA_ALPHA)

#: base-pair types of a probabilistic sequence's paired rows, in column order
BP_TYPES = ["AT", "TA", "GC", "CG"]
N_BP_TYPES = len(BP_TYPES)
N_NT_PER_BP = 2
#: (4, 2) nucleotide indices of each base-pair type
BP_IDXS = [[DNA_ALPHA.index(a), DNA_ALPHA.index(b)] for a, b in BP_TYPES]
#: (nucleotide, nucleotide) -> base-pair type
BP_IDX_MAP = {(DNA_ALPHA.index(a), DNA_ALPHA.index(b)): k for k, (a, b) in enumerate(BP_TYPES)}
