"""Alphabets of the nucleic-acid models.

Counterpart of mythos_tpu/utils/constants.py (the entries the port uses).
"""

DNA_ALPHA = "ACGT"
RNA_ALPHA = "ACGU"

#: map char -> index; U aliases T (index 3)
NUCLEOTIDES_IDX: dict[str, int] = {nt: i for i, nt in enumerate(DNA_ALPHA)}
NUCLEOTIDES_IDX.update({nt: i for i, nt in enumerate(RNA_ALPHA)})
