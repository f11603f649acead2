"""oxDNA sequence-dependent weights files.

Counterpart of mythos_tpu/io/sequence_dependence.py: the 4 x 4 stacking
and hydrogen-bonding weight tables and the stacking kT coefficient of a
file of ``KEY = VALUE`` lines (``STCK_X_Y``, ``HYDR_X_Y``,
``STCK_FACT_EPS``), for ``ss_stack_weights``/``ss_hb_weights`` of the
stacking and hydrogen-bonding configurations.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from mythos_tpu_torch.utils.constants import DNA_ALPHA
from mythos_tpu_torch.utils.constants import NUCLEOTIDES_IDX as N_IDX


def read_ss_weights(file) -> dict[str, np.ndarray]:
    """Read an oxDNA sequence-dependence file: whitespace is ignored and a
    float may carry an ``f`` suffix. Returns ``ss_stack_weights`` and
    ``ss_hb_weights`` (float64 (4, 4)), and ``eps_stack_kt_coeff`` where the
    file gives ``STCK_FACT_EPS`` (oxRNA's tables do not)."""
    param_map: dict[str, float] = {}
    with Path(file).open("r") as f:
        for line in f:
            if kv := line.strip().replace(" ", ""):
                key, val = kv.split("=")
                param_map[key] = float(val.replace("f", ""))
    stack = np.zeros((4, 4), dtype=np.float64)
    for i, a in enumerate(DNA_ALPHA):
        for j, b in enumerate(DNA_ALPHA):
            stack[i, j] = param_map[f"STCK_{a}_{b}"]
    # the bonding pairs' mirrors carry the same value: one of each is read
    hb = np.zeros((4, 4), dtype=np.float64)
    hb[N_IDX["A"], N_IDX["T"]] = hb[N_IDX["T"], N_IDX["A"]] = param_map.get("HYDR_A_T", param_map.get("HYDR_T_A"))
    hb[N_IDX["G"], N_IDX["C"]] = hb[N_IDX["C"], N_IDX["G"]] = param_map.get("HYDR_G_C", param_map.get("HYDR_C_G"))
    hb_g_t = param_map.get("HYDR_G_T", param_map.get("HYDR_T_G"))  # oxRNA's G-U wobble (T encodes U)
    if hb_g_t is not None:
        hb[N_IDX["G"], N_IDX["T"]] = hb[N_IDX["T"], N_IDX["G"]] = hb_g_t
    out = {"ss_stack_weights": stack, "ss_hb_weights": hb}
    if "STCK_FACT_EPS" in param_map:
        out["eps_stack_kt_coeff"] = np.float64(param_map["STCK_FACT_EPS"])
    return out
