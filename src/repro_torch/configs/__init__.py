"""Assigned architecture configs (``--arch <id>``).

Importing this package registers every config.  Each module carries the
exact assignment-table numbers plus a ``tiny-`` reduced variant for CPU
smoke tests (same family, small dims).
"""
from repro_torch.configs import (  # noqa: F401
    gemma3_1b,
    gemma3_27b,
    granite_20b,
    granite_moe_3b_a800m,
    hymba_1_5b,
    internvl2_2b,
    minicpm_2b,
    mixtral_8x7b,
    musicgen_large,
    suffix_array,
    xlstm_125m,
)
