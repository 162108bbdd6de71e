"""Core: format registry, tile maps, layouts, reference GEMM, oracle."""
from repro_torch.core.formats import (DEFAULT_FORMATS, FormatSet, IntFormat,
                                      PrecisionFormat, SplitFormat,
                                      format_set, get_format,
                                      register_format)
from repro_torch.core.layout import (CompactMPMatrix, KSplitWeight, MPMatrix,
                                     NSplitWeight, ksplit_matmul,
                                     nsplit_matmul)
from repro_torch.core.mp_gemm import mp_gemm_ref, mp_gemm_tilewise_ref
from repro_torch.core.precision import Policy, make_map, map_storage_bytes

__all__ = [
    "CompactMPMatrix", "DEFAULT_FORMATS", "FormatSet", "IntFormat",
    "KSplitWeight", "MPMatrix", "NSplitWeight", "Policy", "PrecisionFormat",
    "SplitFormat", "format_set", "get_format",
    "ksplit_matmul", "make_map", "map_storage_bytes", "mp_gemm_ref",
    "mp_gemm_tilewise_ref", "nsplit_matmul", "register_format",
]
