"""repro_torch.split — Ozaki-style split accumulation (twin of
``repro.split``).

Compound :class:`~repro_torch.core.formats.SplitFormat` entries
(``split2_fp16``, ``split3_e5m2``) decompose fp32-grade operands into
precision-recovery slices, compute ``slices²`` partial products at the
low-precision pass dtype, and accumulate fp32 in a deterministic order.
:mod:`repro_torch.split.recovery` holds the slice algebra; the kernel is
:mod:`repro_torch.kernels.split_gemm` (``csrc/split_gemm.cu``), served by
the ``split`` dispatch path.
"""
from repro_torch.core.formats import (SPLIT2_FP16, SPLIT3_E5M2,  # noqa: F401
                                      SplitFormat, split_slices)
from repro_torch.split.recovery import (has_split,  # noqa: F401
                                        recombine, slice_pair_order,
                                        split_dot_general,
                                        split_format_specs, split_gemm_ref,
                                        split_variant)

__all__ = [
    "SPLIT2_FP16", "SPLIT3_E5M2", "SplitFormat", "split_slices",
    "slice_pair_order", "recombine", "split_dot_general",
    "split_format_specs", "has_split", "split_variant", "split_gemm_ref",
]
