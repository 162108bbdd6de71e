"""repro_torch.formats — public facade over the precision-format
registry (twin of ``repro.formats``)::

    from repro_torch import formats
    fset = formats.FormatSet.parse("d:s:int8_pt")

It is a view of :mod:`repro_torch.core.formats`, not a second registry.
"""
from repro_torch.core.formats import (DEFAULT_FORMATS, SPEC_ALIASES,
                                      FormatSet, IntFormat, PrecisionFormat,
                                      QuantizedTile, SplitFormat, format_set,
                                      get_format, register_format,
                                      registered_formats,
                                      registry_signatures)

__all__ = [
    "DEFAULT_FORMATS",
    "FormatSet",
    "IntFormat",
    "PrecisionFormat",
    "QuantizedTile",
    "SPEC_ALIASES",
    "SplitFormat",
    "format_set",
    "get_format",
    "register_format",
    "registered_formats",
    "registry_signatures",
]
