"""repro_torch.quant — quantized-inference calibration over the format
registry (twin of ``repro.quant``)::

    from repro_torch.quant import ActStats, quantize_params
    stats = ActStats()
    stats.observe(batch_of_activations)          # online, any number
    qparams = quantize_params(params, stats)     # loud blocks stay float
    eng = Engine(cfg, params, variants={"int8": qparams})
"""
from repro_torch.quant.calibrate import (ActStats, activation_absmax,
                                         block_scores, calibrate_ksplit,
                                         calibrated_cls, map_report,
                                         quantize_params)

__all__ = [
    "ActStats",
    "activation_absmax",
    "block_scores",
    "calibrate_ksplit",
    "calibrated_cls",
    "map_report",
    "quantize_params",
]
