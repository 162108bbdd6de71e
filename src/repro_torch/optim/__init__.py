"""AdamW with fp32 master weights and error-feedback gradient
compression (twin of ``repro.optim``)."""
