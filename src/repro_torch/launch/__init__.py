"""Entry points of the port: `train` and `serve` (counterparts of `repro.launch`)."""
