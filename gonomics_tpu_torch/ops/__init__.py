"""Device ops of the port: each hand-written kernel beside its plain
PyTorch version (mirrors ``gonomics_tpu/ops/``)."""
