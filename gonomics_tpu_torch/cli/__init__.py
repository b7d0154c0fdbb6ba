"""Command-line tools of the port (mirrors ``gonomics_tpu/cli/``)."""

# --backend values of the JAX tools that name the plain versions on the
# CPU; every other value runs on --device
PLAIN_BACKENDS = ("numpy", "interpret")
