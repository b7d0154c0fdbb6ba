"""Command-line tools of the port (mirrors ``gonomics_tpu/cli/``)."""
