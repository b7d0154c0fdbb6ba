"""Alignment scoring (mirrors ``gonomics_tpu/align/``)."""
