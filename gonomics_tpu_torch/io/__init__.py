"""Record formats the aligners read and write (mirrors
``gonomics_tpu/io/``)."""
