"""Record formats the read aligner reads and writes (mirrors
``gonomics_tpu/io/``)."""
