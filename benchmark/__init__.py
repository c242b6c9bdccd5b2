"""The benchmark of tpat_tpu_torch (see README.md)."""
