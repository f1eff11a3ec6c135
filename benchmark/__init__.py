"""The benchmark of bioem_tpu_torch on one H100 (see README.md)."""
