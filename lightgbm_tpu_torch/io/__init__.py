"""io subpackage of lightgbm_tpu_torch."""
