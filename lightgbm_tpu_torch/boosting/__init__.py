"""boosting subpackage of lightgbm_tpu_torch."""
