"""The plain reference: the model text's own parser, the walk of raw rows
through its trees, the objectives' gradients and the held-out metrics in
f64, and the comparisons that decide a run's ``correct``.

It imports torch and numpy only: nothing of ``lightgbm_tpu_torch`` and
nothing of the JAX package. It takes from the program only the outputs it
judges (the model text, the training scores, the predictions and the
program's own held-out metric values)."""
