"""One module per objective, found by the configuration's ``objective``.
Each gives ``Objective(label, group, params, device)`` with
``init_score()`` (the boost-from-average start, f64) and
``gradients(score)`` returning f64 (grad, hess, grad_abs, hess_abs):
``grad_abs`` bounds what each row's f32 gradient carries of rounding
(the sum of the absolute terms that make it up), ``hess_abs`` the same
for the hessian."""
import importlib


def objective_for(name: str):
    return importlib.import_module(__name__ + "." + name).Objective
