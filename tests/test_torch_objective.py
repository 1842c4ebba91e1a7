"""The port's objectives against the JAX package's: binary and l2
gradients and hessians within a few f32 ulps (the two compute ``exp``
with different libraries), and equal ``boost_from_score``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu.config as ref_config
import lightgbm_tpu.io.dataset as ref_dataset
import lightgbm_tpu.objective as ref_objective
import lightgbm_tpu_torch.config as port_config
import lightgbm_tpu_torch.io.dataset as port_dataset
import lightgbm_tpu_torch.objective as port_objective
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

CASES = [
    ("binary", {}, False),
    ("binary", {"is_unbalance": True}, False),
    ("binary", {"scale_pos_weight": 3.0, "sigmoid": 0.7}, True),
    ("regression", {}, False),
    ("regression", {}, True),
    ("regression", {"reg_sqrt": True}, False),
]


def _objectives(name, extra, weighted, seed=0):
    rng = np.random.RandomState(seed)
    n = 5000
    label = ((rng.rand(n) > 0.3).astype(np.float64) if name == "binary"
             else rng.randn(n) * 3)
    weights = rng.rand(n) + 0.5 if weighted else None
    params = dict(extra, objective=name, verbose=-1)
    rcfg = ref_config.Config.from_params(params)
    pcfg = port_config.Config.from_params(dict(params, device_type="cpu"))
    rmeta = ref_dataset.Metadata(n)
    pmeta = port_dataset.Metadata(n)
    for md in (rmeta, pmeta):
        md.set_label(label)
        md.set_weights(weights)
    robj = ref_objective.create_objective(rcfg.objective, rcfg)
    pobj = port_objective.create_objective(pcfg.objective, pcfg)
    robj.init(rmeta, n)
    pobj.init(pmeta, n)
    score = (rng.randn(n) * 2).astype(np.float32)
    return robj, pobj, score


@pytest.mark.parametrize("name,extra,weighted", CASES)
def test_gradients_within_a_few_ulps(name, extra, weighted):
    robj, pobj, score = _objectives(name, extra, weighted)
    rg, rh = robj.get_gradients(jnp.asarray(score))
    pg, ph = pobj.get_gradients(torch.from_numpy(score))
    assert pg.dtype == ph.dtype == torch.float32
    np.testing.assert_array_max_ulp(pg.numpy(), np.asarray(rg), maxulp=4)
    # binary hess = |r| * (sigmoid - |r|) * w cancels where |r| nears
    # sigmoid, so its ulps are counted at the scale of its operands,
    # |grad| * sigmoid, as well as at its own
    scale = np.maximum(np.abs(np.asarray(rh)),
                       np.abs(np.asarray(rg)) * getattr(pobj, "sigmoid", 0))
    eps = np.finfo(np.float32).eps
    assert np.all(np.abs(ph.numpy() - np.asarray(rh)) <= 4 * eps * scale)


@pytest.mark.parametrize("name,extra,weighted", CASES)
def test_boost_from_score_equal(name, extra, weighted):
    robj, pobj, _ = _objectives(name, extra, weighted, seed=1)
    assert pobj.boost_from_score(0) == robj.boost_from_score(0)
    assert pobj.to_string() == robj.to_string()
    x = np.linspace(-5, 5, 11)
    np.testing.assert_array_equal(pobj.convert_output(x),
                                  robj.convert_output(x))


@pytest.mark.parametrize("name", ["multiclass", "huber", "lambdarank",
                                  "cross_entropy"])
def test_other_objectives_raise_with_their_roadmap_item(name):
    params = {"objective": name, "device_type": "cpu", "verbose": -1}
    if name == "multiclass":
        params["num_class"] = 3
    cfg = port_config.Config.from_params(params)
    with pytest.raises(LightGBMError, match="item 10"):
        port_objective.create_objective(cfg.objective, cfg)
