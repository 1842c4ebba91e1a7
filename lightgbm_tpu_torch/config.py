"""Configuration for lightgbm_tpu_torch.

Port of ``lightgbm_tpu/config.py``: one typed dataclass carries the full
user-facing parameter surface, and :func:`Config.from_params` resolves
aliases, coerces types and validates ranges like the reference's
``Config::Set``. The field catalog and the alias table are the
reference's, so model files and parameter dicts interchange.

What differs for the PyTorch/CUDA port:

- ``device_type`` defaults to ``"cuda"`` (``"gpu"`` is an alias); the
  CPU runs only when the caller asks for ``device_type="cpu"``, and
  ``"cuda"`` without a visible GPU raises (:func:`resolve_device`).
- ``hist_backend`` names the histogram implementation: ``auto``,
  ``cuda`` or ``pallas`` (the hand-written kernel replacing the Pallas
  one) — the kernel runs on CUDA tensors and its plain version on CPU
  tensors. Any other value raises.
- :meth:`Config.check_slice` raises for every setting this port does not
  run yet, naming the ROADMAP item that brings it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

from .utils import log

# ---------------------------------------------------------------------------
# Alias table (reference: src/io/config_auto.cpp:10-120, ~117 aliases)
# ---------------------------------------------------------------------------
_ALIASES: Dict[str, str] = {}


def _alias(canonical: str, *names: str) -> None:
    for n in names:
        _ALIASES[n] = canonical


_alias("config", "config_file")
_alias("task", "task_type")
_alias("objective", "objective_type", "app", "application", "loss")
_alias("boosting", "boosting_type", "boost")
_alias("data_sample_strategy", "sample_strategy")
_alias("data", "train", "train_data", "train_data_file", "data_filename")
_alias("valid", "test", "valid_data", "valid_data_file", "test_data",
       "test_data_file", "valid_filenames")
_alias("num_iterations", "num_iteration", "n_iter", "num_tree", "num_trees",
       "num_round", "num_rounds", "nrounds", "num_boost_round", "n_estimators",
       "max_iter")
_alias("learning_rate", "shrinkage_rate", "eta")
_alias("num_leaves", "num_leaf", "max_leaves", "max_leaf", "max_leaf_nodes")
_alias("tree_learner", "tree", "tree_type", "tree_learner_type")
_alias("num_threads", "num_thread", "nthread", "nthreads", "n_jobs")
_alias("device_type", "device")
_alias("seed", "random_seed", "random_state")
_alias("histogram_pool_size", "hist_pool_size")
_alias("min_data_in_leaf", "min_data_per_leaf", "min_data",
       "min_child_samples", "min_samples_leaf")
_alias("min_sum_hessian_in_leaf", "min_sum_hessian_per_leaf",
       "min_sum_hessian", "min_hessian", "min_child_weight")
_alias("bagging_fraction", "sub_row", "subsample", "bagging")
_alias("pos_bagging_fraction", "pos_sub_row", "pos_subsample", "pos_bagging")
_alias("neg_bagging_fraction", "neg_sub_row", "neg_subsample", "neg_bagging")
_alias("bagging_freq", "subsample_freq")
_alias("bagging_seed", "bagging_fraction_seed")
_alias("feature_fraction", "sub_feature", "colsample_bytree")
_alias("feature_fraction_bynode", "sub_feature_bynode", "colsample_bynode")
_alias("extra_trees", "extra_tree")
_alias("early_stopping_round", "early_stopping_rounds", "early_stopping",
       "n_iter_no_change")
_alias("max_delta_step", "max_tree_output", "max_leaf_output")
_alias("lambda_l1", "reg_alpha", "l1_regularization")
_alias("lambda_l2", "reg_lambda", "lambda", "l2_regularization")
_alias("min_gain_to_split", "min_split_gain")
_alias("drop_rate", "rate_drop")
_alias("top_k", "topk")
_alias("monotone_constraints", "mc", "monotone_constraint", "monotonic_cst")
_alias("monotone_constraints_method", "monotone_constraining_method",
       "mc_method")
_alias("monotone_penalty", "monotone_splits_penalty", "ms_penalty",
       "mc_penalty")
_alias("feature_contri", "feature_contrib", "fc", "fp", "feature_penalty")
_alias("forcedsplits_filename", "fs", "forced_splits_filename",
       "forced_splits_file", "forced_splits")
_alias("verbosity", "verbose")
_alias("input_model", "model_input", "model_in")
_alias("output_model", "model_output", "model_out")
_alias("snapshot_freq", "save_period")
_alias("linear_tree", "linear_trees")
_alias("max_bin", "max_bins")
_alias("bin_construct_sample_cnt", "subsample_for_bin")
_alias("data_random_seed", "data_seed")
_alias("is_enable_sparse", "is_sparse", "enable_sparse", "sparse")
_alias("enable_bundle", "is_enable_bundle", "bundle")
_alias("pre_partition", "is_pre_partition")
_alias("two_round", "two_round_loading", "use_two_round_loading")
_alias("header", "has_header")
_alias("label_column", "label")
_alias("weight_column", "weight")
_alias("group_column", "group", "group_id", "query_column", "query",
       "query_id")
_alias("ignore_column", "ignore_feature", "blacklist")
_alias("categorical_feature", "cat_feature", "categorical_column",
       "cat_column", "categorical_features")
_alias("save_binary", "is_save_binary", "is_save_binary_file")
_alias("predict_raw_score", "is_predict_raw_score", "predict_rawscore",
       "raw_score")
_alias("predict_leaf_index", "is_predict_leaf_index", "leaf_index")
_alias("predict_contrib", "contrib")
_alias("output_result", "predict_result", "prediction_result", "predict_name",
       "pred_name", "name_pred")
_alias("is_unbalance", "unbalance", "unbalanced_sets")
_alias("metric", "metrics", "metric_types")
_alias("metric_freq", "output_freq")
_alias("is_provide_training_metric", "training_metric", "is_training_metric",
       "train_metric")
_alias("eval_at", "ndcg_eval_at", "ndcg_at", "map_eval_at", "map_at")
_alias("num_class", "num_classes")
_alias("use_quantized_grad", "use_quantized_gradients", "quantized_grad")
_alias("quant_grad_bits", "num_grad_quant_bins_bits", "grad_quant_bits")
_alias("num_machines", "num_machine")
_alias("local_listen_port", "local_port", "port")
_alias("machine_list_filename", "machine_list_file", "machine_list", "mlist")
_alias("machines", "workers", "nodes")


_OBJECTIVE_ALIASES = {
    # reference: ObjectiveFunction::CreateObjectiveFunction name handling +
    # config.h:151 objective docs (aliases listed per objective).
    "regression": "regression", "regression_l2": "regression",
    "l2": "regression", "mean_squared_error": "regression",
    "mse": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1",
    "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "quantile": "quantile", "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
    "lambdarank": "lambdarank",
    "rank_xendcg": "rank_xendcg", "xendcg": "rank_xendcg",
    "xe_ndcg": "rank_xendcg", "xe_ndcg_mart": "rank_xendcg",
    "xendcg_mart": "rank_xendcg",
    "none": "custom", "null": "custom", "custom": "custom", "na": "custom",
}

_METRIC_ALIASES = {
    # reference: src/metric/metric.cpp:19 factory names.
    "l1": "l1", "mean_absolute_error": "l1", "mae": "l1",
    "regression_l1": "l1",
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2", "regression": "l2",
    "regression_l2": "l2",
    "rmse": "rmse", "root_mean_squared_error": "rmse", "l2_root": "rmse",
    "quantile": "quantile", "huber": "huber", "fair": "fair",
    "poisson": "poisson", "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "gamma_deviance": "gamma_deviance",
    "tweedie": "tweedie",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "binary_error": "binary_error",
    "auc": "auc", "average_precision": "average_precision",
    "auc_mu": "auc_mu",
    "ndcg": "ndcg", "lambdarank": "ndcg", "rank_xendcg": "ndcg",
    "xendcg": "ndcg", "xe_ndcg": "ndcg", "xe_ndcg_mart": "ndcg",
    "xendcg_mart": "ndcg",
    "map": "map", "mean_average_precision": "map",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "softmax": "multi_logloss", "multiclassova": "multi_logloss",
    "multiclass_ova": "multi_logloss", "ova": "multi_logloss",
    "ovr": "multi_logloss",
    "multi_error": "multi_error",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
    "kullback_leibler": "kldiv", "kldiv": "kldiv",
    "none": "custom", "null": "custom", "custom": "custom", "na": "custom",
}


@dataclass
class Config:
    """Full parameter surface (reference: include/LightGBM/config.h field list,
    cited per-field in SURVEY.md §2.8). Defaults match the reference."""

    # --- Core (config.h:105-251) ---
    config: str = ""
    task: str = "train"
    objective: str = "regression"
    boosting: str = "gbdt"
    data_sample_strategy: str = "bagging"
    data: str = ""
    valid: List[str] = field(default_factory=list)
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    tree_learner: str = "serial"
    num_threads: int = 0
    device_type: str = "cuda"
    seed: int = 0
    deterministic: bool = False

    # --- Learning control (config.h:267-615) ---
    force_col_wise: bool = False
    force_row_wise: bool = False
    histogram_pool_size: float = -1.0
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    bagging_fraction: float = 1.0
    pos_bagging_fraction: float = 1.0
    neg_bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    feature_fraction: float = 1.0
    feature_fraction_bynode: float = 1.0
    feature_fraction_seed: int = 2
    extra_trees: bool = False
    extra_seed: int = 6
    early_stopping_round: int = 0
    first_metric_only: bool = False
    max_delta_step: float = 0.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    linear_lambda: float = 0.0
    min_gain_to_split: float = 0.0
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4
    top_rate: float = 0.2
    other_rate: float = 0.1
    min_data_per_group: int = 100
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    top_k: int = 20
    monotone_constraints: List[int] = field(default_factory=list)
    monotone_constraints_method: str = "basic"
    monotone_penalty: float = 0.0
    feature_contri: List[float] = field(default_factory=list)
    forcedsplits_filename: str = ""
    refit_decay_rate: float = 0.9
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    cegb_penalty_feature_lazy: List[float] = field(default_factory=list)
    cegb_penalty_feature_coupled: List[float] = field(default_factory=list)
    path_smooth: float = 0.0
    interaction_constraints: Union[str, List[List[int]]] = ""
    verbosity: int = 1
    input_model: str = ""
    output_model: str = "LightGBM_model.txt"
    saved_feature_importance_type: int = 0
    snapshot_freq: int = -1
    linear_tree: bool = False

    # --- Dataset (config.h:622-756) ---
    max_bin: int = 255
    max_bin_by_feature: List[int] = field(default_factory=list)
    min_data_in_bin: int = 3
    bin_construct_sample_cnt: int = 200000
    data_random_seed: int = 1
    is_enable_sparse: bool = True
    enable_bundle: bool = True
    use_missing: bool = True
    zero_as_missing: bool = False
    feature_pre_filter: bool = True
    pre_partition: bool = False
    two_round: bool = False
    # progress-log interval for text loading (config.h:679); accepted
    # for conf compatibility — the numpy/native-parser loaders finish
    # in one pass without incremental progress logging
    file_load_progress_interval_bytes: int = 10 * 1024 * 1024 * 1024
    header: bool = False
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    categorical_feature: Union[str, List[int]] = ""
    forcedbins_filename: str = ""
    save_binary: bool = False
    precise_float_parser: bool = False
    parser_config_file: str = ""

    # --- Predict / convert (config.h:768-850) ---
    start_iteration_predict: int = 0
    num_iteration_predict: int = -1
    predict_raw_score: bool = False
    predict_leaf_index: bool = False
    predict_contrib: bool = False
    predict_disable_shape_check: bool = False
    pred_early_stop: bool = False
    pred_early_stop_freq: int = 10
    pred_early_stop_margin: float = 10.0
    # the reference's switch between its host walk and a device forest
    # walk that reproduces it bit for bit; this port always walks on
    # the host (the device walk is ROADMAP item 9), with equal results
    predict_on_device: bool = True
    output_result: str = "LightGBM_predict_result.txt"
    convert_model_language: str = ""
    convert_model: str = "gbdt_prediction.cpp"

    # --- Objective (config.h:862-936) ---
    objective_seed: int = 5
    num_class: int = 1
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0
    sigmoid: float = 1.0
    boost_from_average: bool = True
    reg_sqrt: bool = False
    alpha: float = 0.9
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    tweedie_variance_power: float = 1.5
    lambdarank_truncation_level: int = 30
    lambdarank_norm: bool = True
    label_gain: List[float] = field(default_factory=list)

    # --- Metric (config.h:975-1012) ---
    metric: List[str] = field(default_factory=list)
    metric_freq: int = 1
    is_provide_training_metric: bool = False
    eval_at: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 5])
    multi_error_top_k: int = 1
    auc_mu_weights: List[float] = field(default_factory=list)

    # --- Network (config.h:1024-1045) ---
    num_machines: int = 1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_filename: str = ""
    machines: str = ""

    # --- Device (config.h:1056-1070) ---
    # gpu_device_id picks the CUDA card; the fields below the reference
    # build added for the TPU are accepted by name so parameter dicts
    # interchange. check_slice raises for those that need a later slice
    # (f64 histograms, batched iterations). tpu_fused_tree selects the
    # learner's loop, as in the reference: the whole-tree loop (true,
    # the default) or the per-split loop (false), which give the same
    # trees. Only the out-of-core frontier width, tpu_frontier_splits,
    # has no effect here.
    gpu_platform_id: int = -1
    gpu_device_id: int = -1
    gpu_use_dp: bool = False
    num_gpu: int = 1
    tpu_use_f64_hist: bool = False
    use_quantized_grad: bool = False
    quant_grad_bits: int = 8         # 8 or 16
    tpu_batch_iterations: int = 0
    tpu_eval_iterations: int = 0
    tpu_fused_tree: bool = True
    tpu_frontier_splits: int = 8
    hist_backend: str = "auto"       # auto | cuda | pallas (the kernel)
    mesh_shape: str = ""

    # raw params as given by the user (for model "parameters:" section)
    raw_params: Dict[str, Any] = field(default_factory=dict, repr=False)

    # ------------------------------------------------------------------
    @classmethod
    def from_params(cls, params: Optional[Dict[str, Any]]) -> "Config":
        """Resolve aliases, coerce types, validate — reference Config::Set
        (src/io/config.cpp) + alias transform (application.cpp:50-86)."""
        params = dict(params or {})
        # apply verbosity first so it governs parse-time warnings
        for vkey in ("verbosity", "verbose"):
            if vkey in params:
                try:
                    log.set_verbosity(int(params[vkey]))
                except (TypeError, ValueError):
                    pass
                break
        cfg = cls()
        cfg.raw_params = dict(params)
        resolved: Dict[str, Any] = {}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        # Canonical-name-wins alias transform (reference:
        # ParameterAlias::KeyAliasTransform, include/LightGBM/config.h:1159 —
        # a key spelled with the canonical name always overrides aliases;
        # among multiple aliases the first-sorted one wins).
        resolved_from: Dict[str, str] = {}
        for key in sorted(params):
            value = params[key]
            name = _ALIASES.get(key, key)
            if name not in fields:
                log.warning("Unknown parameter: %s", key)
                continue
            if name in resolved:
                is_canonical = key == name
                prev_canonical = resolved_from[name] == name
                if prev_canonical or not is_canonical:
                    log.warning("%s is set=%s, %s=%s will be ignored. "
                                "Current value: %s=%s", name, resolved[name],
                                key, value, name, resolved[name])
                    continue
            resolved[name] = value
            resolved_from[name] = key
        for name, value in resolved.items():
            setattr(cfg, name, _coerce(fields[name], value))
        cfg._post_process()
        return cfg

    # ------------------------------------------------------------------
    def _post_process(self) -> None:
        obj = str(self.objective).strip().lower()
        if obj not in _OBJECTIVE_ALIASES:
            log.fatal("Unknown objective: %s" % self.objective)
        self.objective = _OBJECTIVE_ALIASES[obj]
        self.metric = self._resolve_metrics(self.metric)
        self.boosting = {
            "gbdt": "gbdt", "gbrt": "gbdt", "dart": "dart", "rf": "rf",
            "random_forest": "rf", "goss": "goss",
        }.get(str(self.boosting).lower(), None) or log.fatal(
            "Unknown boosting type: %s" % self.boosting)
        # 'goss' as boosting is the deprecated spelling of
        # data_sample_strategy=goss (reference: config.cpp GetBoostingType)
        if self.boosting == "goss":
            self.boosting = "gbdt"
            self.data_sample_strategy = "goss"
        if self.tree_learner not in ("serial", "feature", "data", "voting"):
            log.fatal("Unknown tree learner: %s" % self.tree_learner)
        self.device_type = str(self.device_type).strip().lower()
        if self.device_type == "gpu":
            self.device_type = "cuda"
        if self.device_type not in ("cpu", "cuda"):
            log.fatal("Unknown device type: %s (lightgbm_tpu_torch runs "
                      "on 'cuda' or 'cpu')" % self.device_type)
        self.hist_backend = str(self.hist_backend).strip().lower()
        if self.hist_backend not in ("auto", "cuda", "pallas"):
            log.fatal("hist_backend=%s is not available: "
                      "lightgbm_tpu_torch has one histogram, the CUDA "
                      "kernel on CUDA tensors and its plain version on "
                      "CPU tensors (auto | cuda | pallas)"
                      % self.hist_backend)
        # validations (reference: Config::Set CHECK calls)
        if self.num_leaves < 2:
            log.fatal("num_leaves must be >= 2")
        if not (0.0 < self.bagging_fraction <= 1.0):
            log.fatal("bagging_fraction should be in (0.0, 1.0]")
        if not (0.0 < self.feature_fraction <= 1.0):
            log.fatal("feature_fraction should be in (0.0, 1.0]")
        if self.max_bin < 2:
            log.fatal("max_bin should be >= 2")
        if self.objective in ("multiclass", "multiclassova") and self.num_class < 2:
            log.fatal("num_class should be >= 2 for multiclass objectives")
        if self.objective not in ("multiclass", "multiclassova", "custom") \
                and self.num_class != 1:
            log.fatal("num_class must be 1 for non-multiclass objectives")
        if self.top_rate + self.other_rate > 1.0:
            log.fatal("top_rate + other_rate cannot be larger than 1.0")
        if self.quant_grad_bits not in (8, 16):
            log.fatal("quant_grad_bits must be 8 or 16")
        self._warn_unimplemented()
        log.set_verbosity(self.verbosity)

    def _warn_unimplemented(self) -> None:
        """CPU-layout hints are accepted and have no effect here."""
        if self.force_col_wise or self.force_row_wise:
            log.warning("force_col_wise/force_row_wise are CPU histogram "
                        "layout hints; this build always uses one "
                        "row-major device layout")

    def check_slice(self) -> None:
        """Raise for every setting that needs a part of the port that is
        not here yet (never ignore one silently). Each message names the
        ROADMAP queue-1 item that will bring it."""
        unsupported = log.unsupported
        if self.objective == "custom":
            unsupported("a custom objective", "item 18")
        if self.boosting != "gbdt":
            unsupported("boosting=%s" % self.boosting, "item 16")
        if self.data_sample_strategy == "goss":
            unsupported("data_sample_strategy=goss", "item 14")
        if self.feature_fraction < 1.0:
            unsupported("feature_fraction < 1", "item 14")
        if self.extra_trees:
            unsupported("extra_trees", "item 14")
        if self.feature_fraction_bynode < 1.0:
            unsupported("feature_fraction_bynode < 1", "item 15")
        if self.categorical_feature:
            unsupported("categorical features", "item 11")
        if any(int(v) != 0 for v in self.monotone_constraints):
            unsupported("monotone_constraints", "item 15")
        if self.interaction_constraints:
            unsupported("interaction_constraints", "item 15")
        if (self.cegb_penalty_split > 0.0
                or self.cegb_penalty_feature_lazy
                or self.cegb_penalty_feature_coupled):
            unsupported("cost-effective gradient boosting (cegb_*)",
                        "item 15")
        if self.linear_tree:
            unsupported("linear_tree", "item 15")
        if self.forcedsplits_filename:
            unsupported("forced splits", "item 15")
        if self.max_bin > 255 or any(int(v) > 255
                                     for v in self.max_bin_by_feature):
            unsupported("max_bin > 255", "item 26")
        if self.tpu_use_f64_hist or self.gpu_use_dp:
            unsupported("f64 histograms (tpu_use_f64_hist / gpu_use_dp)",
                        "item 26")
        if self.tpu_batch_iterations > 1 or self.tpu_eval_iterations > 1:
            unsupported("tpu_batch_iterations / tpu_eval_iterations",
                        "item 17")
        if self.tree_learner != "serial":
            unsupported("tree_learner=%s" % self.tree_learner, "item 22")
        if self.num_machines > 1 or self.num_gpu > 1:
            unsupported("num_machines / num_gpu > 1", "item 22")

    @staticmethod
    def _resolve_metrics(metrics: Any) -> List[str]:
        if isinstance(metrics, str):
            metrics = [m for m in metrics.split(",") if m.strip()]
        out: List[str] = []
        for m in metrics:
            m = str(m).strip().lower()
            if m == "":
                continue
            if m not in _METRIC_ALIASES:
                log.fatal("Unknown metric: %s" % m)
            canonical = _METRIC_ALIASES[m]
            if canonical not in out:
                out.append(canonical)
        return out

    # number of models ("trees per iteration") — reference gbdt.cpp:88
    @property
    def num_tree_per_iteration(self) -> int:
        return self.num_class if self.objective in ("multiclass", "multiclassova") else 1

    def to_param_string(self) -> str:
        """key: value lines for the model file 'parameters:' block
        (reference: Config::ToString used by gbdt_model_text.cpp:385)."""
        lines = []
        for f in dataclasses.fields(self):
            if f.name == "raw_params":
                continue
            v = getattr(self, f.name)
            if isinstance(v, bool):
                v = int(v)
            elif isinstance(v, list):
                v = ",".join(str(x) for x in v)
            lines.append(f"[{f.name}: {v}]")
        return "\n".join(lines)


def resolve_device(config: "Config"):
    """The torch device of ``config.device_type``: ``cuda`` (the
    default; ``gpu_device_id`` picks the card) or ``cpu``. A run that
    asks for ``cuda`` where no GPU is visible raises — it never goes on
    quietly on the CPU."""
    import torch
    if config.device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        log.fatal("device_type=cuda but no CUDA device is visible; pass "
                  "device_type='cpu' to run on the CPU")
    return torch.device("cuda", max(int(config.gpu_device_id), 0))


def _coerce(fld: dataclasses.Field, value: Any) -> Any:
    """Coerce a user-supplied value to the field's declared type."""
    tp = fld.type if isinstance(fld.type, str) else getattr(fld.type, "__name__", "")
    if tp.startswith("bool"):
        if isinstance(value, str):
            return value.strip().lower() in ("true", "1", "yes", "+")
        return bool(value)
    if tp.startswith("int"):
        return int(value)
    if tp.startswith("float"):
        return float(value)
    if tp.startswith("List[int]"):
        return _parse_list(value, int)
    if tp.startswith("List[float]"):
        return _parse_list(value, float)
    if tp.startswith("List[str]") or tp.startswith("List[List"):
        if isinstance(value, str):
            return [s for s in value.split(",") if s]
        return list(value)
    if tp.startswith("str"):
        return str(value)
    return value


def _parse_list(value: Any, typ) -> list:
    if isinstance(value, str):
        return [typ(x) for x in value.split(",") if x.strip()]
    if isinstance(value, (list, tuple)):
        return [typ(x) for x in value]
    return [typ(value)]
