"""Model → standalone C++ code generation (``convert_model``).

Copy of ``lightgbm_tpu/models/codegen.py``, over the port's ``Tree``.
Equivalent of the reference's if-else codegen (``GBDT::SaveModelToIfElse``
/ ``Tree::ToIfElse``, src/boosting/gbdt_model_text.cpp:286,
src/io/tree.cpp:548-648), re-designed to emit a *self-contained*
translation unit: the reference's output plugs into its own C++ codebase,
whereas ours compiles standalone with only the C++ standard library and
exposes a C ABI (``Predict``/``PredictRaw``/``PredictLeafIndex``) so any
engine — or our own test-suite via ctypes — can load it.

Unlike the reference's ``NumericalDecisionIfElse`` (src/io/tree.cpp:520),
which drops the threshold comparison on Zero/NaN-missing nodes, the
emitted decision here reproduces ``Tree::NumericalDecision``
(include/LightGBM/tree.h:335) exactly, so compiled predictions match the
in-framework predictor bit-for-bit on finite inputs.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..io.binning import MissingType, kZeroThreshold
from .tree import Tree, kCategoricalMask, kDefaultLeftMask


def _f(x: float) -> str:
    """C++ double literal with round-trip precision."""
    if np.isnan(x):
        return "std::numeric_limits<double>::quiet_NaN()"
    if np.isinf(x):
        return ("std::numeric_limits<double>::infinity()" if x > 0
                else "-std::numeric_limits<double>::infinity()")
    return repr(float(x))


def _numerical_cond(tree: Tree, node: int) -> str:
    """True ⇔ go left; mirrors Tree._decide / reference
    NumericalDecision (include/LightGBM/tree.h:335)."""
    dt = int(tree.decision_type[node])
    missing = (dt >> 2) & 3
    default_left = "true" if dt & kDefaultLeftMask else "false"
    thr = _f(float(tree.threshold[node]))
    if missing == MissingType.NAN:
        return ("(std::isnan(fval) ? %s : (fval <= %s))"
                % (default_left, thr))
    # NaN is remapped to 0 first (missing None/Zero)
    v = "(std::isnan(fval) ? 0.0 : fval)"
    if missing == MissingType.ZERO:
        return ("(std::fabs(%s) <= kZeroThreshold ? %s : (%s <= %s))"
                % (v, default_left, v, thr))
    return "(%s <= %s)" % (v, thr)


def _categorical_cond(tree: Tree, node: int, tree_id: int) -> str:
    """True ⇔ category bit set ⇒ go left (reference:
    CategoricalDecisionIfElse, src/io/tree.cpp:548; CategoricalDecision,
    tree.h:395)."""
    cat_idx = int(tree.threshold_in_bin[node])
    lo = tree.cat_boundaries[cat_idx]
    n_words = tree.cat_boundaries[cat_idx + 1] - lo
    return ("CatDecision(fval, kCatWords%d + %d, %d)"
            % (tree_id, lo, n_words))


def _emit_node(tree: Tree, index: int, tree_id: int, leaf_index: bool,
               out: List[str], depth: int) -> None:
    """Iterative emission with an explicit work stack — chain-shaped
    trees can be num_leaves-1 deep, past Python's recursion limit."""
    stack = [("node", index, depth)]
    while stack:
        kind, arg, d = stack.pop()
        pad = "  " * min(d, 40)
        if kind == "else":
            out.append("%s} else {" % pad)
            continue
        if kind == "close":
            out.append("%s}" % pad)
            continue
        if arg < 0:
            leaf = ~arg
            if leaf_index:
                out.append("%sreturn %d;" % (pad, leaf))
            elif tree.is_linear:
                terms = ["%s" % _f(float(tree.leaf_const[leaf]))]
                for f, c in zip(tree.leaf_features[leaf],
                                tree.leaf_coeff[leaf]):
                    terms.append("%s * NanToZero(arr[%d])"
                                 % (_f(float(c)), f))
                out.append("%sreturn %s;" % (pad, " + ".join(terms)))
            else:
                out.append("%sreturn %s;"
                           % (pad, _f(float(tree.leaf_value[leaf]))))
            continue
        dt = int(tree.decision_type[arg])
        out.append("%sfval = arr[%d];" % (pad, int(tree.split_feature[arg])))
        if dt & kCategoricalMask:
            cond = _categorical_cond(tree, arg, tree_id)
        else:
            cond = _numerical_cond(tree, arg)
        out.append("%sif (%s) {" % (pad, cond))
        stack.append(("close", 0, d))
        stack.append(("node", int(tree.right_child[arg]), d + 1))
        stack.append(("else", 0, d))
        stack.append(("node", int(tree.left_child[arg]), d + 1))


def _tree_fn(tree: Tree, tree_id: int, leaf_index: bool) -> str:
    name = "PredictTree%d%s" % (tree_id, "Leaf" if leaf_index else "")
    lines = ["static double %s(const double* arr) {" % name]
    if tree.num_leaves <= 1:
        lines.append("  (void)arr; return %s;"
                     % ("0" if leaf_index
                        else _f(float(tree.leaf_value[0]))))
    else:
        lines.append("  double fval = 0.0;")
        _emit_node(tree, 0, tree_id, leaf_index, lines, 1)
        lines.append("  return 0.0;  // unreachable")
    lines.append("}")
    return "\n".join(lines)


def _convert_output_code(objective_str: str, num_class: int,
                         sigmoid: float) -> str:
    """ConvertOutput body per objective family (reference: each
    objective's ConvertOutput, e.g. binary_objective.hpp sigmoid,
    multiclass_objective.hpp softmax, regression poisson/gamma/tweedie
    exp)."""
    name = objective_str.split(" ")[0]
    if name in ("binary", "cross_entropy", "cross_entropy_lambda"):
        return ("  output[0] = 1.0 / (1.0 + std::exp(-%s * output[0]));"
                % _f(sigmoid if name == "binary" else 1.0))
    if name == "multiclass":
        return ("  Softmax(output, %d);" % num_class)
    if name == "multiclassova":
        return ("  for (int k = 0; k < %d; ++k) output[k] = "
                "1.0 / (1.0 + std::exp(-%s * output[k]));"
                % (num_class, _f(sigmoid)))
    if name in ("poisson", "gamma", "tweedie"):
        return "  output[0] = std::exp(output[0]);"
    return "  // identity"


def model_to_cpp(gbdt) -> str:
    """Emit the standalone C++ translation unit for ``gbdt``
    (reference: GBDT::ModelToIfElse, gbdt_model_text.cpp:76-286)."""
    models = gbdt.models
    num_tree_per_iter = gbdt.num_tree_per_iteration
    num_class = max(gbdt.num_class, 1)
    sigmoid = float(getattr(gbdt.config, "sigmoid", 1.0))
    obj_str = (gbdt.objective.to_string()
               if gbdt.objective is not None else "custom")

    parts = [
        "// Generated by lightgbm_tpu convert_model; standalone predictor.",
        "// Compile: g++ -O2 -shared -fPIC -o model.so model.cpp",
        "#include <cmath>",
        "#include <cstdint>",
        "#include <cstring>",
        "#include <limits>",
        "",
        "namespace {",
        "const double kZeroThreshold = %s;" % repr(kZeroThreshold),
        "inline double NanToZero(double v) "
        "{ return std::isnan(v) ? 0.0 : v; }",
        "inline bool CatDecision(double fval, const uint32_t* words, "
        "int n_words) {",
        "  if (std::isnan(fval)) return false;",
        "  int iv = static_cast<int>(fval);",
        "  if (iv < 0 || iv >= 32 * n_words) return false;",
        "  return (words[iv / 32] >> (iv & 31)) & 1;",
        "}",
        "inline void Softmax(double* rec, int n) {",
        "  double wmax = rec[0];",
        "  for (int k = 1; k < n; ++k) "
        "wmax = rec[k] > wmax ? rec[k] : wmax;",
        "  double wsum = 0.0;",
        "  for (int k = 0; k < n; ++k) "
        "{ rec[k] = std::exp(rec[k] - wmax); wsum += rec[k]; }",
        "  for (int k = 0; k < n; ++k) rec[k] /= wsum;",
        "}",
    ]

    for i, tree in enumerate(models):
        if tree.num_cat > 0:
            words = ",".join(str(int(w) & 0xFFFFFFFF)
                             for w in tree.cat_threshold)
            parts.append("const uint32_t kCatWords%d[] = {%s};"
                         % (i, words))
    for i, tree in enumerate(models):
        parts.append(_tree_fn(tree, i, leaf_index=False))
    for i, tree in enumerate(models):
        parts.append(_tree_fn(tree, i, leaf_index=True))

    fn_ptrs = ", ".join("PredictTree%d" % i for i in range(len(models)))
    leaf_ptrs = ", ".join("PredictTree%dLeaf" % i
                          for i in range(len(models)))
    parts += [
        "typedef double (*TreeFn)(const double*);",
        "const TreeFn kTreeFns[] = {%s};" % (fn_ptrs or "nullptr"),
        "const TreeFn kTreeLeafFns[] = {%s};" % (leaf_ptrs or "nullptr"),
        "const int kNumModels = %d;" % len(models),
        "const int kNumTreePerIter = %d;" % num_tree_per_iter,
        "const bool kAverageOutput = %s;"
        % ("true" if gbdt.average_output else "false"),
        "}  // namespace",
        "",
        'extern "C" void PredictRaw(const double* features, '
        "double* output) {",
        "  std::memset(output, 0, sizeof(double) * kNumTreePerIter);",
        "  for (int i = 0; i < kNumModels; ++i)",
        "    output[i % kNumTreePerIter] += kTreeFns[i](features);",
        "  if (kAverageOutput && kNumModels > 0)",
        "    for (int k = 0; k < kNumTreePerIter; ++k)",
        "      output[k] /= (kNumModels / kNumTreePerIter);",
        "}",
        "",
        'extern "C" void Predict(const double* features, double* output) {',
        "  PredictRaw(features, output);",
        _convert_output_code(obj_str, num_class, sigmoid),
        "}",
        "",
        'extern "C" void PredictLeafIndex(const double* features, '
        "double* output) {",
        "  for (int i = 0; i < kNumModels; ++i)",
        "    output[i] = kTreeLeafFns[i](features);",
        "}",
        "",
        'extern "C" int GetNumModels() { return kNumModels; }',
        'extern "C" int GetNumTreePerIteration() '
        "{ return kNumTreePerIter; }",
        "",
    ]
    return "\n".join(parts)
