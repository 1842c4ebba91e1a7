// C-ABI inference runtime over the v3 model text format.
//
// External-engine counterpart of the reference's C API
// (reference: include/LightGBM/c_api.h, src/c_api.cpp): a C/C++/R/Java
// host can load a model file produced by this framework OR by the
// reference (the text formats interchange bit-exactly,
// tests/test_reference_parity.py) and run prediction with no Python
// runtime at all. Function names and signatures follow the reference's
// predict-side surface so existing C clients re-link against this
// library unchanged; training-side entry points live in the Python
// runtime by design (docs/PARITY.md layer 8).
//
// Semantics mirrored here (and cross-checked by tests/test_c_api.py
// against the Python predictor bit-for-bit):
//  - numerical/categorical decisions incl. missing-value routing
//    (reference: include/LightGBM/tree.h:133 Predict,
//    NumericalDecision/CategoricalDecision; missing bits 2-3 of
//    decision_type, default-left bit 1, categorical bit 0)
//  - categorical bitset membership (reference: common.h FindInBitset)
//  - piecewise-linear leaves with NaN fallback to the constant
//    (reference: src/treelearner/linear_tree_learner.cpp predict)
//  - objective raw->output transforms (reference:
//    ObjectiveFunction::ConvertOutput per objective file)
//  - random-forest score averaging (average_output header flag)
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -o _capi.so capi.cpp
#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <sstream>
#include <string>
#include <vector>

#define LGBM_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

thread_local std::string g_last_error = "everything is fine";

constexpr double kZeroThreshold = 1e-35;  // io/binning.py:25
constexpr int kCategoricalMask = 1;
constexpr int kDefaultLeftMask = 2;
enum MissingType { kMissingNone = 0, kMissingZero = 1, kMissingNaN = 2 };

// predict_type values (reference: c_api.h C_API_PREDICT_*)
enum { kPredictNormal = 0, kPredictRaw = 1, kPredictLeaf = 2,
       kPredictContrib = 3 };
// data_type values (reference: c_api.h C_API_DTYPE_*)
enum { kDtypeF32 = 0, kDtypeF64 = 1, kDtypeI32 = 2, kDtypeI64 = 3 };

enum Transform { kIdentity, kSigmoid, kSoftmax, kExp, kSignSquare,
                 kLog1pExp };

struct CTree {
  int num_leaves = 1;
  std::vector<int> split_feature, left_child, right_child;
  std::vector<double> threshold, leaf_value;
  std::vector<int8_t> decision_type;
  std::vector<int> threshold_in_bin;  // cat-split index for cat nodes
  std::vector<int64_t> cat_boundaries;
  std::vector<uint32_t> cat_threshold;
  // data-coverage weights for SHAP (reference: tree.h data_count(node))
  std::vector<double> leaf_count, internal_count;
  // kept for DumpModel JSON (absent lines stay empty -> zeros)
  std::vector<double> split_gain, internal_value, internal_weight,
      leaf_weight;
  double shrinkage = 1.0;
  // prepared once at load time (PrepareShap): clamped coverage weights
  // (mirroring models/shap.py _node_count's max(count, 1)), the
  // cover-weighted expected value, and the flat-path capacity
  std::vector<double> shap_leaf_w, shap_node_w;
  double shap_expected = 0.0;
  size_t shap_path_capacity = 2;
  // linear leaves
  bool is_linear = false;
  std::vector<double> leaf_const;
  std::vector<std::vector<int>> leaf_features;
  std::vector<std::vector<double>> leaf_coeff;

  bool CatContains(int cat_idx, double fval) const {
    if (std::isnan(fval)) return false;
    int iv = static_cast<int>(fval);
    if (iv < 0) return false;
    int64_t lo = cat_boundaries[cat_idx];
    int64_t hi = cat_boundaries[cat_idx + 1];
    int64_t word = lo + iv / 32;
    if (word >= hi) return false;
    return (cat_threshold[word] >> (iv % 32)) & 1u;
  }

  // returns ~leaf walk; row is a dense feature vector (NaN = missing)
  int PredictLeaf(const double* row, int ncol) const {
    if (num_leaves <= 1) return 0;
    int node = 0;
    while (node >= 0) {
      int f = split_feature[node];
      double fval = (f < ncol) ? row[f] : std::nan("");
      int dt = decision_type[node];
      bool go_left;
      if (dt & kCategoricalMask) {
        go_left = CatContains(threshold_in_bin[node], fval);
      } else {
        int missing = (dt >> 2) & 3;
        bool default_left = dt & kDefaultLeftMask;
        bool is_nan = std::isnan(fval);
        double v = (is_nan && missing != kMissingNaN) ? 0.0 : fval;
        if (missing == kMissingZero && std::fabs(v) <= kZeroThreshold) {
          go_left = default_left;
        } else if (missing == kMissingNaN && is_nan) {
          go_left = default_left;
        } else {
          go_left = v <= threshold[node];
        }
      }
      node = go_left ? left_child[node] : right_child[node];
    }
    return ~node;
  }

  void PrepareShap() {
    int ni = num_leaves - 1;
    if ((int)leaf_count.size() >= num_leaves) {
      shap_leaf_w.resize(num_leaves);
      for (int l = 0; l < num_leaves; ++l)
        shap_leaf_w[l] = std::max(leaf_count[l], 1.0);
    } else {
      shap_leaf_w.assign(std::max(num_leaves, 1), 1.0);
    }
    if (ni <= 0) {
      shap_expected = leaf_value.empty() ? 0.0 : leaf_value[0];
      return;
    }
    if ((int)internal_count.size() >= ni) {
      shap_node_w.resize(ni);
      for (int j = 0; j < ni; ++j)
        shap_node_w[j] = std::max(internal_count[j], 1.0);
    } else {
      // bottom-up sums of leaf mass (a child internal node always has
      // a larger index than its parent — creation order)
      shap_node_w.assign(ni, 0.0);
      for (int j = ni - 1; j >= 0; --j) {
        int l = left_child[j], r = right_child[j];
        shap_node_w[j] = (l >= 0 ? shap_node_w[l] : shap_leaf_w[~l]) +
                         (r >= 0 ? shap_node_w[r] : shap_leaf_w[~r]);
      }
    }
    // expected value: RAW-count weighted leaf mean, unweighted when the
    // counts are absent/zero (models/shap.py _expected_value)
    double total = 0.0, acc = 0.0, plain = 0.0;
    for (int l = 0; l < num_leaves; ++l) {
      double c = (int)leaf_count.size() > l ? leaf_count[l] : 0.0;
      total += c;
      acc += c * leaf_value[l];
      plain += leaf_value[l];
    }
    shap_expected = total > 0 ? acc / total : plain / num_leaves;
    // flat path buffer: level d's segment starts after sum_{k<d}(k+1)
    // elements (reference TreeSHAP's parent_unique_path advance)
    std::vector<int> depth_of(ni, 0);
    int max_depth = 0;
    for (int j = 0; j < ni; ++j) {
      for (int child : {left_child[j], right_child[j]}) {
        int d = depth_of[j] + 1;
        if (child >= 0) depth_of[child] = d;
        if (d > max_depth) max_depth = d;
      }
    }
    size_t D = max_depth + 2;
    shap_path_capacity = (D + 1) * (D + 2) / 2 + D + 2;
  }

  double PredictValue(const double* row, int ncol) const {
    int leaf = PredictLeaf(row, ncol);
    if (is_linear) {
      // unfitted leaves (no features) and NaN rows keep the constant
      // leaf_value — NOT leaf_const, which misses later AddBias shifts
      // (reference: linear predict falls back to the leaf output)
      const auto& feats = leaf_features[leaf];
      if (!feats.empty()) {
        double out = leaf_const[leaf];
        bool ok = true;
        for (size_t j = 0; j < feats.size(); ++j) {
          double fv = (feats[j] < ncol) ? row[feats[j]] : std::nan("");
          if (std::isnan(fv)) { ok = false; break; }
          out += leaf_coeff[leaf][j] * fv;
        }
        if (ok) return out;
      }
    }
    return leaf_value[leaf];
  }
};

template <typename T>
std::vector<T> ParseArray(const std::string& s) {
  std::vector<T> out;
  std::istringstream is(s);
  if constexpr (std::is_same_v<T, int8_t>) {
    int v;  // int8 must parse as integer text, not raw char
    while (is >> v) out.push_back(static_cast<int8_t>(v));
  } else {
    T v;
    while (is >> v) out.push_back(v);
  }
  return out;
}

struct CBooster {
  int num_class = 1;
  int num_tree_per_iteration = 1;
  int max_feature_idx = 0;
  bool average_output = false;
  Transform transform = kIdentity;
  double sigmoid = 1.0;
  int label_index = 0;
  std::string objective_str;
  std::vector<int> monotone_constraints;
  std::vector<std::string> feature_infos;
  std::vector<std::string> feature_names;
  std::vector<CTree> trees;
  std::string raw_model;  // original text, for SaveModel round-trip

  int NumIterations() const {
    return static_cast<int>(trees.size()) / num_tree_per_iteration;
  }

  // trees [start_iteration, start_iteration + num_iteration) in
  // iteration units; num_iteration <= 0 means "to the end"
  void UsedRange(int start_iteration, int num_iteration,
                 int* t0, int* t1) const {
    int total = NumIterations();
    int s = std::max(start_iteration, 0);
    int n = (num_iteration <= 0) ? total - s
                                 : std::min(num_iteration, total - s);
    n = std::max(n, 0);
    *t0 = s * num_tree_per_iteration;
    *t1 = (s + n) * num_tree_per_iteration;
  }

  void PredictRawRow(const double* row, int ncol, int t0, int t1,
                     double* out) const {
    for (int k = 0; k < num_class; ++k) out[k] = 0.0;
    for (int i = t0; i < t1; ++i) {
      out[i % num_tree_per_iteration] += trees[i].PredictValue(row, ncol);
    }
    if (average_output && t1 > t0) {
      double denom = double(t1 - t0) / num_tree_per_iteration;
      for (int k = 0; k < num_class; ++k) out[k] /= denom;
    }
  }

  void ApplyTransform(double* out) const {
    switch (transform) {
      case kIdentity:
        break;
      case kSigmoid:
        for (int k = 0; k < num_class; ++k)
          out[k] = 1.0 / (1.0 + std::exp(-sigmoid * out[k]));
        break;
      case kSoftmax: {
        double m = out[0];
        for (int k = 1; k < num_class; ++k) m = std::max(m, out[k]);
        double sum = 0.0;
        for (int k = 0; k < num_class; ++k) {
          out[k] = std::exp(out[k] - m);
          sum += out[k];
        }
        for (int k = 0; k < num_class; ++k) out[k] /= sum;
        break;
      }
      case kExp:
        for (int k = 0; k < num_class; ++k) out[k] = std::exp(out[k]);
        break;
      case kSignSquare:
        for (int k = 0; k < num_class; ++k)
          out[k] = (out[k] < 0 ? -1.0 : 1.0) * out[k] * out[k];
        break;
      case kLog1pExp:
        for (int k = 0; k < num_class; ++k)
          out[k] = std::log1p(std::exp(out[k]));
        break;
    }
  }
};

bool ParseTree(const std::map<std::string, std::string>& kv, CTree* t,
               std::string* err) {
  auto get = [&](const char* k) -> const std::string* {
    auto it = kv.find(k);
    return it == kv.end() ? nullptr : &it->second;
  };
  const std::string* nl = get("num_leaves");
  if (!nl) { *err = "tree block missing num_leaves"; return false; }
  t->num_leaves = std::atoi(nl->c_str());
  if (t->num_leaves <= 1) {
    t->leaf_value = {get("leaf_value") ? std::atof(get("leaf_value")->c_str())
                                       : 0.0};
    t->num_leaves = 1;
  } else {
    int ni = t->num_leaves - 1;
    for (const char* k : {"split_feature", "threshold", "decision_type",
                          "left_child", "right_child", "leaf_value"}) {
      if (!get(k)) {
        *err = std::string("tree block missing ") + k;
        return false;
      }
    }
    t->split_feature = ParseArray<int>(*get("split_feature"));
    t->threshold = ParseArray<double>(*get("threshold"));
    t->decision_type = ParseArray<int8_t>(*get("decision_type"));
    t->left_child = ParseArray<int>(*get("left_child"));
    t->right_child = ParseArray<int>(*get("right_child"));
    t->leaf_value = ParseArray<double>(*get("leaf_value"));
    if ((int)t->split_feature.size() < ni ||
        (int)t->threshold.size() < ni ||
        (int)t->decision_type.size() < ni ||
        (int)t->left_child.size() < ni ||
        (int)t->right_child.size() < ni ||
        (int)t->leaf_value.size() < t->num_leaves) {
      *err = "tree block has truncated arrays";
      return false;
    }
    for (int j = 0; j < ni; ++j) {
      // child pointers: >=0 internal node index, <0 encodes leaf ~idx
      // internal children must have a LARGER index than the parent
      // (creation order, tree.h Split numbering) — also rules out
      // cycles that would hang PredictLeaf's walk
      if (t->left_child[j] >= ni || t->left_child[j] < -t->num_leaves ||
          t->right_child[j] >= ni || t->right_child[j] < -t->num_leaves ||
          (t->left_child[j] >= 0 && t->left_child[j] <= j) ||
          (t->right_child[j] >= 0 && t->right_child[j] <= j) ||
          t->split_feature[j] < 0) {
        *err = "tree block has out-of-range node indices";
        return false;
      }
    }
    if (get("leaf_count"))
      t->leaf_count = ParseArray<double>(*get("leaf_count"));
    if (get("internal_count"))
      t->internal_count = ParseArray<double>(*get("internal_count"));
    if (get("split_gain"))
      t->split_gain = ParseArray<double>(*get("split_gain"));
    if (get("internal_value"))
      t->internal_value = ParseArray<double>(*get("internal_value"));
    if (get("internal_weight"))
      t->internal_weight = ParseArray<double>(*get("internal_weight"));
    if (get("leaf_weight"))
      t->leaf_weight = ParseArray<double>(*get("leaf_weight"));
    // cat nodes keep the cat-split index in `threshold`
    t->threshold_in_bin.assign(ni, 0);
    if (get("cat_boundaries")) {
      t->cat_boundaries = ParseArray<int64_t>(*get("cat_boundaries"));
      if (get("cat_threshold"))
        t->cat_threshold = ParseArray<uint32_t>(*get("cat_threshold"));
      for (size_t k = 1; k < t->cat_boundaries.size(); ++k) {
        if (t->cat_boundaries[k] < t->cat_boundaries[k - 1] ||
            t->cat_boundaries[k] > (int64_t)t->cat_threshold.size()) {
          *err = "tree block has inconsistent cat_boundaries";
          return false;
        }
      }
    }
    for (int j = 0; j < ni; ++j) {
      if (t->decision_type[j] & kCategoricalMask) {
        int ci = static_cast<int>(t->threshold[j]);
        if (ci < 0 || ci + 1 >= (int)t->cat_boundaries.size()) {
          *err = "tree block has categorical node without bitset";
          return false;
        }
        t->threshold_in_bin[j] = ci;
      }
    }
  }
  if (get("shrinkage")) t->shrinkage = std::atof(get("shrinkage")->c_str());
  const std::string* lin = get("is_linear");
  if (lin && std::atoi(lin->c_str())) {
    if (!get("leaf_const")) {
      *err = "linear tree block missing leaf_const";
      return false;
    }
    t->is_linear = true;
    t->leaf_const = ParseArray<double>(*get("leaf_const"));
    if ((int)t->leaf_const.size() < t->num_leaves) {
      *err = "linear tree block has truncated leaf_const";
      return false;
    }
    std::vector<int> nfeat = get("num_features")
        ? ParseArray<int>(*get("num_features")) : std::vector<int>();
    std::vector<int> flat_f = get("leaf_features")
        ? ParseArray<int>(*get("leaf_features")) : std::vector<int>();
    std::vector<double> flat_c = get("leaf_coeff")
        ? ParseArray<double>(*get("leaf_coeff")) : std::vector<double>();
    size_t pos = 0;
    for (int c : nfeat) {
      if (c < 0 || pos + c > flat_f.size() || pos + c > flat_c.size()) {
        *err = "linear tree block has truncated leaf features";
        return false;
      }
      t->leaf_features.emplace_back(flat_f.begin() + pos,
                                    flat_f.begin() + pos + c);
      t->leaf_coeff.emplace_back(flat_c.begin() + pos,
                                 flat_c.begin() + pos + c);
      pos += c;
    }
    t->leaf_features.resize(t->num_leaves);
    t->leaf_coeff.resize(t->num_leaves);
  }
  return true;
}

bool SetObjective(const std::string& spec, CBooster* b, std::string* err) {
  std::istringstream is(spec);
  std::string name, tok;
  is >> name;
  double sigmoid = 1.0;
  while (is >> tok) {
    if (tok.rfind("sigmoid:", 0) == 0)
      sigmoid = std::atof(tok.c_str() + 8);
    // num_class:/alpha:/etc. don't affect ConvertOutput
  }
  b->sigmoid = sigmoid;
  if (name == "binary" || name == "cross_entropy" ||
      name == "multiclassova" || name == "xentropy") {
    b->transform = kSigmoid;
  } else if (name == "multiclass" || name == "softmax") {
    b->transform = kSoftmax;
  } else if (name == "poisson" || name == "gamma" || name == "tweedie") {
    b->transform = kExp;
  } else if (name == "cross_entropy_lambda" || name == "xentlambda") {
    b->transform = kLog1pExp;
  } else if (name == "regression" && spec.find("sqrt") != std::string::npos) {
    b->transform = kSignSquare;
  } else {
    b->transform = kIdentity;  // l2/l1/huber/fair/quantile/mape/ranking
  }
  (void)err;
  return true;
}

CBooster* LoadFromString(const std::string& s, std::string* err) {
  auto b = std::make_unique<CBooster>();
  b->raw_model = s;
  std::istringstream is(s);
  std::string line;
  auto getline_crlf = [&](std::string& out) -> bool {
    if (!std::getline(is, out)) return false;
    if (!out.empty() && out.back() == '\r') out.pop_back();
    return true;
  };
  // header until the first Tree= block
  while (getline_crlf(line)) {
    if (line.rfind("Tree=", 0) == 0) break;
    if (line == "average_output") { b->average_output = true; continue; }
    auto eq = line.find('=');
    if (eq == std::string::npos) continue;
    std::string k = line.substr(0, eq), v = line.substr(eq + 1);
    if (k == "num_class") b->num_class = std::atoi(v.c_str());
    else if (k == "num_tree_per_iteration")
      b->num_tree_per_iteration = std::atoi(v.c_str());
    else if (k == "max_feature_idx") b->max_feature_idx = std::atoi(v.c_str());
    else if (k == "label_index") b->label_index = std::atoi(v.c_str());
    else if (k == "objective") {
      b->objective_str = v;
      if (!SetObjective(v, b.get(), err)) return nullptr;
    } else if (k == "monotone_constraints") {
      std::istringstream ms(v);
      int mc;
      while (ms >> mc) b->monotone_constraints.push_back(mc);
    } else if (k == "feature_infos") {
      std::istringstream fs(v);
      std::string info;
      while (fs >> info) b->feature_infos.push_back(info);
    } else if (k == "feature_names") {
      std::istringstream ns(v);
      std::string n;
      while (ns >> n) b->feature_names.push_back(n);
    }
  }
  if (line.rfind("Tree=", 0) != 0) {
    *err = "no Tree= blocks found (not a model file?)";
    return nullptr;
  }
  // tree blocks: key=value lines until blank/next Tree=/end of trees
  std::map<std::string, std::string> kv;
  auto flush = [&]() -> bool {
    if (kv.empty()) return true;
    CTree t;
    if (!ParseTree(kv, &t, err)) return false;
    // feature indices size the caller's contrib buffer
    // (max_feature_idx + 2 per class) — an index past the header's
    // bound would write out of that buffer in the SHAP path
    for (int j = 0; j < t.num_leaves - 1; ++j) {
      if (t.split_feature[j] > b->max_feature_idx) {
        *err = "tree split_feature exceeds header max_feature_idx";
        return false;
      }
    }
    t.PrepareShap();
    b->trees.push_back(std::move(t));
    kv.clear();
    return true;
  };
  while (getline_crlf(line)) {
    if (line.rfind("Tree=", 0) == 0) {
      if (!flush()) return nullptr;
      continue;
    }
    if (line == "end of trees") break;
    auto eq = line.find('=');
    if (eq != std::string::npos)
      kv[line.substr(0, eq)] = line.substr(eq + 1);
  }
  if (!flush()) return nullptr;
  if (b->trees.empty()) { *err = "model has no trees"; return nullptr; }
  if (b->num_class < 1) b->num_class = 1;
  if (b->num_tree_per_iteration < 1) b->num_tree_per_iteration = 1;
  if (b->num_tree_per_iteration > b->num_class) {
    // output stride is num_class; a larger ntpi would write past the
    // caller's buffer in PredictRawRow (out[i % ntpi])
    *err = "num_tree_per_iteration exceeds num_class";
    return nullptr;
  }
  return b.release();
}

int64_t PredictOutputLen(const CBooster* b, int64_t nrow, int predict_type,
                         int t0, int t1) {
  if (predict_type == kPredictLeaf) return nrow * (t1 - t0);
  if (predict_type == kPredictContrib)
    return nrow * b->num_class * (b->max_feature_idx + 2);
  return nrow * b->num_class;
}

// SHAP feature contributions via per-leaf path attribution
// (reference: src/io/tree.cpp TreeSHAP / PredictContrib). Exact
// TreeSHAP (Lundberg's EXPVALUE recursion over weight-extended paths).
struct PathElem {
  int feature_index;
  double zero_fraction, one_fraction, pweight;
};

void ExtendPath(PathElem* path, int depth,
                double zero_fraction, double one_fraction,
                int feature_index) {
  path[depth] = {feature_index, zero_fraction, one_fraction,
                 depth == 0 ? 1.0 : 0.0};
  for (int i = depth - 1; i >= 0; --i) {
    path[i + 1].pweight += one_fraction * path[i].pweight * (i + 1)
                           / double(depth + 1);
    path[i].pweight = zero_fraction * path[i].pweight * (depth - i)
                      / double(depth + 1);
  }
}

void UnwindPath(PathElem* path, int depth, int index) {
  double one_fraction = path[index].one_fraction;
  double zero_fraction = path[index].zero_fraction;
  double next_one = path[depth].pweight;
  for (int i = depth - 1; i >= 0; --i) {
    if (one_fraction != 0) {
      double tmp = path[i].pweight;
      path[i].pweight = next_one * (depth + 1)
                        / (double(i + 1) * one_fraction);
      next_one = tmp - path[i].pweight * zero_fraction * (depth - i)
                       / double(depth + 1);
    } else {
      path[i].pweight = path[i].pweight * (depth + 1)
                        / (zero_fraction * (depth - i));
    }
  }
  for (int i = index; i < depth; ++i) {
    path[i].feature_index = path[i + 1].feature_index;
    path[i].zero_fraction = path[i + 1].zero_fraction;
    path[i].one_fraction = path[i + 1].one_fraction;
  }
}

double UnwoundPathSum(const PathElem* path, int depth,
                      int index) {
  double one_fraction = path[index].one_fraction;
  double zero_fraction = path[index].zero_fraction;
  double next_one = path[depth].pweight;
  double total = 0;
  for (int i = depth - 1; i >= 0; --i) {
    if (one_fraction != 0) {
      double tmp = next_one * (depth + 1)
                   / (double(i + 1) * one_fraction);
      total += tmp;
      next_one = path[i].pweight - tmp * zero_fraction * (depth - i)
                                   / double(depth + 1);
    } else if (zero_fraction != 0) {
      total += (path[i].pweight / zero_fraction)
               / ((depth - i) / double(depth + 1));
    }
  }
  return total;
}

struct ShapContext {
  const CTree* tree;
  const double* row;
  int ncol;
  double* contribs;  // length ncol+1; last = expected value
  // one flat buffer per predict call; each recursion level claims the
  // segment after its parent's (reference: src/io/tree.cpp TreeSHAP's
  // parent_unique_path + unique_depth + 1 advance), so a child's
  // duplicate-unwind never corrupts the path its parent hands to the
  // sibling
  std::vector<PathElem> storage;
};

double NodeWeight(const ShapContext& ctx, int node) {
  return node >= 0 ? ctx.tree->shap_node_w[node]
                   : ctx.tree->shap_leaf_w[~node];
}

void TreeShapRecurse(ShapContext& ctx, int node, PathElem* parent_path,
                     int depth, double zero_fraction, double one_fraction,
                     int parent_feature) {
  PathElem* path = parent_path + depth + 1;  // fresh copy per level
  std::copy(parent_path, parent_path + depth + 1, path);
  ExtendPath(path, depth, zero_fraction, one_fraction, parent_feature);
  if (node < 0) {  // leaf
    double v = ctx.tree->leaf_value[~node];
    for (int i = 1; i <= depth; ++i) {
      double w = UnwoundPathSum(path, depth, i);
      ctx.contribs[path[i].feature_index] +=
          w * (path[i].one_fraction - path[i].zero_fraction) * v;
    }
    return;
  }
  const CTree* t = ctx.tree;
  int f = t->split_feature[node];
  double fval = (f < ctx.ncol) ? ctx.row[f] : std::nan("");
  int dt = t->decision_type[node];
  bool go_left;
  if (dt & kCategoricalMask) {
    go_left = t->CatContains(t->threshold_in_bin[node], fval);
  } else {
    int missing = (dt >> 2) & 3;
    bool default_left = dt & kDefaultLeftMask;
    bool is_nan = std::isnan(fval);
    double v = (is_nan && missing != kMissingNaN) ? 0.0 : fval;
    if (missing == kMissingZero && std::fabs(v) <= kZeroThreshold)
      go_left = default_left;
    else if (missing == kMissingNaN && is_nan)
      go_left = default_left;
    else
      go_left = v <= t->threshold[node];
  }
  int hot = go_left ? t->left_child[node] : t->right_child[node];
  int cold = go_left ? t->right_child[node] : t->left_child[node];
  double w = NodeWeight(ctx, node);
  double hot_frac = w > 0 ? NodeWeight(ctx, hot) / w : 0.0;
  double cold_frac = w > 0 ? NodeWeight(ctx, cold) / w : 0.0;
  // if this feature is already on the path, undo and merge fractions
  double incoming_zero = 1.0, incoming_one = 1.0;
  int path_index = 0;
  for (; path_index <= depth; ++path_index) {
    if (path[path_index].feature_index == f) break;
  }
  if (path_index != depth + 1) {
    incoming_zero = path[path_index].zero_fraction;
    incoming_one = path[path_index].one_fraction;
    UnwindPath(path, depth, path_index);
    depth -= 1;
  }
  TreeShapRecurse(ctx, hot, path, depth + 1, hot_frac * incoming_zero,
                  incoming_one, f);
  TreeShapRecurse(ctx, cold, path, depth + 1, cold_frac * incoming_zero,
                  0.0, f);
}

}  // namespace

// ---------------------------------------------------------------------
// exported C surface
// ---------------------------------------------------------------------

LGBM_EXPORT const char* LGBM_GetLastError() { return g_last_error.c_str(); }

static int Fail(const std::string& msg) {
  g_last_error = msg;
  return -1;
}

LGBM_EXPORT int LGBM_BoosterLoadModelFromString(const char* model_str,
                                                int* out_num_iterations,
                                                void** out) {
  if (!model_str || !out) return Fail("null argument");
  std::string err;
  CBooster* b = LoadFromString(model_str, &err);
  if (!b) return Fail(err);
  if (out_num_iterations) *out_num_iterations = b->NumIterations();
  *out = b;
  return 0;
}

LGBM_EXPORT int LGBM_BoosterCreateFromModelfile(const char* filename,
                                                int* out_num_iterations,
                                                void** out) {
  if (!filename || !out) return Fail("null argument");
  std::ifstream f(filename, std::ios::binary);
  if (!f) return Fail(std::string("cannot open ") + filename);
  std::ostringstream ss;
  ss << f.rdbuf();
  return LGBM_BoosterLoadModelFromString(ss.str().c_str(),
                                         out_num_iterations, out);
}

LGBM_EXPORT int LGBM_BoosterFree(void* handle) {
  delete static_cast<CBooster*>(handle);
  return 0;
}

LGBM_EXPORT int LGBM_BoosterGetNumClasses(void* handle, int* out_len) {
  if (!handle || !out_len) return Fail("null argument");
  *out_len = static_cast<CBooster*>(handle)->num_class;
  return 0;
}

LGBM_EXPORT int LGBM_BoosterGetNumFeature(void* handle, int* out_len) {
  if (!handle || !out_len) return Fail("null argument");
  *out_len = static_cast<CBooster*>(handle)->max_feature_idx + 1;
  return 0;
}

LGBM_EXPORT int LGBM_BoosterGetCurrentIteration(void* handle,
                                                int* out_iteration) {
  if (!handle || !out_iteration) return Fail("null argument");
  *out_iteration = static_cast<CBooster*>(handle)->NumIterations();
  return 0;
}

LGBM_EXPORT int LGBM_BoosterCalcNumPredict(void* handle, int num_row,
                                           int predict_type,
                                           int start_iteration,
                                           int num_iteration,
                                           int64_t* out_len) {
  if (!handle || !out_len) return Fail("null argument");
  auto* b = static_cast<CBooster*>(handle);
  int t0, t1;
  b->UsedRange(start_iteration, num_iteration, &t0, &t1);
  *out_len = PredictOutputLen(b, num_row, predict_type, t0, t1);
  return 0;
}

static void PredictRowInto(const CBooster* b, const double* row, int ncol,
                           int predict_type, int t0, int t1, double* out,
                           ShapContext* scratch = nullptr) {
  if (predict_type == kPredictLeaf) {
    for (int i = t0; i < t1; ++i)
      out[i - t0] = b->trees[i].PredictLeaf(row, ncol);
    return;
  }
  if (predict_type == kPredictContrib) {
    int ncontrib = b->max_feature_idx + 2;
    for (int k = 0; k < b->num_class; ++k)
      std::memset(out + k * ncontrib, 0, sizeof(double) * ncontrib);
    ShapContext local;
    ShapContext& ctx = scratch ? *scratch : local;
    ctx.row = row;
    ctx.ncol = ncol;
    for (int i = t0; i < t1; ++i) {
      const CTree& t = b->trees[i];
      double* cls_out = out + (i % b->num_tree_per_iteration) * ncontrib;
      cls_out[ncontrib - 1] += t.shap_expected;
      if (t.num_leaves <= 1) continue;
      ctx.tree = &t;
      ctx.contribs = cls_out;  // recursion touches feature slots only
      if (ctx.storage.size() < t.shap_path_capacity)
        ctx.storage.resize(t.shap_path_capacity);
      TreeShapRecurse(ctx, 0, ctx.storage.data(), 0, 1.0, 1.0, -1);
    }
    return;
  }
  // normal / raw
  b->PredictRawRow(row, ncol, t0, t1, out);
  if (predict_type == kPredictNormal) b->ApplyTransform(out);
}

LGBM_EXPORT int LGBM_BoosterPredictForMat(
    void* handle, const void* data, int data_type, int32_t nrow,
    int32_t ncol, int is_row_major, int predict_type, int start_iteration,
    int num_iteration, const char* parameter, int64_t* out_len,
    double* out_result) {
  (void)parameter;
  if (!handle || !data || !out_result) return Fail("null argument");
  if (data_type != kDtypeF32 && data_type != kDtypeF64)
    return Fail("data_type must be C_API_DTYPE_FLOAT32/64");
  auto* b = static_cast<CBooster*>(handle);
  int t0, t1;
  b->UsedRange(start_iteration, num_iteration, &t0, &t1);
  int64_t stride = PredictOutputLen(b, 1, predict_type, t0, t1);
  std::vector<double> row(ncol);
  ShapContext scratch;  // reused path storage across rows
  for (int32_t r = 0; r < nrow; ++r) {
    for (int32_t c = 0; c < ncol; ++c) {
      int64_t idx = is_row_major ? int64_t(r) * ncol + c
                                 : int64_t(c) * nrow + r;
      row[c] = (data_type == kDtypeF64)
                   ? static_cast<const double*>(data)[idx]
                   : static_cast<double>(
                         static_cast<const float*>(data)[idx]);
    }
    PredictRowInto(b, row.data(), ncol, predict_type, t0, t1,
                   out_result + r * stride, &scratch);
  }
  if (out_len) *out_len = nrow * stride;
  return 0;
}

LGBM_EXPORT int LGBM_BoosterPredictForCSR(
    void* handle, const void* indptr, int indptr_type,
    const int32_t* indices, const void* data, int data_type,
    int64_t nindptr, int64_t nelem, int64_t num_col, int predict_type,
    int start_iteration, int num_iteration, const char* parameter,
    int64_t* out_len, double* out_result) {
  (void)parameter;
  (void)nelem;
  if (!handle || !indptr || !indices || !data || !out_result)
    return Fail("null argument");
  auto* b = static_cast<CBooster*>(handle);
  int t0, t1;
  b->UsedRange(start_iteration, num_iteration, &t0, &t1);
  int64_t stride = PredictOutputLen(b, 1, predict_type, t0, t1);
  int64_t nrow = nindptr - 1;
  std::vector<double> row(num_col);
  ShapContext scratch;  // reused path storage across rows
  for (int64_t r = 0; r < nrow; ++r) {
    std::fill(row.begin(), row.end(), 0.0);
    int64_t lo, hi;
    if (indptr_type == kDtypeI64) {
      lo = static_cast<const int64_t*>(indptr)[r];
      hi = static_cast<const int64_t*>(indptr)[r + 1];
    } else {
      lo = static_cast<const int32_t*>(indptr)[r];
      hi = static_cast<const int32_t*>(indptr)[r + 1];
    }
    for (int64_t j = lo; j < hi; ++j) {
      int32_t c = indices[j];
      if (c >= 0 && c < num_col)
        row[c] = (data_type == kDtypeF64)
                     ? static_cast<const double*>(data)[j]
                     : static_cast<double>(
                           static_cast<const float*>(data)[j]);
    }
    PredictRowInto(b, row.data(), static_cast<int>(num_col), predict_type,
                   t0, t1, out_result + r * stride, &scratch);
  }
  if (out_len) *out_len = nrow * stride;
  return 0;
}

// single-row fast paths (reference: c_api.h PredictForMatSingleRow /
// PredictForCSRSingleRow — the serving hot path; same semantics as the
// batched calls with nrow == 1)
LGBM_EXPORT int LGBM_BoosterPredictForMatSingleRow(
    void* handle, const void* data, int data_type, int32_t ncol,
    int is_row_major, int predict_type, int start_iteration,
    int num_iteration, const char* parameter, int64_t* out_len,
    double* out_result) {
  return LGBM_BoosterPredictForMat(handle, data, data_type, 1, ncol,
                                   is_row_major, predict_type,
                                   start_iteration, num_iteration,
                                   parameter, out_len, out_result);
}

LGBM_EXPORT int LGBM_BoosterPredictForCSRSingleRow(
    void* handle, const void* indptr, int indptr_type,
    const int32_t* indices, const void* data, int data_type,
    int64_t nindptr, int64_t nelem, int64_t num_col, int predict_type,
    int start_iteration, int num_iteration, const char* parameter,
    int64_t* out_len, double* out_result) {
  if (nindptr != 2) return Fail("single-row CSR requires nindptr == 2");
  return LGBM_BoosterPredictForCSR(handle, indptr, indptr_type, indices,
                                   data, data_type, nindptr, nelem,
                                   num_col, predict_type,
                                   start_iteration, num_iteration,
                                   parameter, out_len, out_result);
}

LGBM_EXPORT int LGBM_BoosterSaveModelToString(
    void* handle, int start_iteration, int num_iteration,
    int feature_importance_type, int64_t buffer_len, int64_t* out_len,
    char* out_str) {
  (void)feature_importance_type;
  if (!handle || !out_len) return Fail("null argument");
  auto* b = static_cast<CBooster*>(handle);
  if (b->raw_model.empty())
    return Fail("model was modified in memory (SetLeafValue); the "
                "verbatim text is gone — re-save from the training "
                "runtime instead");
  if (start_iteration != 0 ||
      (num_iteration > 0 && num_iteration < b->NumIterations()))
    return Fail("predict-side C API keeps the loaded model verbatim; "
                "slice iterations at predict time instead");
  *out_len = static_cast<int64_t>(b->raw_model.size()) + 1;
  if (out_str && buffer_len >= *out_len)
    std::memcpy(out_str, b->raw_model.c_str(), *out_len);
  return 0;
}

LGBM_EXPORT int LGBM_BoosterSaveModel(void* handle, int start_iteration,
                                      int num_iteration,
                                      int feature_importance_type,
                                      const char* filename) {
  (void)feature_importance_type;
  if (!handle || !filename) return Fail("null argument");
  auto* b = static_cast<CBooster*>(handle);
  if (b->raw_model.empty())
    return Fail("model was modified in memory (SetLeafValue); the "
                "verbatim text is gone — re-save from the training "
                "runtime instead");
  if (start_iteration != 0 ||
      (num_iteration > 0 && num_iteration < b->NumIterations()))
    return Fail("predict-side C API keeps the loaded model verbatim");
  std::ofstream f(filename, std::ios::binary);
  if (!f) return Fail(std::string("cannot write ") + filename);
  f << b->raw_model;
  return 0;
}

// CSC prediction: counting-sort the nonzeros into per-row (col, val)
// buckets in O(nnz), then run the same per-row walk as CSR — no dense
// materialization (reference: c_api.cpp PredictForCSC iterates columns
// through an adapter for the same reason)
LGBM_EXPORT int LGBM_BoosterPredictForCSC(
    void* handle, const void* col_ptr, int col_ptr_type,
    const int32_t* indices, const void* data, int data_type,
    int64_t ncol_ptr, int64_t nelem, int64_t num_row, int predict_type,
    int start_iteration, int num_iteration, const char* parameter,
    int64_t* out_len, double* out_result) {
  (void)parameter;
  if (!handle || !col_ptr || !indices || !data || !out_result)
    return Fail("null argument");
  if (data_type != kDtypeF32 && data_type != kDtypeF64)
    return Fail("data_type must be C_API_DTYPE_FLOAT32/64");
  int64_t ncol = ncol_ptr - 1;
  if (ncol < 0 || num_row < 0 || ncol > INT32_MAX || num_row > INT32_MAX)
    return Fail("bad CSC dimensions");
  auto colptr_at = [&](int64_t c) -> int64_t {
    return col_ptr_type == kDtypeI64
               ? static_cast<const int64_t*>(col_ptr)[c]
               : static_cast<const int64_t>(
                     static_cast<const int32_t*>(col_ptr)[c]);
  };
  int64_t nnz = colptr_at(ncol);
  if (nnz < 0 || nnz > nelem) return Fail("bad CSC col_ptr");
  // counting sort by row
  std::vector<int64_t> row_start(num_row + 1, 0);
  for (int64_t j = 0; j < nnz; ++j) {
    int32_t r = indices[j];
    if (r < 0 || r >= num_row) return Fail("CSC row index out of range");
    row_start[r + 1] += 1;
  }
  for (int64_t r = 0; r < num_row; ++r) row_start[r + 1] += row_start[r];
  std::vector<int32_t> row_col(nnz);
  std::vector<double> row_val(nnz);
  {
    std::vector<int64_t> cursor(row_start.begin(), row_start.end() - 1);
    for (int64_t c = 0; c < ncol; ++c) {
      for (int64_t j = colptr_at(c); j < colptr_at(c + 1); ++j) {
        int64_t pos = cursor[indices[j]]++;
        row_col[pos] = static_cast<int32_t>(c);
        row_val[pos] =
            (data_type == kDtypeF64)
                ? static_cast<const double*>(data)[j]
                : static_cast<double>(
                      static_cast<const float*>(data)[j]);
      }
    }
  }
  auto* b = static_cast<CBooster*>(handle);
  int t0, t1;
  b->UsedRange(start_iteration, num_iteration, &t0, &t1);
  int64_t stride = PredictOutputLen(b, 1, predict_type, t0, t1);
  std::vector<double> row(ncol, 0.0);
  ShapContext scratch;
  for (int64_t r = 0; r < num_row; ++r) {
    for (int64_t j = row_start[r]; j < row_start[r + 1]; ++j)
      row[row_col[j]] = row_val[j];
    PredictRowInto(b, row.data(), static_cast<int>(ncol), predict_type,
                   t0, t1, out_result + r * stride, &scratch);
    for (int64_t j = row_start[r]; j < row_start[r + 1]; ++j)
      row[row_col[j]] = 0.0;
  }
  if (out_len) *out_len = num_row * stride;
  return 0;
}

LGBM_EXPORT int LGBM_BoosterGetNumPredict(void* handle, int data_idx,
                                          int64_t* out_len) {
  (void)data_idx;
  if (!handle || !out_len) return Fail("null argument");
  // prediction-only runtime: no attached datasets
  *out_len = 0;
  return 0;
}

LGBM_EXPORT int LGBM_BoosterGetLeafValue(void* handle, int tree_idx,
                                         int leaf_idx, double* out_val) {
  if (!handle || !out_val) return Fail("null argument");
  auto* b = static_cast<CBooster*>(handle);
  if (tree_idx < 0 || tree_idx >= (int)b->trees.size())
    return Fail("tree_idx out of range");
  const CTree& t = b->trees[tree_idx];
  if (leaf_idx < 0 || leaf_idx >= t.num_leaves)
    return Fail("leaf_idx out of range");
  *out_val = t.leaf_value[leaf_idx];
  return 0;
}

LGBM_EXPORT int LGBM_BoosterSetLeafValue(void* handle, int tree_idx,
                                         int leaf_idx, double val) {
  if (!handle) return Fail("null argument");
  auto* b = static_cast<CBooster*>(handle);
  if (tree_idx < 0 || tree_idx >= (int)b->trees.size())
    return Fail("tree_idx out of range");
  CTree& t = b->trees[tree_idx];
  if (leaf_idx < 0 || leaf_idx >= t.num_leaves)
    return Fail("leaf_idx out of range");
  t.leaf_value[leaf_idx] = val;
  t.PrepareShap();  // expected value depends on leaf values
  // the loaded text no longer matches the edited model; SaveModel*
  // return the error below rather than stale bytes
  b->raw_model.clear();
  return 0;
}

LGBM_EXPORT int LGBM_BoosterGetFeatureNames(void* handle, int len,
                                            int* out_len,
                                            size_t buffer_len,
                                            size_t* out_buffer_len,
                                            char** out_strs) {
  if (!handle || !out_len || !out_buffer_len) return Fail("null argument");
  auto* b = static_cast<CBooster*>(handle);
  *out_len = static_cast<int>(b->feature_names.size());
  size_t longest = 0;
  for (auto& n : b->feature_names) longest = std::max(longest, n.size() + 1);
  *out_buffer_len = longest;
  if (out_strs) {
    int n = std::min(len, *out_len);
    for (int i = 0; i < n; ++i) {
      std::snprintf(out_strs[i], buffer_len, "%s",
                    b->feature_names[i].c_str());
    }
  }
  return 0;
}

// ---------------------------------------------------------------------
// file prediction (reference: c_api.cpp LGBM_BoosterPredictForFile,
// backing the CLI predict task): parse a CSV/TSV/LibSVM file with the
// shared native parser and write one prediction line per row — a
// complete C-only deployment pipeline with no Python runtime.
#define PARSER_API __attribute__((visibility("hidden")))
#include "parser.cpp"  // ParseDense/ParseLibSVM/FreeBuffer (same TU,
                       // symbols hidden: _parser.so owns the exports)

namespace {

// format sniff mirroring the Python dispatch (application's loader):
// the SECOND whitespace token of the first data line looking like
// "idx:val" means LibSVM; otherwise the delimiter is , / tab / space.
// The sniffed line skips the header row when the caller declared one.
int SniffFormat(const char* path, int skip_header, char* delim) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return -1;
  std::string line;
  for (int i = 0; i <= (skip_header ? 1 : 0); ++i) {
    if (!std::getline(f, line)) return -1;
  }
  if (line.find(',') != std::string::npos) { *delim = ','; return 0; }
  // whitespace format: LibSVM iff the second token carries ':'
  const char* p = line.c_str();
  while (*p && !std::isspace((unsigned char)*p)) ++p;   // token 0
  while (*p && std::isspace((unsigned char)*p)) ++p;    // gap
  const char* tok1 = p;
  while (*p && !std::isspace((unsigned char)*p)) ++p;   // token 1
  if (std::memchr(tok1, ':', p - tok1) != nullptr) return 1;
  *delim = line.find('\t') != std::string::npos ? '\t' : ' ';
  return 0;
}

}  // namespace

LGBM_EXPORT int LGBM_BoosterPredictForFile(
    void* handle, const char* data_filename, int data_has_header,
    int predict_type, int start_iteration, int num_iteration,
    const char* parameter, const char* result_filename) {
  if (!handle || !data_filename || !result_filename)
    return Fail("null argument");
  // honored parameters: label_column=N (dense files carry the label at
  // column N, CLI convention; default 0) and no_label=true. Anything
  // else is rejected loudly — silently ignoring a reference parameter
  // would mis-map columns.
  long label_col = 0;
  bool has_label = true;
  if (parameter && *parameter) {
    std::istringstream ps(parameter);
    std::string tok;
    while (ps >> tok) {
      if (tok.rfind("label_column=", 0) == 0) {
        const char* v = tok.c_str() + 13;
        char* endp = nullptr;
        label_col = std::strtol(v, &endp, 10);
        if (endp == v || *endp != '\0' || label_col < 0)
          return Fail("label_column must be a column index (the "
                      "name: syntax needs the Python front end): "
                      + tok);
      } else if (tok == "no_label=true" || tok == "has_label=false") {
        has_label = false;
      } else {
        return Fail("unsupported predict parameter: " + tok);
      }
    }
  }
  auto* b = static_cast<CBooster*>(handle);
  int nfeat = b->max_feature_idx + 1;
  char delim = ',';
  int kind = SniffFormat(data_filename, data_has_header, &delim);
  if (kind < 0)
    return Fail(std::string("cannot read ") + data_filename);
  if (kind == 1 && data_has_header)
    return Fail("LibSVM files have no header line");
  double* X = nullptr;
  double* labels = nullptr;
  long rows = 0, cols = 0;
  int rc;
  if (kind == 1) {
    rc = ParseLibSVM(data_filename, &X, &labels, &rows, &cols);
  } else {
    rc = ParseDense(data_filename, delim, data_has_header ? 1 : 0,
                    &X, &rows, &cols);
  }
  if (rc != 0) {
    return Fail(std::string("cannot parse ") + data_filename);
  }
  // column accounting mirrors the Python predictor: dense files carry
  // the label column (stripped unconditionally unless no_label=true);
  // LibSVM files narrower than the model pad with zeros (sparse
  // semantics: absent means 0). ParseLibSVM already splits labels out.
  int64_t label_at = (kind == 0 && has_label) ? label_col : -1;
  if (label_at >= cols) {
    FreeBuffer(X);
    FreeBuffer(labels);
    return Fail("label_column is out of range for the data file");
  }
  int64_t data_cols = cols - (label_at >= 0 ? 1 : 0);
  if (kind == 0 && data_cols != nfeat) {
    FreeBuffer(X);
    FreeBuffer(labels);
    return Fail("the data file has a different number of features "
                "than the model (see no_label/label_column "
                "parameters)");
  }
  std::vector<double> row(nfeat, 0.0);
  int t0, t1;
  b->UsedRange(start_iteration, num_iteration, &t0, &t1);
  int64_t stride = PredictOutputLen(b, 1, predict_type, t0, t1);
  std::vector<double> out(stride);
  std::ofstream rf(result_filename);
  if (!rf) {
    FreeBuffer(X);
    FreeBuffer(labels);
    return Fail(std::string("cannot write ") + result_filename);
  }
  ShapContext scratch;
  char num[32];
  for (long r = 0; r < rows; ++r) {
    int64_t w = 0;
    for (int64_t c = 0; c < cols && w < nfeat; ++c) {
      if (c == label_at) continue;
      row[w++] = X[r * cols + c];
    }
    for (; w < nfeat; ++w)
      row[w] = (kind == 1) ? 0.0 : std::nan("");
    PredictRowInto(b, row.data(), nfeat, predict_type, t0, t1,
                   out.data(), &scratch);
    for (int64_t j = 0; j < stride; ++j) {
      std::snprintf(num, sizeof(num), "%.17g", out[j]);
      rf << (j ? "\t" : "") << num;
    }
    rf << "\n";
  }
  FreeBuffer(X);
  FreeBuffer(labels);
  rf.flush();
  if (!rf.good())
    return Fail(std::string("write failed: ") + result_filename);
  return 0;
}

// ---------------------------------------------------------------------
// JSON model dump (reference: c_api.cpp LGBM_BoosterDumpModel ->
// GBDT::DumpModel, gbdt_model_text.cpp:21-170) — same structure as the
// Python runtime's dump_model() so R/Java hosts parse one schema.
namespace {

void JsonNum(std::string* out, double v) {
  if (std::isfinite(v)) {
    char buf[32];
    std::snprintf(buf, sizeof(buf), "%.17g", v);
    *out += buf;
  } else {
    *out += v > 0 ? "\"inf\"" : (v < 0 ? "\"-inf\"" : "\"nan\"");
  }
}

void JsonStr(std::string* out, const std::string& s) {
  *out += '"';
  for (char c : s) {
    if (c == '"' || c == '\\') { *out += '\\'; *out += c; }
    else if ((unsigned char)c < 0x20) {
      char buf[8];
      std::snprintf(buf, sizeof(buf), "\\u%04x", c);
      *out += buf;
    } else *out += c;
  }
  *out += '"';
}

double TreeField(const std::vector<double>& a, int i) {
  return i < (int)a.size() ? a[i] : 0.0;
}

void AppendLinearLeaf(const CTree& t, int leaf, std::string* j) {
  *j += ",\"leaf_const\":";
  JsonNum(j, TreeField(t.leaf_const, leaf));
  *j += ",\"leaf_features\":[";
  const auto& feats = t.leaf_features[leaf];
  for (size_t i = 0; i < feats.size(); ++i) {
    if (i) *j += ",";
    *j += std::to_string(feats[i]);
  }
  *j += "],\"leaf_coeff\":[";
  const auto& coef = t.leaf_coeff[leaf];
  for (size_t i = 0; i < coef.size(); ++i) {
    if (i) *j += ",";
    JsonNum(j, coef[i]);
  }
  *j += "]";
}

void NodeToJson(const CTree& t, int index, std::string* out) {
  // iterative post-order with memoized child strings (chain trees can
  // be num_leaves-1 deep; mirror models/tree.py _node_to_json)
  std::map<int, std::string> memo;
  std::vector<int> order, stack{index};
  while (!stack.empty()) {
    int idx = stack.back();
    stack.pop_back();
    order.push_back(idx);
    if (idx >= 0) {
      stack.push_back(t.left_child[idx]);
      stack.push_back(t.right_child[idx]);
    }
  }
  for (auto it = order.rbegin(); it != order.rend(); ++it) {
    int idx = *it;
    std::string j;
    if (idx < 0) {
      int leaf = ~idx;
      j += "{\"leaf_index\":" + std::to_string(leaf) + ",\"leaf_value\":";
      JsonNum(&j, t.leaf_value[leaf]);
      j += ",\"leaf_weight\":";
      JsonNum(&j, TreeField(t.leaf_weight, leaf));
      j += ",\"leaf_count\":"
           + std::to_string((long long)TreeField(t.leaf_count, leaf));
      if (t.is_linear) AppendLinearLeaf(t, leaf, &j);
      j += "}";
    } else {
      int dt = t.decision_type[idx];
      j += "{\"split_index\":" + std::to_string(idx);
      j += ",\"split_feature\":" + std::to_string(t.split_feature[idx]);
      j += ",\"split_gain\":";
      JsonNum(&j, TreeField(t.split_gain, idx));
      j += ",\"threshold\":";
      if (dt & kCategoricalMask) {
        // expand the bitset back to "a||b||c" (reference NodeToJSON)
        int ci = t.threshold_in_bin[idx];
        std::string cats;
        int64_t lo = t.cat_boundaries[ci], hi = t.cat_boundaries[ci + 1];
        for (int64_t w = 0; w < hi - lo; ++w) {
          uint32_t word = t.cat_threshold[lo + w];
          for (int bit = 0; bit < 32; ++bit) {
            if ((word >> bit) & 1u) {
              if (!cats.empty()) cats += "||";
              cats += std::to_string(w * 32 + bit);
            }
          }
        }
        JsonStr(&j, cats);
        j += ",\"decision_type\":\"==\"";
      } else {
        JsonNum(&j, t.threshold[idx]);
        j += ",\"decision_type\":\"<=\"";
      }
      int missing = (dt >> 2) & 3;
      j += std::string(",\"default_left\":")
           + ((dt & kDefaultLeftMask) ? "true" : "false");
      j += std::string(",\"missing_type\":\"")
           + (missing == kMissingZero ? "Zero"
              : missing == kMissingNaN ? "NaN" : "None") + "\"";
      j += ",\"internal_value\":";
      JsonNum(&j, TreeField(t.internal_value, idx));
      j += ",\"internal_weight\":";
      JsonNum(&j, TreeField(t.internal_weight, idx));
      j += ",\"internal_count\":"
           + std::to_string((long long)TreeField(t.internal_count, idx));
      auto lit = memo.find(t.left_child[idx]);
      auto rit = memo.find(t.right_child[idx]);
      j += ",\"left_child\":" + std::move(lit->second);
      j += ",\"right_child\":" + std::move(rit->second);
      memo.erase(lit);
      memo.erase(rit);
      j += "}";
    }
    memo[idx] = std::move(j);
  }
  *out += memo[index];
}

}  // namespace

LGBM_EXPORT int LGBM_BoosterDumpModel(void* handle, int start_iteration,
                                      int num_iteration,
                                      int feature_importance_type,
                                      int64_t buffer_len,
                                      int64_t* out_len, char* out_str) {
  if (!handle || !out_len) return Fail("null argument");
  auto* b = static_cast<CBooster*>(handle);
  int t0, t1;
  b->UsedRange(start_iteration, num_iteration, &t0, &t1);
  std::string j = "{\"name\":\"tree\",\"version\":\"v3\"";
  j += ",\"num_class\":" + std::to_string(b->num_class);
  j += ",\"num_tree_per_iteration\":"
       + std::to_string(b->num_tree_per_iteration);
  j += ",\"label_index\":" + std::to_string(b->label_index);
  j += ",\"max_feature_idx\":" + std::to_string(b->max_feature_idx);
  if (!b->objective_str.empty()) {
    j += ",\"objective\":";
    JsonStr(&j, b->objective_str);
  }
  j += std::string(",\"average_output\":")
       + (b->average_output ? "true" : "false");
  j += ",\"feature_names\":[";
  for (size_t i = 0; i < b->feature_names.size(); ++i) {
    if (i) j += ",";
    JsonStr(&j, b->feature_names[i]);
  }
  j += "],\"feature_infos\":{";
  {
    bool first = true;
    for (size_t i = 0; i < b->feature_infos.size()
                       && i < b->feature_names.size(); ++i) {
      const std::string& info = b->feature_infos[i];
      if (info == "none") continue;
      if (!first) j += ",";
      first = false;
      JsonStr(&j, b->feature_names[i]);
      j += ":{\"min_value\":";
      if (!info.empty() && info.front() == '[') {
        auto colon = info.find(':');
        JsonNum(&j, std::atof(info.substr(1, colon - 1).c_str()));
        j += ",\"max_value\":";
        JsonNum(&j, std::atof(
            info.substr(colon + 1, info.size() - colon - 2).c_str()));
        j += ",\"values\":[]}";
      } else {
        // categorical: colon-separated category values
        std::vector<long> vals;
        std::istringstream vs(info);
        std::string tokv;
        while (std::getline(vs, tokv, ':'))
          vals.push_back(std::atol(tokv.c_str()));
        long mn = vals.empty() ? 0 : *std::min_element(vals.begin(),
                                                       vals.end());
        long mx = vals.empty() ? 0 : *std::max_element(vals.begin(),
                                                       vals.end());
        j += std::to_string(mn) + ",\"max_value\":"
             + std::to_string(mx) + ",\"values\":[";
        for (size_t vI = 0; vI < vals.size(); ++vI) {
          if (vI) j += ",";
          j += std::to_string(vals[vI]);
        }
        j += "]}";
      }
    }
  }
  j += "},\"monotone_constraints\":[";
  for (size_t i = 0; i < b->monotone_constraints.size(); ++i) {
    if (i) j += ",";
    j += std::to_string(b->monotone_constraints[i]);
  }
  j += "],\"tree_info\":[";
  for (int i = t0; i < t1; ++i) {
    if (i > t0) j += ",";
    const CTree& t = b->trees[i];
    j += "{\"tree_index\":" + std::to_string(i - t0);
    j += ",\"num_leaves\":" + std::to_string(t.num_leaves);
    j += ",\"num_cat\":"
         + std::to_string((long long)(t.cat_boundaries.empty()
                                      ? 0 : t.cat_boundaries.size() - 1));
    j += ",\"shrinkage\":";
    JsonNum(&j, t.shrinkage);
    j += ",\"tree_structure\":";
    if (t.num_leaves == 1) {
      j += "{\"leaf_value\":";
      JsonNum(&j, t.leaf_value.empty() ? 0.0 : t.leaf_value[0]);
      if (t.is_linear) AppendLinearLeaf(t, 0, &j);
      j += "}";
    } else {
      NodeToJson(t, 0, &j);
    }
    j += "}";
  }
  j += "],\"feature_importances\":{";
  {
    int nfeat = b->max_feature_idx + 1;
    std::vector<double> imp(nfeat, 0.0);
    // the Python runtime and the reference count from tree 0 through
    // the last used iteration regardless of start_iteration
    for (int i = 0; i < t1; ++i) {
      const CTree& t = b->trees[i];
      for (int k = 0; k < t.num_leaves - 1; ++k) {
        if (t.split_feature[k] < nfeat) {
          imp[t.split_feature[k]] +=
              feature_importance_type == 1
                  ? std::max(TreeField(t.split_gain, k), 0.0)
                  : 1.0;
        }
      }
    }
    bool first = true;
    for (int f = 0; f < nfeat && f < (int)b->feature_names.size(); ++f) {
      if (imp[f] <= 0) continue;
      if (!first) j += ",";
      first = false;
      JsonStr(&j, b->feature_names[f]);
      j += ":";
      if (feature_importance_type == 1) JsonNum(&j, imp[f]);
      else j += std::to_string((long long)imp[f]);
    }
  }
  j += "}}";
  *out_len = static_cast<int64_t>(j.size()) + 1;
  if (out_str && buffer_len >= *out_len)
    std::memcpy(out_str, j.c_str(), *out_len);
  return 0;
}
