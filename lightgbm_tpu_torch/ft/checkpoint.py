"""Crash-consistent checkpoint/resume for training runs.

Port of ``lightgbm_tpu/ft/checkpoint.py`` (format v2: the same manifest,
state keys and files, so a checkpoint directory reads the same in both
packages). A checkpoint is a DIRECTORY (``ckpt-<iter>/`` under the
caller's checkpoint dir) finalized atomically: every file is written and
fsynced inside a hidden temp directory, a ``manifest.json`` carrying
per-file sha256 + byte counts is written LAST, and one ``os.rename``
publishes the whole thing. A crash at any instruction leaves either the
previous checkpoints untouched or a ``.ckpt-tmp-*`` directory the loader
never looks at. The loader walks checkpoints newest-first and takes the
first one whose manifest hashes verify; a truncated or poisoned
checkpoint is skipped LOUDLY (``checkpoint_invalid`` event, warning
naming the file) and the run falls back to the previous one.

Resume is BIT-IDENTICAL by construction: the state file captures every
stochastic sequence position the training loop consumes

- bagging / GOSS draws are stateless (``fold_in`` of the iteration,
  boosting/sample_strategy.py): only the draw type is recorded, so a
  config mismatch fails loudly;
- the learner's feature-fraction ``RandomState`` and tree counter (the
  extra_trees keys derive from it);
- the quantizer's tree counter (the stochastic-rounding key of tree n
  is ``fold_in(base, n)``);
- DART's drop RNG, per-tree weights and weight sum;
- a stochastic objective's key (rank_xendcg);

and the training scores are stored as exact f32 bits (``score.npy``),
read off the card once per checkpoint, rather than recomputed — an
incremental score is a specific SEQUENCE of f32 additions that a replay
of the saved trees cannot reproduce bit for bit in general. On load,
``GBDT.recheck_scores`` re-derives the scores from the trees on the
device and the checkpoint is rejected if the stored bits deviate beyond
the f32 replay tolerance. A resumed learner is a new one, or drops its
captured CUDA graph: the graph holds pointers into the old learner's
buffers, so the first step after a resume captures again.

The engine-level ``early_stopping`` callback's closure state (best
score/iter per metric) is captured too, via the
``gbdt._engine_state_provider`` hook ``lgb.train`` installs: resume
continues the SAME patience window instead of re-arming it. The state
file's ``early_stop`` section holds the GBDT's own trackers, which the
port's GBDT does not keep (the JAX package's command-line loop fills
them): it is written with empty lists, so the keys stay the format's.

NOT captured (refused, as in the JAX package): CEGB's cross-tree device
state, multi-process runs, and the dataset itself — the caller bins the
same rows again (deterministic mappers rebuild the same dataset).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import List, Optional, Tuple

import numpy as np

import torch

from ..obs import events as obs_events
from ..obs import faults
from ..obs.registry import registry as obs
from ..utils import log
from ..utils.atomic import fsync_dir, sha256_file as _sha256_file
from ..utils.retry import retry_call

# v2: bagging/GOSS became stateless device draws (pipelined boosting) —
# v1 checkpoints carry a host-MT19937 bagging stream position that the
# fold_in keying cannot continue, so the loader refuses them loudly
FORMAT_VERSION = 2
CKPT_PREFIX = "ckpt-"
TMP_PREFIX = ".ckpt-tmp-"
_ENV_KEEP = "LIGHTGBM_TPU_CKPT_KEEP"

REQUIRED_FILES = ("state.json", "model.txt", "score.npy")


class CheckpointError(Exception):
    """One checkpoint directory failed validation (the loader falls
    back to the next-older candidate)."""


# ----------------------------------------------------------------------
# small codecs
# ----------------------------------------------------------------------

def _np_rng_to_json(rng: np.random.RandomState) -> dict:
    name, keys, pos, has_gauss, cached = rng.get_state()
    return {"name": name, "keys": np.asarray(keys).tolist(),
            "pos": int(pos), "has_gauss": int(has_gauss),
            "cached_gaussian": float(cached)}


def _np_rng_from_json(d: dict) -> Tuple:
    return (d["name"], np.asarray(d["keys"], dtype=np.uint32),
            int(d["pos"]), int(d["has_gauss"]),
            float(d["cached_gaussian"]))


def _key_to_json(key) -> Optional[list]:
    """A key of ``utils/prng.py`` (an int64 tensor of uint32 words) as a
    plain list of words (None when absent): one read per checkpoint."""
    if not isinstance(key, torch.Tensor):
        return None
    return [int(v) & 0xFFFFFFFF for v in key.cpu().reshape(-1).tolist()]


def _key_from_json(words: list, device) -> torch.Tensor:
    return torch.tensor([int(v) for v in words], dtype=torch.int64,
                        device=device)


# ----------------------------------------------------------------------
# directory scanning / validation
# ----------------------------------------------------------------------

def list_checkpoints(directory: str) -> List[Tuple[int, str]]:
    """(iter, path) of every finalized checkpoint, newest first."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        if not name.startswith(CKPT_PREFIX):
            continue
        try:
            it = int(name[len(CKPT_PREFIX):])
        except ValueError:
            continue
        out.append((it, os.path.join(directory, name)))
    out.sort(reverse=True)
    return out


def validate_dir(path: str) -> dict:
    """Verify a checkpoint directory against its manifest (presence,
    sizes, sha256 of every listed file); returns the manifest or raises
    :class:`CheckpointError` naming the first offending file."""
    man_path = os.path.join(path, "manifest.json")
    try:
        with open(man_path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointError("unreadable manifest %s (%s)"
                              % (man_path, e))
    files = manifest.get("files")
    if not isinstance(files, dict):
        raise CheckpointError("manifest %s has no file table" % man_path)
    for req in REQUIRED_FILES:
        if req not in files:
            raise CheckpointError("manifest %s is missing required "
                                  "entry %r" % (man_path, req))
    for name, meta in files.items():
        fp = os.path.join(path, name)
        try:
            size = os.path.getsize(fp)
        except OSError:
            raise CheckpointError("checkpoint file %s is missing" % fp)
        if size != int(meta.get("bytes", -1)):
            raise CheckpointError(
                "checkpoint file %s is truncated (%d bytes, manifest "
                "says %d)" % (fp, size, int(meta.get("bytes", -1))))
        if _sha256_file(fp) != meta.get("sha256"):
            raise CheckpointError(
                "checkpoint file %s fails its content hash" % fp)
    return manifest


# ----------------------------------------------------------------------
# state capture
# ----------------------------------------------------------------------

def _strategy_state(gbdt) -> Tuple[dict, Optional[np.ndarray]]:
    """Sampler draws are stateless (fold_in on the iteration index —
    sample_strategy.py), so only the TYPE is recorded: resume recomputes
    the exact in-bag vector from (bagging_seed, iter); what must fail
    loudly is resuming a bagging checkpoint under a bagging-free config
    (the score bits would silently diverge from the draw sequence)."""
    from ..boosting.sample_strategy import BaggingStrategy, GOSSStrategy
    st = getattr(gbdt, "sample_strategy", None)
    if isinstance(st, BaggingStrategy):
        return {"type": "bagging"}, None
    if isinstance(st, GOSSStrategy):
        return {"type": "goss"}, None
    return {"type": "none"}, None


def _learner_state(gbdt) -> dict:
    learner = getattr(gbdt, "learner", None)
    if learner is None:
        return {}
    out = {"tree_idx": int(getattr(learner, "_tree_idx", 0))}
    ff = getattr(learner, "_ff_rng", None)
    if ff is not None:
        out["ff_rng"] = _np_rng_to_json(ff)
    if getattr(learner, "_quantized", False):
        out["quant_ctr"] = int(getattr(learner, "_quant_ctr", 0))
    return out


def _dart_state(gbdt) -> Optional[dict]:
    from ..boosting.dart import DART
    if not isinstance(gbdt, DART):
        return None
    return {"drop_rng": _np_rng_to_json(gbdt.drop_rng),
            "tree_weight": [float(w) for w in gbdt.tree_weight],
            "sum_weight": float(gbdt.sum_weight)}


def _objective_state(gbdt) -> dict:
    obj = getattr(gbdt, "objective", None)
    key = getattr(obj, "_key", None) if obj is not None else None
    words = _key_to_json(key)
    return {"key": words} if words is not None else {}


def _config_fingerprint(gbdt) -> str:
    return hashlib.sha256(
        gbdt.config.to_param_string().encode()).hexdigest()


def _refuse_unsupported(gbdt) -> None:
    learner = getattr(gbdt, "learner", None)
    if getattr(learner, "_cegb_enabled", False):
        log.fatal("checkpointing does not capture CEGB's cross-tree "
                  "device state (used-feature/fetched matrices); "
                  "disable cegb_* to checkpoint this run")
    dist = torch.distributed
    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        log.fatal("checkpoint/resume is single-process; "
                  "multi-process dtrain runs are not supported")


# ----------------------------------------------------------------------
# save
# ----------------------------------------------------------------------

def save(gbdt, directory: str, keep: Optional[int] = None) -> str:
    """Write one atomically-finalized checkpoint of ``gbdt`` under
    ``directory``; returns the finalized path. Idempotent per
    iteration: an existing VALID ``ckpt-<iter>`` is kept as-is."""
    _refuse_unsupported(gbdt)
    directory = str(directory)
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, "%s%08d" % (CKPT_PREFIX, gbdt.iter))
    if os.path.isdir(final):
        try:
            validate_dir(final)
            return final
        except CheckpointError as e:
            log.warning_always("replacing corrupt checkpoint %s (%s)"
                               % (final, e))
            shutil.rmtree(final, ignore_errors=True)

    with obs.scope("ft::checkpoint_save"):
        strategy, bag = _strategy_state(gbdt)
        state = {
            "format_version": FORMAT_VERSION,
            "iter": int(gbdt.iter),
            "num_init_iteration": int(gbdt.num_init_iteration),
            "best_iteration": int(gbdt.best_iteration),
            "num_class": int(gbdt.num_class),
            "num_tree_per_iteration": int(gbdt.num_tree_per_iteration),
            "num_models": len(gbdt.models),
            "boosting": type(gbdt).__name__,
            "has_init_score": bool(getattr(gbdt, "_has_init_score",
                                           False)),
            "config_fingerprint": _config_fingerprint(gbdt),
            "data_fingerprint": {
                "num_data": int(gbdt.train_data.num_data),
                "num_features": int(gbdt.train_data.num_features),
                "max_num_bin": int(gbdt.train_data.max_num_bin)},
            "early_stop": {"best_score": getattr(gbdt, "_best_score",
                                                 []),
                           "best_iter": getattr(gbdt, "_best_iter", []),
                           "best_msg": getattr(gbdt, "_best_msg", [])},
            "strategy": strategy,
            "learner": _learner_state(gbdt),
            "objective": _objective_state(gbdt),
        }
        dart = _dart_state(gbdt)
        if dart is not None:
            state["dart"] = dart
        # engine-level callback state (early_stopping closure): the
        # engine installs a provider returning a JSON-able dict; GBDT
        # API users without one simply skip the section
        provider = getattr(gbdt, "_engine_state_provider", None)
        if provider is not None:
            try:
                engine_state = provider()
            except Exception as e:  # noqa: BLE001 — a state provider
                #                     bug must not void the checkpoint
                log.warning("checkpoint: engine state provider failed "
                            "(%r); callback state not captured" % (e,))
                engine_state = None
            if engine_state:
                state["engine"] = engine_state
        model_text = gbdt.save_model_to_string()
        # deliberate host read: the score bits leave the device exactly
        # once per checkpoint interval, never per iteration
        score = gbdt.train_score.cpu().numpy().astype(np.float32)
        # data/model-quality baseline (obs/quality.py): when the
        # booster carries a training-grid reference profile, stamp the
        # prediction-score histogram from the same train_score read and
        # persist the whole profile next to the required files (extra,
        # optional — REQUIRED_FILES is unchanged, old checkpoints load)
        profile_json = None
        profile = getattr(gbdt, "quality_profile", None)
        if profile is not None:
            try:
                profile.attach_scores(
                    score, objective=getattr(gbdt, "objective", None))
                profile_json = json.dumps(profile.to_dict()).encode()
            except Exception as e:  # noqa: BLE001 — a profile bug must
                #                     not void the checkpoint
                log.warning("checkpoint: quality profile not captured "
                            "(%r)" % (e,))

        tmp = os.path.join(directory, "%s%08d-%d"
                           % (TMP_PREFIX, gbdt.iter, os.getpid()))

        def _write_and_finalize() -> None:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            _write_file(tmp, "model.txt", model_text.encode())
            np.save(os.path.join(tmp, "score.npy"), score)
            _fsync_file(os.path.join(tmp, "score.npy"))
            if bag is not None:
                np.save(os.path.join(tmp, "bag.npy"), bag)
                _fsync_file(os.path.join(tmp, "bag.npy"))
            if profile_json is not None:
                _write_file(tmp, "quality_profile.json", profile_json)
            _write_file(tmp, "state.json",
                        json.dumps(state, indent=1).encode())
            files = {}
            for name in sorted(os.listdir(tmp)):
                fp = os.path.join(tmp, name)
                files[name] = {"sha256": _sha256_file(fp),
                               "bytes": os.path.getsize(fp)}
            manifest = {"format_version": FORMAT_VERSION,
                        "iter": int(gbdt.iter),
                        "created": round(time.time(), 3),
                        "files": files}
            _write_file(tmp, "manifest.json",
                        json.dumps(manifest, indent=1).encode())
            fsync_dir(tmp)
            faults.check("checkpoint_finalize", path=final)
            os.rename(tmp, final)
            fsync_dir(directory)

        try:
            retry_call(_write_and_finalize, site="checkpoint_finalize")
        except OSError as e:
            shutil.rmtree(tmp, ignore_errors=True)
            # log.fatal flushes the event buffer + trace spool: the
            # failure evidence lands before the raise
            log.fatal("checkpoint at iteration %d could not be "
                      "finalized under %s: %r"
                      % (gbdt.iter, directory, e))
    obs.inc("ft/checkpoints_saved")
    obs_events.emit("checkpoint_saved", iter=gbdt.iter, path=final,
                    trees=len(gbdt.models))
    obs_events.flush()
    _prune(directory, keep)
    return final


def _write_file(dirpath: str, name: str, data: bytes) -> None:
    fp = os.path.join(dirpath, name)
    with open(fp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _fsync_file(fp: str) -> None:
    fd = os.open(fp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _prune(directory: str, keep: Optional[int]) -> None:
    """Drop all but the newest ``keep`` checkpoints
    (``LIGHTGBM_TPU_CKPT_KEEP``, default 3; 0 keeps everything) plus
    any stale temp directories from dead runs."""
    if keep is None:
        try:
            keep = int(os.environ.get(_ENV_KEEP, 3))
        except ValueError:
            keep = 3
    try:
        for name in os.listdir(directory):
            if name.startswith(TMP_PREFIX):
                p = os.path.join(directory, name)
                try:
                    pid = int(name.rsplit("-", 1)[-1])
                except ValueError:
                    pid = -1
                if pid != os.getpid():
                    shutil.rmtree(p, ignore_errors=True)
    except OSError:
        pass
    if keep <= 0:
        return
    for _, path in list_checkpoints(directory)[keep:]:
        shutil.rmtree(path, ignore_errors=True)


# ----------------------------------------------------------------------
# load / resume
# ----------------------------------------------------------------------

def _parse_model_trees(s: str) -> list:
    """Tree blocks out of a v3 model text via the SHARED framing
    parser (models/tree.py parse_tree_blocks — the same code
    ``GBDT.load_model_from_string`` runs, minus the header handling
    that would clobber a live training booster's objective/metadata)."""
    from ..models.tree import parse_tree_blocks
    return parse_tree_blocks(s)


def _restore_strategy(gbdt, state: dict, path: str) -> None:
    """Type check only — the draws themselves are stateless (fold_in on
    the iteration index), so the resumed run's first ``bagging`` call at
    iteration *i* recomputes the exact indicator the uninterrupted run
    was using (including mid-``bagging_freq``-window resumes)."""
    from ..boosting.sample_strategy import BaggingStrategy, GOSSStrategy
    spec = state.get("strategy", {"type": "none"})
    st = getattr(gbdt, "sample_strategy", None)
    kind = spec.get("type", "none")
    if kind == "bagging" and not isinstance(st, BaggingStrategy):
        log.fatal("checkpoint %s was written by a bagging run but "
                  "the resuming config has no bagging" % path)
    if kind == "goss" and not isinstance(st, GOSSStrategy):
        log.fatal("checkpoint %s was written by a GOSS run but the "
                  "resuming config has no GOSS" % path)


def _restore_learner(gbdt, state: dict) -> None:
    learner = getattr(gbdt, "learner", None)
    spec = state.get("learner", {})
    if learner is None or not spec:
        return
    learner._tree_idx = int(spec.get("tree_idx", 0))
    if "ff_rng" in spec and getattr(learner, "_ff_rng", None) is not None:
        learner._ff_rng.set_state(_np_rng_from_json(spec["ff_rng"]))
    if "quant_ctr" in spec and getattr(learner, "_quantized", False):
        # the fold-in counter continues the sequence exactly: tree
        # n+1's stochastic-rounding key is fold_in(base, n+1) in both
        # the interrupted and the uninterrupted run
        learner._quant_ctr = int(spec["quant_ctr"])
    # the captured step holds pointers into the learner's buffers:
    # the first step after a resume captures again
    learner._graph = None
    learner._fused = None


def _restore_dart(gbdt, state: dict) -> None:
    spec = state.get("dart")
    if spec is None:
        return
    from ..boosting.dart import DART
    if not isinstance(gbdt, DART):
        log.fatal("checkpoint carries DART state but the resuming "
                  "booster is %s" % type(gbdt).__name__)
    gbdt.drop_rng.set_state(_np_rng_from_json(spec["drop_rng"]))
    gbdt.tree_weight = [float(w) for w in spec["tree_weight"]]
    gbdt.sum_weight = float(spec["sum_weight"])


def _restore_objective(gbdt, state: dict) -> None:
    spec = state.get("objective", {})
    obj = getattr(gbdt, "objective", None)
    if obj is not None and spec.get("key") is not None \
            and isinstance(getattr(obj, "_key", None), torch.Tensor):
        obj._key = _key_from_json(spec["key"], obj._key.device)


def restore_early_stop(gbdt, state: dict) -> None:
    """Re-apply the per-(valid set, metric) early-stop trackers; a
    no-op (with a warning) when the resumed run registered a different
    number of valid sets."""
    es = state.get("early_stop", {})
    best_score = es.get("best_score", [])
    if not hasattr(gbdt, "_best_score"):
        return
    if len(best_score) != len(gbdt._best_score):
        if best_score:
            log.warning("checkpoint early-stop state covers %d valid "
                        "sets, run has %d; early-stop counters start "
                        "fresh" % (len(best_score),
                                   len(gbdt._best_score)))
        return
    gbdt._best_score = [list(v) for v in best_score]
    gbdt._best_iter = [list(v) for v in es.get("best_iter", [])]
    gbdt._best_msg = [list(v) for v in es.get("best_msg", [])]


def load_latest(gbdt, directory: str) -> Optional[dict]:
    """Restore ``gbdt`` from the newest VALID checkpoint under
    ``directory``; returns the state dict (or None when no valid
    checkpoint exists — the caller trains from scratch). Invalid
    candidates are skipped loudly, newest-first."""
    for it, path in list_checkpoints(directory):
        try:
            validate_dir(path)
        except CheckpointError as e:
            obs.inc("ft/checkpoints_rejected")
            obs_events.emit("checkpoint_invalid", path=path,
                            reason=str(e))
            obs_events.flush()
            log.warning_always("skipping corrupt checkpoint %s: %s"
                               % (path, e))
            continue
        with obs.scope("ft::checkpoint_load"):
            with open(os.path.join(path, "state.json")) as f:
                state = json.load(f)
            if int(state.get("format_version", -1)) != FORMAT_VERSION:
                log.warning_always(
                    "skipping checkpoint %s: format version %s (this "
                    "build reads %d)" % (path,
                                         state.get("format_version"),
                                         FORMAT_VERSION))
                continue
            fp = state.get("data_fingerprint", {})
            if (int(fp.get("num_data", -1)) != gbdt.train_data.num_data
                    or int(fp.get("num_features", -1))
                    != gbdt.train_data.num_features):
                log.fatal("checkpoint %s was written against a "
                          "different dataset (%s rows x %s features; "
                          "this run has %d x %d)"
                          % (path, fp.get("num_data"),
                             fp.get("num_features"),
                             gbdt.train_data.num_data,
                             gbdt.train_data.num_features))
            if state.get("config_fingerprint") \
                    != _config_fingerprint(gbdt):
                log.warning("resuming %s under a different parameter "
                            "set; resumed results are only guaranteed "
                            "bit-identical under the original "
                            "parameters" % path)
            if state.get("boosting") != type(gbdt).__name__:
                log.fatal("checkpoint %s was written by a %s booster, "
                          "resuming as %s" % (path, state.get(
                              "boosting"), type(gbdt).__name__))

            with open(os.path.join(path, "model.txt")) as f:
                model_text = f.read()
            gbdt.models = _parse_model_trees(model_text)
            if len(gbdt.models) != int(state.get("num_models", -1)):
                log.fatal("checkpoint %s: parsed %d trees, state "
                          "records %d" % (path, len(gbdt.models),
                                          state.get("num_models")))
            gbdt.align_trees_to_dataset(gbdt.train_data)
            gbdt.iter = int(state["iter"])
            gbdt.num_init_iteration = int(state["num_init_iteration"])
            gbdt.best_iteration = int(state["best_iteration"])
            gbdt._has_init_score = bool(state.get("has_init_score",
                                                  False))

            score = np.load(os.path.join(path, "score.npy"))
            K = gbdt.num_tree_per_iteration
            if score.shape != (gbdt.train_data.num_data, K):
                log.fatal("checkpoint %s: score shape %s does not "
                          "match [%d, %d]" % (path, score.shape,
                                              gbdt.train_data.num_data,
                                              K))
            gbdt.train_score = torch.from_numpy(score).to(gbdt.device)
            gbdt._valid_pending = []

            # reload the quality baseline when the checkpoint carries
            # one (optional file; pre-quality-plane checkpoints simply
            # resume without a drift reference)
            qp_path = os.path.join(path, "quality_profile.json")
            if os.path.exists(qp_path):
                from ..obs import quality as obs_quality
                try:
                    gbdt.quality_profile = \
                        obs_quality.ReferenceProfile.load(qp_path)
                except (OSError, KeyError, TypeError, ValueError) as e:
                    log.warning_always("checkpoint %s: unreadable "
                                       "quality_profile.json (%r); "
                                       "resuming without a drift "
                                       "baseline" % (path, e))

            _restore_strategy(gbdt, state, path)
            _restore_learner(gbdt, state)
            _restore_dart(gbdt, state)
            _restore_objective(gbdt, state)
            restore_early_stop(gbdt, state)

            # replay any valid sets that were registered BEFORE the
            # load (the engine loads first, then registers — but the
            # GBDT-level API must work in either order)
            for vd in gbdt.valid_data:
                for i, tree in enumerate(gbdt.models):
                    vd.add_tree(tree, i % K, gbdt._bin_meta)

            # score verification: re-derive the training scores from
            # the restored trees via the existing device replay and
            # compare against the stored bits — a checkpoint whose
            # score and trees disagree (corruption that preserved the
            # hashes, or a subtly different dataset) must not resume.
            # A sharded dataset replays shard by shard as its shards
            # stage (the JAX package skips the check there)
            diff = gbdt.recheck_scores(reason="checkpoint_resume")
            scale = max(float(np.max(np.abs(score))), 1.0)
            if diff > 1e-3 * scale:
                log.fatal("checkpoint %s: stored training scores "
                          "deviate from the device replay of its "
                          "own trees by %.3g — refusing to resume"
                          % (path, diff))
        obs.inc("ft/checkpoints_resumed")
        obs_events.emit("checkpoint_resumed", path=path, iter=gbdt.iter,
                        trees=len(gbdt.models), score_replay="ok",
                        score_replay_max_abs_diff=round(float(diff), 9))
        obs_events.flush()
        log.info("resumed from checkpoint %s (iteration %d, %d trees)"
                 % (path, gbdt.iter, len(gbdt.models)))
        return state
    return None
