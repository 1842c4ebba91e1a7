"""CLI application: train / predict / refit / convert_model / save_binary
over config files.

Port of ``lightgbm_tpu/application.py``, the equivalent of the
reference's ``Application`` (reference: src/application/application.cpp
- LoadParameters at :50, LoadData at :88, InitTrain at :167, Train at
:209, Predict at :221; ``main`` at src/main.cpp:11). It takes the same
``key=value`` arguments and config files, including
``config=train.conf``:

    python -m lightgbm_tpu_torch.application config=train.conf

Every task runs on the card unless the arguments say
``device_type=cpu``; without a visible card it raises, as ``lgb.train``
does. ``num_machines`` > 1 with ``task=train`` trains one rank of a
``torch.distributed`` group per machine of the machine list
(:func:`_distributed_train`).
"""
from __future__ import annotations

import os
import socket
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .basic import Booster, Dataset
from .config import Config, resolve_device
from .utils import log


def parse_args(argv: List[str]) -> Dict[str, str]:
    """key=value args + optional config file (reference:
    Application::LoadParameters, application.cpp:50-86: command line takes
    precedence over config file, first value wins per source)."""
    cli: Dict[str, str] = {}
    for arg in argv:
        if "=" not in arg:
            log.warning("Unknown argument: %s" % arg)
            continue
        k, v = arg.split("=", 1)
        k = k.strip().lstrip("-")
        if k not in cli:
            cli[k] = v.strip().strip('"').strip("'")
    params: Dict[str, str] = {}
    conf_path = cli.get("config", cli.get("config_file", ""))
    if conf_path:
        with open(conf_path) as fh:
            for line in fh:
                line = line.split("#", 1)[0].strip()
                if not line or "=" not in line:
                    continue
                k, v = line.split("=", 1)
                k, v = k.strip(), v.strip().strip('"').strip("'")
                if k not in params:
                    params[k] = v
    params.update(cli)  # CLI wins
    return params


def _load_tabular(path: str, config: Config):
    """Load CSV/TSV/LibSVM text data (reference: Parser::CreateParser
    auto-detection, src/io/parser.cpp; label column conventions of
    config.h:691) through the native parser (``native/``). A file the
    parser declines (a ragged row) is read with NumPy, which names the
    bad line."""
    with open(path) as f:
        first = f.readline().rstrip("\n")
    delim = "\t" if "\t" in first else ","
    tokens = first.split(delim)
    is_libsvm = all(":" in t for t in tokens[1:2]) and ":" in first
    has_header = bool(config.header)
    if is_libsvm:
        from .native import parse_libsvm
        parsed = parse_libsvm(path)
        if parsed is not None:
            return parsed[0], parsed[1], None, None
        rows, labels = [], []
        max_idx = -1
        with open(path) as fh:
            for line in fh:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                feats = {}
                for kv in parts[1:]:
                    i, v = kv.split(":")
                    feats[int(i)] = float(v)
                    max_idx = max(max_idx, int(i))
                rows.append(feats)
        X = np.zeros((len(rows), max_idx + 1))
        for r, feats in enumerate(rows):
            for i, v in feats.items():
                X[r, i] = v
        return X, np.asarray(labels), None, None
    from .native import parse_dense
    data = parse_dense(path, delim, 1 if has_header else 0)
    if data is None:
        data = np.genfromtxt(path, delimiter=delim,
                             skip_header=1 if has_header else 0)
    if data.ndim == 1:
        data = data.reshape(1, -1)
    label_col = 0
    lc = str(config.label_column)
    if lc.startswith("name:"):
        label_col = first.split(delim).index(lc[5:])
    elif lc not in ("", "0"):
        label_col = int(lc)
    y = data[:, label_col]
    X = np.delete(data, label_col, axis=1)
    weights = None
    group = None
    drop: List[int] = []
    wc = str(config.weight_column)
    if wc:
        if wc.startswith("name:"):
            log.warning("weight_column by name needs a header-aware "
                        "loader; IGNORED (use a column index)")
        else:
            # weight column index is post-label-removal per reference docs
            widx = int(wc)
            weights = X[:, widx]
            drop.append(widx)
    gc = str(config.group_column or "")
    if gc.startswith("name:"):
        log.warning("group_column by name needs a header-aware loader; "
                    "IGNORED (use a column index)")
    elif gc:
        # group column holds per-row query ids; contiguous runs become
        # query sizes (reference: Metadata group_column semantics)
        gidx = int(gc)
        qid = X[:, gidx]
        change = np.nonzero(np.diff(qid) != 0)[0] + 1
        bounds = np.concatenate([[0], change, [len(qid)]])
        group = np.diff(bounds).astype(np.int32)
        drop.append(gidx)
    for col in str(config.ignore_column or "").split(","):
        col = col.strip()
        if col.startswith("name:"):
            log.warning("ignore_column by name needs a header-aware "
                        "loader; IGNORED (use column indices)")
        elif col:
            drop.append(int(col))
    if drop:
        X = np.delete(X, sorted(set(drop)), axis=1)
    return X, y, weights, group


def _sidecar(data_path: str, kind: str):
    """Auto-load ``<data>.query`` / ``<data>.weight`` sidecar files
    (reference: Metadata::Init reads query/weight files next to the data
    file, src/io/metadata.cpp: LoadQueryBoundaries/LoadWeights)."""
    path = data_path + "." + kind
    if not os.path.exists(path):
        return None
    vals = np.atleast_1d(np.loadtxt(path))
    return vals.astype(np.int32) if kind == "query" else vals


def _load_with_sidecars(path: str, config: Config):
    X, y, w, g = _load_tabular(path, config)
    g = g if g is not None else _sidecar(path, "query")
    w = w if w is not None else _sidecar(path, "weight")
    return X, y, w, g


def _machine_list(config) -> List[str]:
    """Resolve the cluster machine list (reference: Config::Set reads
    ``machines`` or ``machine_list_filename``,
    src/network/linkers_socket.cpp:81)."""
    if config.machines:
        return [m.strip() for m in str(config.machines).split(",")
                if m.strip()]
    if config.machine_list_filename:
        with open(config.machine_list_filename) as f:
            return [ln.strip().replace(" ", ":") for ln in f
                    if ln.strip()]
    return []


def _ip_is_local(ip: str) -> bool:
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.bind((ip, 0))     # binds only to locally-owned IPs
        return True
    except OSError:
        return False


def _resolve_rank(config) -> Tuple[int, List[Tuple[str, int]], List[int]]:
    """This machine's rank, the machine list as (ip, port) and the ranks
    of the entries on this host. Rank resolution mirrors the socket
    linker: each machine appears in the shared machine list and is found
    by a local IP (linkers_socket.cpp:166); among local entries (every
    entry, on a single-host fake cluster, the shape of the reference's
    own tests/distributed/_test_distributed.py) ``local_listen_port``
    disambiguates."""
    machines = _machine_list(config)
    if len(machines) != config.num_machines:
        log.fatal("num_machines=%d but the machine list has %d entries"
                  % (config.num_machines, len(machines)))
    port = int(config.local_listen_port)
    entries = []
    for m in machines:
        ip, sep, p = m.rpartition(":")
        if not sep or not p.isdigit():
            log.fatal("machine list entry '%s' is not ip:port (or "
                      "'ip port' in the list file)" % m)
        entries.append((ip, int(p)))
    on_host = [i for i, (ip, _) in enumerate(entries) if _ip_is_local(ip)]
    local = on_host
    if len(local) > 1:
        local = [i for i in local if entries[i][1] == port]
    if len(local) != 1:
        log.fatal("cannot identify this machine in machines=%s (local "
                  "IP match%s); check the list and local_listen_port=%d"
                  % (",".join(machines),
                     " + port" if local == [] else " ambiguous", port))
    return local[0], entries, on_host


def _backend(config, ranks_on_host: int) -> Tuple[str, str]:
    """The process group's backend and why, decided once by the layout
    (never a retry after a failure): gloo for CPU ranks; NCCL when each
    rank on this host has a card of its own; gloo when ranks on this
    host share a card (NCCL refuses two ranks on one card, gloo stages
    the card's tensors through the host)."""
    if config.device_type == "cpu":
        return "gloo", "device_type=cpu"
    import torch
    cards = torch.cuda.device_count()
    if ranks_on_host <= cards:
        return "nccl", ("each of the %d rank(s) on this host has its own "
                        "card (%d visible)" % (ranks_on_host, cards))
    return "gloo", ("%d ranks on this host share %d card(s); NCCL refuses "
                    "two ranks on one card" % (ranks_on_host, cards))


def _distributed_train(config, params) -> int:
    """CLI multi-machine training (reference: Application::Application
    calls Network::Init when num_machines > 1,
    src/application/application.cpp:46 + config.h network section):
    one rank of a ``torch.distributed`` group whose store listens at the
    first machine's ip:port, then ``parallel.dtrain.train`` over this
    machine's rows. ``pre_partition=false`` (a shared data file) keeps
    the rank-strided rows ``rank::num_machines``."""
    import torch.distributed
    rank, entries, on_host = _resolve_rank(config)
    if config.valid:
        log.warning("valid_data is not evaluated by the distributed CLI "
                    "path yet; train metrics only")
    if config.input_model:
        log.warning("input_model (continued training) is not supported "
                    "by the distributed CLI path; training from scratch")
    backend, why = _backend(config, len(on_host))
    log.info("distributed CLI: rank %d of %d over %s (%s)"
             % (rank, config.num_machines, backend, why))
    if backend == "nccl":
        # the rank's card among this host's ranks (distributed.rank_device)
        os.environ.setdefault("LOCAL_RANK", str(on_host.index(rank)))
    from .parallel import distributed as dist_mod
    from .parallel import dtrain
    dist_mod.initialize(coordinator_address="%s:%d" % entries[0],
                        num_processes=int(config.num_machines),
                        process_id=rank, backend=backend)
    try:
        X, y, w, g = _load_with_sidecars(config.data, config)
        if not config.pre_partition:
            # a shared data file: every machine keeps its rank-strided
            # rows (reference: pre_partition=false row filtering,
            # dataset_loader.cpp:240)
            if g is not None:
                log.fatal("pre_partition=false cannot row-stride grouped "
                          "(ranking) data; pre-partition query files per "
                          "machine")
            sel = slice(rank, None, int(config.num_machines))
            X, y = X[sel], y[sel]
            w = w[sel] if w is not None else None
        booster = dtrain.train(params, X, y,
                               num_boost_round=config.num_iterations,
                               local_weight=w, local_group=g)
        out = config.output_model or "LightGBM_model.txt"
        if rank == 0:
            booster.save_model(out)
        log.info("Finished distributed training (rank %d/%d)%s"
                 % (rank, config.num_machines,
                    "; model saved to %s" % out if rank == 0 else ""))
    finally:
        torch.distributed.destroy_process_group()
    return 0


def run(argv: Optional[List[str]] = None) -> int:
    """reference: Application::Run (include/LightGBM/application.h:79)."""
    argv = sys.argv[1:] if argv is None else argv
    params = parse_args(argv)
    config = Config.from_params(params)
    # the card unless device_type=cpu: without one this raises here
    resolve_device(config)
    task = config.task

    if task == "train" and int(config.num_machines) > 1:
        return _distributed_train(config, params)

    if task == "train":
        from .obs import events as obs_events
        from .ops.histogram import device_launch_counts
        counting = obs_events.enabled()
        launches0 = device_launch_counts() if counting else {}
        t0 = time.perf_counter()
        X, y, w, g = _load_with_sidecars(config.data, config)
        ds = Dataset(X, label=y, weight=w, group=g, params=params)
        valid_sets = []
        valid_names = []
        valid_paths = (config.valid if isinstance(config.valid, list)
                       else [v for v in str(config.valid).split(",") if v])
        for i, vpath in enumerate(valid_paths):
            Xv, yv, wv, gv = _load_with_sidecars(vpath, config)
            valid_sets.append(Dataset(Xv, label=yv, weight=wv, group=gv,
                                      reference=ds, params=params))
            valid_names.append("valid_%d" % i)
        from .engine import train as train_fn
        t1 = time.perf_counter()
        booster = train_fn(params, ds,
                           num_boost_round=config.num_iterations,
                           valid_sets=valid_sets, valid_names=valid_names,
                           init_model=config.input_model or None)
        t2 = time.perf_counter()
        out = config.output_model or "LightGBM_model.txt"
        booster.save_model(out)
        if counting:
            # the task's summary, for callers that see only its event
            # log: what its learner ran, and the launches since the task
            # started
            st = booster.inner.learner.grow_stats
            launches = device_launch_counts()
            obs_events.emit(
                "cli_train_done", trees=len(booster.inner.models),
                roots=st["roots"], steps=st["steps"],
                captures=st["captures"],
                load_seconds=t1 - t0,
                train_seconds=t2 - t1,
                launches={k: n - launches0.get(k, 0)
                          for k, n in launches.items()})
        log.info("Finished training; model saved to %s" % out)
        return 0

    if task in ("predict", "prediction", "test"):
        booster = Booster(params=params, model_file=config.input_model)
        X, _, _, _ = _load_tabular(config.data, config)
        # Text features are mapped by index (reference predictor
        # semantics): a LibSVM/CSV test file whose max feature index is
        # below the training width still predicts, padded with zeros
        # (LibSVM's implicit value); extra trailing columns are dropped.
        n_feat = booster.inner.max_feature_idx + 1
        X = np.asarray(X)
        if X.ndim == 2 and X.shape[1] < n_feat:
            X = np.concatenate(
                [X, np.zeros((X.shape[0], n_feat - X.shape[1]),
                             dtype=X.dtype)], axis=1)
        elif X.ndim == 2 and X.shape[1] > n_feat:
            log.warning("prediction data has %d features; model was "
                        "trained with %d — extra columns ignored"
                        % (X.shape[1], n_feat))
            X = X[:, :n_feat]
        pred = booster.predict(
            X, raw_score=bool(config.predict_raw_score),
            pred_leaf=bool(config.predict_leaf_index),
            pred_contrib=bool(config.predict_contrib),
            start_iteration=config.start_iteration_predict,
            num_iteration=config.num_iteration_predict or None)
        out = config.output_result or "LightGBM_predict_result.txt"
        np.savetxt(out, np.asarray(pred), fmt="%.18g", delimiter="\t")
        log.info("Finished prediction; results saved to %s" % out)
        return 0

    if task == "refit":
        # new leaf values over the frozen trees, walked on the booster's
        # device (Booster.refit -> boosting/refit.py::refit_model_device)
        booster = Booster(params=params, model_file=config.input_model)
        X, y, _, _ = _load_tabular(config.data, config)
        booster.refit(X, y, decay_rate=config.refit_decay_rate)
        out = config.output_model or "LightGBM_model.txt"
        booster.save_model(out)
        return 0

    if task == "convert_model":
        # reference: Application::ConvertModel (application.cpp) with
        # convert_model_language=cpp -> GBDT::SaveModelToIfElse
        booster = Booster(params=params, model_file=config.input_model)
        lang = (config.convert_model_language or "cpp").lower()
        if lang not in ("cpp", "c++"):
            log.fatal("convert_model_language=%s is not supported "
                      "(only cpp)" % lang)
        out = config.convert_model or "gradient_boosting_model.cpp"
        booster.inner.save_model_to_cpp(out)
        log.info("Converted model saved to %s" % out)
        return 0

    if task == "save_binary":
        X, y, w, g = _load_with_sidecars(config.data, config)
        ds = Dataset(X, label=y, weight=w, group=g, params=params)
        ds.construct()
        from .io.binary_io import save_binary
        save_binary(ds.handle, config.data + ".bin")
        log.info("Saved binary dataset to %s.bin" % config.data)
        return 0

    log.fatal("Unknown task: %s" % task)
    return 1


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
