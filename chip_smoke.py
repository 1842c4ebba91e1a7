#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``lightgbm_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each one fails the run if it fails):
1. print the card and its power limit; build every CUDA kernel of the
   port from ``lightgbm_tpu_torch/csrc`` (one ``nvcc`` per source, all
   started together: ``histogram.cu`` for uint8 bins and
   ``histogram_u16.cu`` for uint16 bins) and print the build seconds;
   count each kernel's atomic instructions in its SASS and fail if a
   float instance (f32 or f64 sums) holds a compare-and-swap;
2. hold every kernel instance (f32, f32 rows into f64 sums rounded once
   to f32, int8 -> int32, int16 -> int32; over uint8 and over uint16
   bins) against its plain PyTorch version on the card: random rows with and
   without row-index lists (of half the rows, 1, 31, 33, 1000, 1025 and
   100k rows), every row in one bin of every feature, Fp = 8, 40 and 64
   beside 32, Fp = 56 and 136 at the root shapes of phase 9 unbundled
   and phase 10, and bundle columns (Gp = 16 at Bg = 256, phase 9's
   shape, and at Bg = 72), with children of 1, 1000 and 100k rows; two
   f32 calls on the same inputs must give the same bytes (two f64 calls
   too); the f64 sums must be the plain f64 sums rounded once (a value
   may round the other way only at a rounding midpoint); the uint16
   instances likewise at B = 512 (Fp 40), 1024 (Fp 32 and 136), 4096
   and 16384 (Fp 8), with every row in one bin, 70% of the rows in one
   bin, every row in the last 256 bins, every row in bins 256-511 and
   every row outside every slab (bins in [B, 2B), skipped); the
   device-count entry (row count read from device memory) must give the
   host-count launch's bytes for every instance at n = 0,
   1, 1023, 1024, 1025, 10k, 100k, 1M and all rows, at Fp = 32 and 136
   and at the bundle shape Gp = 16, Bg = 72, and over uint16 bins at
   B = 1024, 4096 and 16384;
3. train the binary slice at a small size on ``cuda`` and on ``cpu`` and
   compare the first tree and the held-out AUC;
4. train the full-size slice (10.5M Higgs-shaped rows x 28 features,
   255 leaves, 5 rounds) through ``lightgbm_tpu_torch.train`` with the
   default whole-tree loop (the split step replayed as a CUDA graph),
   predict a 500k held-out set, and check that every histogram went
   through the kernel (its device counter == roots + split steps, and
   steps >= splits); print ms per split, host syncs per tree, capture
   ms, replays per tree and peak memory; a second run of 1 round with
   the per-split loop (``tpu_fused_tree=false``) must give the same
   trees, text for text (the two loops agree, and f32 histograms and
   scans are deterministic);
5. time every kernel at the main path's root shape, and with row-index
   lists of 10k, 100k and 1M rows (L2 flushed), against its plain
   version, one library call and its memory bound, and its device-count
   entry at the same sizes (the uint16 instances over phase 16's bins);
   time a split scan with its prefix sums in the reference's order and
   with a cumsum;
6. draw the quantized-gradient rows (threefry ``uniform`` and
   ``quantize_gh``) at 10.5M rows on the card and on the CPU from the
   same inputs: they must be byte-equal;
7. train the full-size data of phase 4 with quantized gradients
   (``quant_grad_bits=8``, 5 rounds): every histogram must go through the
   int8 instance (launches == roots + steps, no f32 launch), the
   held-out AUC must pass 0.7, and a per-split rerun of 1 round must
   give the same tree, text for text;
8. train 200k rows with ``quant_grad_bits=16`` and bagging on ``cuda``
   and on ``cpu``: tree 1 must make the same splits, through the int16
   instance on the card;
9. multiclass at UCI Covertype's shape (581,012 rows x 54 columns, 7
   classes, synthetic from a seed; 255 leaves, 2 rounds = 14 trees) with
   EFB at its default: the 44 one-hot columns bundle, and the kernel runs
   over the bundle columns; held-out multi_logloss falls every round,
   multi_error ends below the majority class's 0.512, the device
   validation scores equal the host walk within 1e-4, f32 launches ==
   roots + steps over the 14 trees; 1 round at 63 leaves text-equal
   through both loops; a 2-round unbundled f32 run reaches the held-out loss
   within 1e-4 (its prediction gap and structure-equal trees printed);
   on the same gradients the bundled learner's histograms of the root
   and of the root split's smaller child (unpacked, each shared zero bin
   rebuilt from the totals the learner passes) are held against the f64
   sums over the unbundled bins within the f32 kernel's tolerance, and
   ms per split of both learners are timed in turns, and the first
   split where the two learners part, on those gradients and on tree
   0's, is printed with both winners' gains and both learners' gains
   for each winner (a near-tie or not);
   the same rows as a scipy CSR matrix bin to the same bytes and train
   2 text-equal rounds; the LUT-node encoding of the stacked forest
   gives the compare encoding's and the host walk's leaves and bytes
   (ms per bucket for both); 1 round at 8 bits goes through the int8
   instance only and equal an unbundled 8-bit run text for text, and
   an 8-bit tree 1 at 50k rows is the same on cuda and cpu; softmax
   gradient ms and memory;
10. lambdarank at MSLR-WEB30K's shape (2,270,296 rows x 136 in 18,919
   queries of at most 1,251 docs, synthetic from a seed; 255 leaves,
   min_data_in_leaf 100, ndcg@1,3,5 on 2,000 held-out queries, 5
   rounds): ndcg@5 rises, launches == roots + steps, a 1-round
   per-split rerun is text-equal; the gradient stage's ms and memory;
   then a whole-tree and a per-split 1-round rank_xendcg run must give
   the same trees;
11. every other objective (l1, huber, fair, quantile, mape, poisson,
   gamma, tweedie, cross_entropy, cross_entropy_lambda, multiclassova)
   on phase 3's rows, 63 leaves, 1 round, cuda vs cpu: tree 1 the same
   tree, renewed leaf values (l1, quantile, mape) equal; renewal ms;

12. prediction through the stacked forest: train binary (255 leaves,
   min_data_in_leaf 100, lr 0.1, 40 rounds) on phase 3's 200k rows;
   predict the reference bench's batch (262,144 rows of
   ``make_higgs_like(seed=1)``) through ``Booster.predict`` in auto
   mode (it must dispatch the stacked path), ``predict_raw_device`` and
   ``pred_leaf``, against the host walk: leaf ids equal (on the first
   65,536 rows), values and raw scores byte-equal (on every row), the
   Kahan f32 sum within Kahan's bound of the f64
   sum of the same f32 leaf values (2 f32 ulp of the sum of their
   magnitudes); a 4096-row f64 batch (the dd path)
   byte-equal; rows/s of the host walk, the stacked ``value`` path and
   ``raw_device``, ms per 65,536-row bucket split into quantize, walk
   and sum, bytes each way, peak memory; then continue the model saved
   after 20 rounds for 20 more through ``init_model`` (held-out AUC must
   not fall) and round-trip it through pickle (same predictions).
   Phases 4, 9 and 10 hold the stacked path against the host walk on
   their own boosters and held-out rows too;

13. Covertype in its categorical form (phase 9's rows with the
   wilderness and soil one-hot columns collapsed into two categorical
   columns: 12 columns, ``categorical_feature=[10, 11]``, 3 rounds):
   phase 9's checks, categorical nodes in the model text, the stacked
   path equal to the host walk on rows with NaN, negative and unseen
   categories, 1 round at 63 leaves text-equal through both loops, 1
   round with ``max_cat_to_onehot: 8`` (wilderness one-hot on the
   card), an 8-bit
   tree 1 at 50k rows the same on cuda and cpu;

14. row and column sampling and the per-node filters on phase 4's data
   (255 leaves, max_bin 255, min_data_in_leaf 100, lr 0.1):
   a. ``feature_fraction 0.9`` + ``extra_trees``, 5 rounds, whole-tree
      loop: launches == roots + steps, held-out AUC > 0.7, every split
      feature of a tree inside that tree's mask, stacked predict == host
      walk, a 1-round per-split rerun text-equal; ms per split beside
      phase 4's, and the kernels and ms of one replayed step with and
      without the extra_trees draws;
   b. GOSS at its default rates, 13 rounds (warm-up 10): each GOSS
      tree's in-bag rows are its top rows (ties included) plus
      ``other_k`` sampled within 1%; held-out AUC > 0.7; the draw at all
      10.5M rows byte-equal on the card and the CPU; its ms and memory,
      and the threshold by ``torch.topk`` and ``torch.kthvalue``;
   c. GOSS with 8-bit gradients, lr 0.5, 4 rounds: the int8 instance
      only, a 3-round per-split rerun text-equal;
   d. ``feature_fraction_bynode 0.5`` + interaction constraints (columns
      0-13 and 14-27), 1 round: every root-to-leaf path inside one
      group, one record read per split;
   e. CEGB (split, coupled and lazy penalties; coupled 1e9 on columns
      20-27), 1 round: those columns never split, the tree differs from
      a run without penalties, the lazy fetched state after tree 1 marks
      exactly the rows under each feature's nodes;
   then tree 1 on cuda and cpu at phase 3's 200k rows (63 leaves) for
   a, GOSS (lr 2.0: no warm-up), d and e must be the same tree;

15. monotone constraints, forced splits and linear trees on phase 4's
   data (255 leaves): +1 on the 4 columns most positively correlated
   with the label in 100k training rows, -1 on the 2 most negative;
   a-c train on the first 2,097,152 training rows binned again with the
   constraints (all 10.5M before), d on phase 4's Dataset;
   a. the basic method, 5 rounds through the captured whole-tree step:
      launches == roots + steps, held-out predictions exactly monotone
      along a 64-point grid of each constrained column (stacked path), a
      1-round per-split rerun text-equal;
   b. the intermediate method, 1 round, and the advanced method, 1
      round at 63 leaves (the host-tracked per-split loop): AUC >=
      basic's after as many rounds at as many leaves - 0.002, the grid
      check, ms and syncs per split, rescans per tree;
   c. monotone_penalty 2.0: no constrained column at depth 0 or 1;
   d. three forced nodes (the root on column 0, its children on 1 and
      2), 3 rounds in f32 and in 8-bit: every tree starts with them, and
      1-round per-split reruns are text-equal;
   e. linear trees (linear_lambda 0.1) on the first 2,097,152 training
      rows, 3 rounds: the fit's ms per tree, stacked predict == the host
      f64 walk, ``raw_device`` within Kahan's bound of its own terms and
      within the f32 rounding bound of the host f64 walk, the text round
      trip;
   then tree 1 on cuda and cpu at 200k rows (63 leaves) for basic
   (f32), intermediate (8-bit), forced (f32) and linear (f32) must be
   the same tree, and the card's linear fit, run again on the CPU from
   the same inputs, within rtol 1e-9;

16. wide bins: the first 2,097,152 of phase 4's rows binned again at
   max_bin 1023 (uint16 bins, B = 1024, 255 leaves, min_data_in_leaf
   100, lr 0.1): f32 for 5
   rounds through the uint16 f32 instance only (held-out AUC > 0.7 and
   equal to the device scores', stacked predict == host walk, a 2-round
   per-split rerun text-equal; ms per split beside phase 4's), 8-bit for
   3 rounds and 16-bit for 2 through their uint16 instances (1-round
   per-split reruns text-equal), tree 1 at 200k rows the same on cuda
   and cpu in f32, 8-bit and 16-bit (those rows binned once for the
   three); the uint16 instances are timed over the learner's bins
   repeated to phase 4's 10.5M rows;
17. f64 histogram sums (``tpu_use_f64_hist``): phase 4's Dataset for 3
   rounds and phase 16's for 2, through the f64 instances; then phase
   9's Covertype rows bundled and unbundled for 2 rounds each, and
   whether their predictions hold the reference's bundle contract
   (rtol 1e-4) is reported (phase 9 reports the f32 pair);
18. DART (drop_rate 0.1, skip_drop 0) and random forest (bagging 0.632
   every round, feature_fraction 0.9) for 5 rounds each on phase 4's
   Dataset: DART's drop sets and tree weights the same on cuda and on a
   CPU run, ``average_output`` in the RF text, both predicting through
   the stacked path == the host walk; then ``Booster.refit`` of phase
   12's model's first 20 iterations on 200k fresh rows on cuda and cpu,
   leaf values within 1e-5;

19. the rest of the Python surface on phase 4's Dataset and rows (no
   binning at 10.5M rows again):
   a. ``tpu_batch_iterations=4`` with ``tpu_eval_iterations=4``, 5
      rounds (iteration 0 looped, then one batch of 4 with one record
      read and no step-counter read): the trees of phase 4 under the
      batched contract (structure and leaf counts exact, leaf values
      rtol 1e-5, gains rtol 1e-6), launches == roots + steps through
      the f32 instance, one evaluation (at the end), its AUC phase 4's;
      s per batch against phase 4's 4 iterations, host syncs per batch;
   b. the same at 8 bits against phase 7's trees (structure exact),
      through the int8 instance only; the replay of the trees against
      the batch-maintained score (``recheck_scores``);
   c. ``LGBMClassifier(n_estimators=5, num_leaves=255,
      min_child_samples=100)`` on the first 2,097,152 training rows:
      launches == roots + steps, the model text of ``lgb.train`` with
      the mapped parameters, ``predict_proba`` of the 500k held-out rows
      through the stacked path, AUC > 0.7;
   d. ``lgb.cv`` with 3 folds and 3 rounds on 19c's Dataset: each fold's
      roots == its trees, launches == the folds' roots + steps, fold 0
      text-equal to ``lgb.train`` on its subset;
   e. ``pred_contrib`` of 16 held-out rows of 19c's model: each row sums
      to its raw score within 1e-6 x scale; its ms;
20. observability and checkpoints on the card (``lightgbm_tpu_torch/obs``,
   ``ft/checkpoint.py``), on phase 4's Dataset:
   a. sample mode (``registry.enable(sampling=True)``), f32, 3 rounds,
      with the span trace and the event log written to temporary files:
      the trace parses; it has ``tree::grow``, ``gbdt::gradients``,
      ``gbdt::score_update`` and ``gbdt::eval_metrics`` spans and a
      readiness span for each watched stage; 3 ``train_iter`` events;
      host syncs per tree no more than phase 4's; the registry's launch
      gauge == ``device_launch_counts()`` == roots + steps (K1), and the
      registry's host count - captures + graph replays == the same;
   b. fencing mode, 8-bit, 2 rounds: the per-stage table (the port's
      per-stage device times on the card, each stage fenced), through
      the int8 instance only (K2);
   c. resume: f32 with a checkpoint every 2 of 4 rounds, resumed from
      the first checkpoint: the 4 trees text-equal to phase 4's first 4;
      then 8-bit with bagging and DART at 200k rows, cut after their
      4-round checkpoint and resumed to 6: text and score bits equal to
      the uninterrupted runs;
21. serving (``serve/server.py``) with phase 12's model (binary, 255
   leaves, 40 rounds, 28 features): ``PredictServer`` with max_batch
   256 and max_wait_ms 2, first with 1 replica, then with 2 on the one
   card (two dispatch workers, each on its own CUDA stream): 16 client
   threads send single rows and, every 25th request, a 1000-row block
   (split across dispatches) for 5 s each; every answer byte-equal to
   ``StackedForest.predict`` of its rows, dispatches fewer than
   requests, p50 / p99 latency and rows/s per replica count, the
   OpenMetrics text with ``replica="0"`` and ``replica="1"`` series;
   then 4096 rows from 4 threads against ``max_queue_rows=1024`` (1024
   served, 3072 shed with ``Overloaded``, no Future pending), injected
   ``serve_dispatch`` faults opening the breaker and a half-open probe
   closing it, a canary (``canary_batches=4``) rolled back by an
   injected fault while the old version serves byte-equal, and
   ``stop(drain_timeout_s=0.05)`` over 513 queued requests resolving or
   failing every Future;
22. out-of-core (``io/shards.py``, ``treelearner/sharded.py``): the first
   2,097,152 of phase 4's training rows spilled through
   ``StreamingDataset(spill_dir=...)`` into 8 shards of 262,144 rows,
   255 leaves, 3 rounds in f32 and 2 in 8-bit by the shard-sweep learner
   (8 splits per sweep) beside the in-memory learner on the same bins:
   8-bit trees text-equal, f32 at the level reached ((a) text, (b)
   splits and leaf counts, or (c) held-out AUC within 1e-3, which must
   hold), K1 and K2 device launches == shards x histogram passes (one
   pass for each root and each speculated split of a sweep round);
   s per iteration, sweeps and passes per tree, prefetch stall ms and
   its share of the tree; then the spill attached again, an 8-bit run
   cut after 1 round and resumed to 2: text-equal to the uninterrupted
   run, its score check replayed shard by shard;
23. several devices and processes (``parallel/``):
   a. ``tree_learner=data`` through ``lgb.train`` on phase 4's Dataset
      (the one card: a 1-device mesh), 2 rounds: the captured loop, K1
      launches == roots + steps, the trees text-equal to phase 4's
      first 2, host syncs per tree;
   b. ``Mesh([cuda:0] * 4)`` through ``create_tree_learner(..., mesh=)``
      on phase 4's Dataset, 2 rounds f32 and 2 at 8 bits: K1 / K2
      launches == 4 x (roots + steps), still one captured step; 8-bit
      trees text-equal to phase 7's; f32 at the level reached against
      phase 4's, and where they part the first split on tree 0's
      gradients with both learners' gains, which must be a near-tie
      within the f32 rounding of the two histograms (and the held-out
      AUC within 1e-3); ms per split beside phase 4's;
   c. the first 2,097,152 training rows binned once with the mappers
      23d's ranks build (each rank's sample, in rank order), 2 rounds
      each: the serial learner, then on 4 logical shards the feature
      learner (level (b) or (a), printed), voting with every feature
      voted (top_k 28: level (b), leaf values within the f32 bound of
      the rows their sums' rounding carries, ``chain_rows``)
      and voting with top_k 2 (held-out AUC > 0.7); 1 round at 16 bits
      through the int16 instance only, the 4-shard data learner's tree
      text-equal to the serial learner's;
   d. ``dtrain.train`` in 2 rank subprocesses over gloo on CUDA tensors
      of the one card (this script with ``--dtrain-rank``), 1,048,576
      rows each, 2 rounds: model text identical on both ranks and equal
      to 23c's rows through an in-process 2-shard learner; each rank's
      K1 counter == its roots + steps, no capture; all-reduce ms per
      split and the eager loop's syncs per tree; a rank of a group whose
      peer never starts exits non-zero within its 15 s collective
      timeout. NCCL (a card per rank) needs two cards: not run;
24. the closed refresh loop (``loop/controller.py``) on the card:
   a. ``RefreshController`` over windows of 2,097,152 Higgs-shaped rows
      (``make_higgs_like``, seed 100 + cycle) spilled into 8 shards of
      262,144 rows, binary, 255 leaves, max_bin 255, f32, 2 base rounds
      and 1 per refresh, 4 cycles under ``refresh_schedule(4)`` (a
      poisoned canary, a retried ``prefetch_device_put``, a lost gateway
      push), the gateway on, 2 pumps of 64-row blocks from a pool of 4,
      ``LIGHTGBM_TPU_WATCH_REFRESH_P99_MS=1000`` (the JAX package's
      refresh bench, ``bench.py:1050``; restored after): the report ok,
      outcomes bootstrap / rolled_back / promoted / promoted, 1 rollback,
      every leg fired, no untyped failure, no stranded future, K1 ==
      shards x passes over the loop's learners, a capture in every
      refresh; then, with no server running, the newest checkpoint (5
      rounds, each refresh's graph captured while the server and the
      pumps used the card) text-equal to one uninterrupted ``lgb.train``
      on the attached spill, its refit on window 3 the stable version's
      text, the stable version's answers on 4096 rows byte-equal to
      ``StackedForest.predict`` of that text; s per cycle, capture ms,
      rows/s served, p50 / p99, peak memory;
   b. the JAX bench's drift stage (``bench.py:1052-1072``): a no-shift
      control (3 cadence cycles of 20,000 rows from one draw) keeps PSI
      under ``LIGHTGBM_TPU_WATCH_PSI`` with no ``feature_drift``; 4
      cycles with ``refresh_trigger="drift"`` and the covariate shift
      after 2048 rows cross it, fire ``feature_drift`` and start a
      drift-triggered refresh;
25. the CLI (``python -m lightgbm_tpu_torch.application``, each run a
   process of its own) and the C ABI on the card:
   a. a 1,048,576 x 28 Higgs-shaped TSV (label in column 0): ``task=train``
      (255 leaves, 5 trees) text-equal (trees and importances) to
      ``lgb.train`` here on the same parsed rows, the CLI's own K1 (its
      ``cli_train_done`` event) == roots + steps, ``task=predict`` ==
      ``Booster.predict`` within 1e-9; the CLI process's seconds in and
      outside its task, parse and train seconds;
   b. the four ``examples/*/train.conf`` through the CLI (four processes
      at once): test-set predictions == ``lgb.train``'s within 1e-9, each
      CLI's own K1 == roots + steps, its roots and steps the API run's;
   c. 25a's model in the port's ``_capi.so``: ``LGBM_BoosterPredictForMat``
      on 262,144 rows == the host walk within rtol 1e-12, rows/s beside
      the stacked predict's; ``examples/c_api/main.c`` compiled with the
      port's ``capi.cpp`` predicts 1000 rows == ``Booster.predict``;
   d. two CLI ranks over gloo on the one card (``pre_partition=false``,
      a shared machine list, 262,144 rows): rank 0's trees == the
      in-process 2-shard learner's on the same rank-strided rows; each
      rank's K1 (its ``dtrain_done`` event) == roots + steps;

then time every instance over the learners' real bins of phases 9 (the
bundle columns at Bg), 13 and 10, and print one ``{"kernels": [...]}``
line with the launches of each kernel on each path that runs it, as its
device counter counted them (graph replays included;
``launches_by_path``; f32: phases 3, 4, 9, 10, 11, 12, 13, 14a, 14b,
14d, 14e, 15a-e, 18, 19a, 19c, 19d, 20a, 20c, 22, 23a-d, 24a-b, 25a-b,
25d (23d, 25d: each rank's own counter; 25a-b: each CLI process's own
counter, beside the in-process runs'); int8: phases 7, 9, 14c, 15d, 19b, 20b, 20c, 22,
23b; int16: phases 8, 23c; f64: phase 17; the uint16 instances: phase 16, and f64
phase 17); each instance must have been timed and launched by some
path.
Prediction (phases 12 and 21) launches
no hand kernel: the stacked walk is PyTorch ops (the reference's is
``jnp``), so it has no row in that line.

For phase 23 (52-57 s on one H100 80GB HBM3 at 700 W), host binning
was made faster instead of cutting a check: the greedy bin-bound search
finds each bin's closing by a binary search over the counts' prefix
sums (the same bounds as the loop, a search per bin instead of a
Python step per distinct value of the 200k-row sample), and
``value_to_bin`` runs ``torch.searchsorted`` over the host's cores
(phase 4's binning 7.3-9.1 s on the host of an H100 80GB HBM3 at 700 W,
from 46.4 s with the loop and NumPy's searchsorted), and phase 23
reuses phase 4's Dataset and bins its 2,097,152 rows once for 23c and
23d.
Rounds cut to keep the script inside its time, with every check kept:
phases 9 and 13 2 rounds (5, then 3 before), phase 12 40 rounds and a
20 + 20 continuation (100 and 50 + 50, then 50 and 25 + 25 before), 14d,
14e and 15b's intermediate method 1 round (2 before). For phases 21 and
22: phase 16's rows 2,097,152 (10.5M before; its uint16 instance
timings keep phase 4's 10.5M-row root by repeating its bins), the
cuda-vs-cpu tree-1 checks of phases 11, 14 and 15 at 100k rows (200k
before), the 8-bit cuda-vs-cpu tree 1 of phases 9 and 13 at 63 leaves
(255 before), and one binning of the small rows for both devices (and
for phase 16's three settings) where each run binned them again.

Phases 3, 4, 7-11, 13, 14a-c, 15a, 15c-e, 16-18 and 19 train through the
default whole-tree loop (14d, 14e and 15b through the per-split loop, which
per-node masks, CEGB and the intermediate and advanced monotone methods
take); every per-split (``tpu_fused_tree=false``) rerun must give its
whole-tree run's trees.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", ...}}``. Without a visible
CUDA device, or without the ``lightgbm_tpu_torch`` package beside this
file, the script exits non-zero and prints no result.
``--phases 1,2`` runs a subset (for development; the full run is the
check); phase 19 brings phases 4 and 7, whose trees its batches are
held against, phase 20 brings phase 4 (its Dataset, trees and host
syncs), phase 21 brings phase 12 (its model), phase 22 the full-size
rows (without their training) and phase 23 phases 4 and 7 (their
Dataset and trees); phases 24 and 25 make their own rows.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
F32_OPS_PER_S = 67e12           # H100 SXM float32 rate outside tensor cores
INT8_OPS_PER_S = 1979e12        # H100 SXM int8 rate (the table's int8 row;
#                                 the published table has no other
#                                 integer row, so int16 rows use it too)
F64_OPS_PER_S = 34e12           # H100 SXM float64 rate outside tensor cores
#                                 (NVIDIA's H100 data sheet; the f64 adds
#                                 of the f64-sum instances)

# tolerance of the f32 kernel against an f64 plain sum: the kernel adds
# f32 values in a fixed order of its own (lanes, rows, blocks), not the
# plain version's row order. The rounding error of
# an f32 sum in any order is bounded by a multiple of eps * sum(|x|)
# over the summed values, not of |sum(x)| (which cancels for signed
# gradients), so each grad/hess bin is held to REL_TOL times the f64 sum
# of the absolute values of its rows (~170 f32 ulps of that magnitude).
# The count channels are sums of 0/1 below 2^24, exact in any order,
# and must match exactly.
REL_TOL = 1e-5

#: rounds of each per-split (``tpu_fused_tree=false``) rerun that must
#: give its whole-tree run's trees: one tree holds the two loops to the
#: same splits, and the script stays inside its time (phase 16, the
#: wide bins' own path, keeps 2)
RERUN_ROUNDS = 1
#: leaves of the Covertype phases' whole-tree / per-split pairs and of the
#: advanced monotone tree (with a basic one beside it): the per-split
#: loop is host-bound (20-40 ms a split), and those 255-leaf rounds took
#: 30-80 s each of the script's 1200 s; the same checks at a cut depth
CUT_LEAVES = 63

#: rounds of phase 12's predict model and, from its half, of the
#: continued run (cut from 100: the training and the host walk of 100
#: trees took ~60 s of the script's time; then from 50, for phase 20)
PREDICT_ROUNDS = 40
#: rounds of the Covertype phases 9 and 13 (cut from 5, then from 3 for
#: phase 20, for time)
MULTICLASS_ROUNDS = 2

FULL_ROWS = 10_500_000
HELD_OUT_ROWS = 500_000
SMALL_ROWS = 200_000
#: rows of the per-setting cuda-vs-cpu tree-1 checks of phases 11, 14
#: and 15 (cut from phase 3's 200k for the budget of phases 21 and 22:
#: each setting trains a 63-leaf tree on the CPU)
CROSS_ROWS = 100_000
#: leaves of the 8-bit cuda-vs-cpu tree 1 of the Covertype phases 9 and
#: 13 at 50k rows (cut from 255: the CPU run grows all 7 classes' trees)
CROSS_LEAVES = 63
# the reference bench's predict batch (bench.py:153, BENCH_PREDICT_ROWS)
PREDICT_ROWS = 1 << 18
# UCI Covertype: 581,012 rows x 54 columns, 7 classes (phase 9)
COVERTYPE_ROWS = 581_012
COVERTYPE_HELD_OUT = 50_000
# Microsoft Learning to Rank, MSLR-WEB30K Fold1 train: 2,270,296 rows x
# 136 features in 18,919 queries of at most 1,251 docs (phase 10)
MSLR_ROWS = 2_270_296
MSLR_QUERIES = 18_919
MSLR_MAX_LEN = 1_251
MSLR_HELD_OUT_QUERIES = 2_000


def make_higgs_like(n_rows: int, n_features: int = 28, seed: int = 0):
    """Higgs-shaped synthetic data (copied from the reference bench):
    28 standard-normal columns, every 4th heavy-tailed, and a noisy
    linear-plus-interaction logit."""
    rng = np.random.RandomState(seed)
    X = np.empty((n_rows, n_features), dtype=np.float32)
    chunk = 1 << 20
    w = rng.randn(n_features).astype(np.float32) * 0.6
    for lo in range(0, n_rows, chunk):
        hi = min(lo + chunk, n_rows)
        block = rng.randn(hi - lo, n_features).astype(np.float32)
        block[:, ::4] = np.abs(block[:, ::4]) ** 1.5
        X[lo:hi] = block
    logit = np.zeros(n_rows, dtype=np.float32)
    for lo in range(0, n_rows, chunk):
        hi = min(lo + chunk, n_rows)
        logit[lo:hi] = (X[lo:hi] @ w +
                        0.5 * np.sin(X[lo:hi, 0]) * X[lo:hi, 1])
    y = (logit + rng.randn(n_rows).astype(np.float32) * 0.5 > 0).astype(
        np.float64)
    return X, y


def auc(y: np.ndarray, score: np.ndarray) -> float:
    """ROC AUC; tied scores share their mean rank (half credit for a
    tied positive-negative pair, as the library's metric counts it)."""
    order = np.argsort(score, kind="stable")
    s = score[order]
    n = len(s)
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    ends = np.r_[starts[1:], n]
    ranks = np.empty(n, dtype=np.float64)
    ranks[order] = np.repeat((starts + 1 + ends) / 2.0, ends - starts)
    pos = y > 0
    n_pos, n_neg = pos.sum(), (~pos).sum()
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit("FAILED: " + msg)


# ---------------------------------------------------------------------------
# phase 1: card, power limit, kernel builds
# ---------------------------------------------------------------------------
def phase_device_and_build(csrc):
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi unavailable"
    name = torch.cuda.get_device_name(0)
    log("card: %s" % card)
    log("torch %s cuda %s device %s" % (torch.__version__,
                                        torch.version.cuda, name))
    sources = csrc.sources()
    t0 = time.perf_counter()
    outputs = csrc.build(sources, ["-Xptxas", "-v"])
    for src in sources:
        csrc.load(src)
    log("kernel build seconds: %.3f (%s)"
        % (time.perf_counter() - t0, ", ".join(sources)))
    for src, out in outputs.items():
        log("nvcc %s.cu:\n%s" % (src, "\n".join(
            ln for ln in out.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln)))
    for src in sources:
        log_atomics(csrc, csrc.library_path(src))
    return card, name


def log_atomics(csrc, lib_path: str) -> None:
    """Count the atomic instructions of each kernel in a built library's
    SASS, and fail if a function of a float instance (mangled template
    arguments ``<float, float, float, ...>``, ``<float, double, float,
    ...>`` and the sums ``<float, float>``, ``<double, float>``) holds a
    compare-and-swap atomic (``ATOMS.CAS*``, ``ATOMS.CAST.SPIN``: the
    loop a float add in shared memory compiles to on this card), or if
    the library has no float instance to check."""
    cuobjdump = os.path.join(os.path.dirname(csrc._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        log("cuobjdump not found; atomic instructions not counted")
        return
    sass = subprocess.run([cuobjdump, "-sass", lib_path],
                          capture_output=True, text=True, timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = {}
            continue
        for tok in line.split():
            tok = tok.rstrip(";")
            if fn is not None and tok.startswith(("ATOM", "RED")):
                counts[fn][tok] = counts[fn].get(tok, 0) + 1
    check(bool(counts), "no kernel function in the SASS of %s" % lib_path)
    floats = 0
    for fn, c in sorted(counts.items()):
        log("atomic instructions in %s: %s" % (fn, json.dumps(c,
                                                             sort_keys=True)))
        if re.search(r"hist_(rows|sum)_kernelI(ff|fdf|df)", fn):
            floats += 1
            check(not any(".CAS" in t for t in c),
                  "the float instance %s still holds a CAS atomic: %s"
                  % (fn, c))
    check(floats > 0, "no float instance found in the SASS of %s"
          % lib_path)
    log("no compare-and-swap atomic in the %d functions of the float "
        "instances (f32 and f64 sums; %d functions in all)"
        % (floats, len(counts)))


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------
def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps: int = 10, warm: int = 1) -> float:
    """Mean ms of ``fn`` with the L2 cache flushed before each call (by
    zeroing 128 MB), as a child's histogram finds it in training; the
    flush is outside the timed events."""
    import torch
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warm):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------
def make_hist_inputs(S: int, Fp: int, B: int, seed: int, low: int = 0):
    """Random rows: bins in [low, B) (uint16 when B > 256, the wide
    bins' dtype), f32 gh with a bag, int8 rows and int16 rows as large
    as the int32 accumulator allows at S rows, and a sorted list of half
    the rows."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    bins = torch.randint(low, B, (S, Fp), generator=g, device="cuda",
                         dtype=torch.int32)
    bins = (bins.to(torch.int16).view(torch.uint16) if B > 256
            else bins.to(torch.uint8))
    bag = (torch.rand(S, generator=g, device="cuda") < 0.8).float()
    gh = torch.stack([torch.randn(S, generator=g, device="cuda") * bag,
                      torch.rand(S, generator=g, device="cuda") * bag,
                      bag, torch.ones(S, device="cuda")], dim=1)
    gh8 = torch.stack([
        torch.randint(-127, 128, (S,), generator=g, device="cuda"),
        torch.randint(0, 128, (S,), generator=g, device="cuda"),
        bag.long(), torch.ones(S, dtype=torch.long, device="cuda")],
        dim=1).to(torch.int8).contiguous()
    # int16 rows as large as the int32 accumulator allows at S rows
    q16 = (2 ** 31 - 1) // S
    gh16 = torch.stack([
        torch.randint(-q16, q16 + 1, (S,), generator=g, device="cuda"),
        torch.randint(0, q16 + 1, (S,), generator=g, device="cuda"),
        bag.long(), torch.ones(S, dtype=torch.long, device="cuda")],
        dim=1).to(torch.int16).contiguous()
    idx = torch.randperm(S, generator=g, device="cuda")[:S // 2]
    idx = idx.sort().values.to(torch.int32)
    return bins, gh.contiguous(), gh8, gh16, idx


def compare_f32(hist_mod, bins, gh, B, idx):
    """max abs error of the f32 kernel against an f64 plain sum; fails
    on a count-channel mismatch or a grad/hess sum out of tolerance."""
    import torch
    got = hist_mod.build_histogram(bins, gh, B, idx).double()
    torch.cuda.synchronize()
    ref = hist_mod.histogram_plain(bins, gh.double(), B, idx)
    check(torch.equal(got[..., 2:], ref[..., 2:]),
          "count channels of the f32 histogram differ (idx=%s)"
          % (idx is not None))
    err = (got[..., :2] - ref[..., :2]).abs()
    mag = hist_mod.histogram_plain(bins, gh[:, :2].double().abs(), B, idx)
    check(bool((err <= REL_TOL * mag).all()),
          "f32 histogram off its plain f64 sum by %.3g (idx=%s)"
          % (float(err.max()), idx is not None))
    return float(err.max())


def compare_int(hist_mod, bins, gh_int, B, idx):
    """An integer instance (int8 or int16 rows -> int32) must be
    byte-equal to its plain version."""
    import torch
    got = hist_mod.build_histogram(bins, gh_int, B, idx)
    torch.cuda.synchronize()
    ref = hist_mod.histogram_plain(bins, gh_int, B, idx)
    check(got.dtype == torch.int32 and torch.equal(got, ref),
          "%s histogram is not byte-equal to its plain version (idx=%s)"
          % (gh_int.dtype, idx is not None))
    return 0.0


def compare_f64(hist_mod, bins, gh, B, idx):
    """The f64-sum instance (f32 rows, f64 adds, one rounding to f32)
    against the plain version's f64 sum over the same rows: every value
    must be that sum rounded to f32, except where the f64 sum lies so
    close to the midpoint of two f32 values that two f64 orders may round
    it to either neighbour: within 1e-11 of the sum of |x| over the bin's
    rows (an f64 sum in any order is within n eps64 sum|x| of the exact
    one; eps64 = 1.1e-16). Returns (max abs error against the f64 sum,
    values off the plain version's rounding)."""
    import torch
    got = hist_mod.build_histogram(bins, gh, B, idx, f64=True)
    torch.cuda.synchronize()
    ref = hist_mod.histogram_plain(bins, gh.double(), B, idx)
    check(got.dtype == torch.float32, "the f64 instance returned %s"
          % got.dtype)
    off = got != ref.float()
    if bool(off.any()):
        a, r = got[off].double(), ref[off]
        hi = torch.nextafter(a.float(), torch.full_like(a.float(),
                                                        float("inf")))
        lo = torch.nextafter(a.float(), torch.full_like(a.float(),
                                                        float("-inf")))
        other = torch.where(r > a, hi, lo).double()
        mid = (a + other) / 2
        mag = hist_mod.histogram_plain(bins, gh.double().abs(), B, idx)
        near = (r - mid).abs() <= 1e-11 * mag[off]
        check(bool(near.all()),
              "f64 histogram is not the rounded f64 sum: %d values off, "
              "not at a rounding midpoint (idx=%s)"
              % (int((~near).sum()), idx is not None))
    return float((got.double() - ref).abs().max()), int(off.sum())


def sub_index(S: int, n: int, seed: int):
    """A sorted int32 list of n distinct rows of S (a child's rows)."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return torch.randperm(S, generator=g, device="cuda")[:n].sort().values \
        .to(torch.int32)


def phase_kernels(hist_mod):
    """Every instance against its plain version on random and adversarial
    inputs: every row in one bin of every feature (one group of 32
    lanes, every row on one address), row-index lists of 1, 31, 1000 and
    100k rows, Fp = 8, 40 (two groups) and 64 beside the main path's 32,
    and Fp = 56 and 136 at the root shapes of phases 9 and 10 with
    children of 1, 1000 and 100k rows; and two f32 calls on the same
    inputs must give the same bytes."""
    import torch
    S, Fp, B = 1 << 20, 32, 256
    bins, gh, gh8, gh16, idx = make_hist_inputs(S, Fp, B, seed=1)
    hot = torch.full_like(bins, 7)
    cases = [("random", bins, gh, gh8, gh16, B, None),
             ("random, idx S/2", bins, gh, gh8, gh16, B, idx)]
    cases += [("random, idx %d" % n, bins, gh, gh8, gh16, B,
               sub_index(S, n, seed=n)) for n in (1, 31, 33, 1000, 1025,
                                                  100_000)]
    cases += [("one bin", hot, gh, gh8, gh16, B, None),
              ("one bin, idx S/2", hot, gh, gh8, gh16, B, idx)]
    # Fp = 40: two feature groups of 32 and 8 (the last one narrower)
    for fp, b, seed in ((8, 64, 2), (40, 128, 4), (64, 256, 3)):
        wb, wgh, wgh8, wgh16, widx = make_hist_inputs(S, fp, b, seed=seed)
        cases += [("Fp=%d B=%d" % (fp, b), wb, wgh, wgh8, wgh16, b, None),
                  ("Fp=%d B=%d, idx S/2" % (fp, b), wb, wgh, wgh8, wgh16, b,
                   widx)]
    # the widths of phases 9 and 10 at their root shapes: Fp = 56 (two
    # groups) and Fp = 136 (five groups), and children of 1, 1000 and
    # 100k rows
    for rows, fp, seed in ((COVERTYPE_ROWS, 56, 5), (MSLR_ROWS, 136, 6)):
        wb, wgh, wgh8, wgh16, _ = make_hist_inputs(rows, fp, B, seed=seed)
        cases.append(("Fp=%d root" % fp, wb, wgh, wgh8, wgh16, B, None))
        cases += [("Fp=%d, idx %d" % (fp, n), wb, wgh, wgh8, wgh16, B,
                   sub_index(rows, n, seed=n + fp)) for n in
                  (1, 1000, 100_000)]
    # EFB: the kernel over bundle columns [N, Gp] at the bundle width Bg
    # (phase 9's Gp = 16 at Bg = 256, and a Bg of 72 bins, off the
    # per-feature B)
    for rows, gp, bg, seed in ((COVERTYPE_ROWS, 16, 256, 7),
                               (1 << 20, 16, 72, 8)):
        wb, wgh, wgh8, wgh16, _ = make_hist_inputs(rows, gp, bg, seed=seed)
        cases.append(("bundles Gp=%d Bg=%d root" % (gp, bg), wb, wgh, wgh8,
                      wgh16, bg, None))
        cases += [("bundles Gp=%d Bg=%d, idx %d" % (gp, bg, n), wb, wgh,
                   wgh8, wgh16, bg, sub_index(rows, n, seed=n + bg))
                  for n in (1, 1000, 100_000)]
    errs = dict.fromkeys(hist_mod.launch_counts, 0.0)
    check_cases(hist_mod, cases, errs, "")
    return errs


def check_cases(hist_mod, cases, errs, prefix):
    """Every instance of one bin dtype (``prefix`` "" for uint8, "u16_"
    for uint16) on each case against its plain version: f32 within
    REL_TOL x sum|x| per bin (counts exact), the f64 sums rounded once
    (:func:`compare_f64`), int8 and int16 byte-equal; then two f32 and
    two f64 calls on the first, second and seventh case byte-equal."""
    import torch
    for label, cb, cgh, cgh8, cgh16, cB, cidx in cases:
        e = compare_f32(hist_mod, cb, cgh, cB, cidx)
        errs["histogram_%sf32" % prefix] = max(
            errs["histogram_%sf32" % prefix], e)
        e64, off = compare_f64(hist_mod, cb, cgh, cB, cidx)
        errs["histogram_%sf64" % prefix] = max(
            errs["histogram_%sf64" % prefix], e64)
        compare_int(hist_mod, cb, cgh8, cB, cidx)
        compare_int(hist_mod, cb, cgh16, cB, cidx)
        log("kernel check [%s] %s S=%d Fp=%d B=%d C=4: f32 max_abs_err "
            "%.3g (tol %.0e x sum|x| per bin, counts exact); f64 sums "
            "rounded once, max_abs_err %.3g against the f64 sum, %d values "
            "off the plain rounding at a midpoint; int8 and int16 "
            "byte-equal" % (label, cb.dtype, cb.shape[0] if cidx is None
                            else cidx.shape[0], cb.shape[1], cB, e,
                            REL_TOL, e64, off))
    again = [c for c in cases
             if c[0] in ("random", "random, idx S/2", "one bin")]
    for label, cb, cgh, _, _, cB, cidx in again:
        for f64 in (False, True):
            first = hist_mod.build_histogram(cb, cgh, cB, cidx, f64=f64)
            second = hist_mod.build_histogram(cb, cgh, cB, cidx, f64=f64)
            check(torch.equal(first.view(torch.int32),
                              second.view(torch.int32)),
                  "two %s calls on the same inputs differ [%s]"
                  % ("f64" if f64 else "f32", label))
    log("f32 and f64 determinism (%s bins): two calls on the same inputs "
        "byte-equal [%s]" % (cases[0][1].dtype, ", ".join(
            c[0] for c in again)))


#: wide bins: (B, Fp, seed) of the uint16 checks; B = 1024 at Fp = 32 is
#: phase 16's learner shape (max_bin 1023); at B = 16384 the integer
#: instances cut a feature into two slabs of 8192 bins
WIDE_SHAPES = ((512, 40, 31), (1024, 32, 32), (1024, 136, 33),
               (4096, 8, 34), (16384, 8, 35))


def phase_wide_kernels(hist_mod, errs):
    """The uint16 build of every instance (f32, f64, int8, int16) at
    B = 512, 1024, 4096 and 16384 against its plain version: random
    rows, all rows and row-index lists of half the rows, 1, 31, 33,
    1000, 1025 and 100k rows, every row in one bin, 70% of the rows in
    one bin (all and half the rows: lanes of one instruction on one
    address), every row in the last 256-bin slab, every row in the
    second slab, every row outside every slab (bins in [B, 2B),
    skipped), at Fp = 8, 32, 40 and 136 (S = 2^20 rows: the last tile of
    a row block is ragged); two f32 and two f64 calls byte-equal. Adds
    to ``errs``."""
    import torch
    S = 1 << 20
    for B, fp, seed in WIDE_SHAPES:
        bins, gh, gh8, gh16, idx = make_hist_inputs(S, fp, B, seed)
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        hot70 = torch.where(torch.rand(bins.shape, generator=g,
                                       device="cuda") < 0.7, B // 3,
                            bins.view(torch.int16).long() & 0xFFFF).to(
            torch.int16).view(torch.uint16)
        last = make_hist_inputs(S, fp, B, seed + 100, low=B - 256)[0]
        second = ((bins.view(torch.int16).long() & 0xFF) + 256).to(
            torch.int16).view(torch.uint16)
        outside = ((bins.view(torch.int16).long() & 0xFFFF) + B).to(
            torch.int16).view(torch.uint16)
        hot = torch.full_like(bins.view(torch.int16), B - 1).view(
            torch.uint16)
        cases = [("random", bins, gh, gh8, gh16, B, None),
                 ("random, idx S/2", bins, gh, gh8, gh16, B, idx)]
        cases += [("random, idx %d" % n, bins, gh, gh8, gh16, B,
                   sub_index(S, n, seed=n + B)) for n in (1, 31, 33, 1000,
                                                          1025, 100_000)]
        cases += [("one bin", hot, gh, gh8, gh16, B, None),
                  ("70% in one bin", hot70, gh, gh8, gh16, B, None),
                  ("70% in one bin, idx S/2", hot70, gh, gh8, gh16, B, idx),
                  ("last slab", last, gh, gh8, gh16, B, None),
                  ("last slab, idx S/2", last, gh, gh8, gh16, B, idx),
                  ("second slab", second, gh, gh8, gh16, B, None),
                  ("outside every slab", outside, gh, gh8, gh16, B, None),
                  ("outside every slab, idx 1025", outside, gh, gh8, gh16,
                   B, sub_index(S, 1025, seed=B))]
        check_cases(hist_mod, cases, errs, "u16_")
        del bins, gh, gh8, gh16, idx, last, second, outside, hot, hot70
        del cases


def count_buffer(idx, S: int):
    """The whole-tree loop's row list: ``idx`` in front of an [S + 1]
    buffer filled with the trash slot S, and its length as a [1] int32
    tensor on the card."""
    import torch
    n = idx.shape[0]
    buf = torch.full((S + 1,), S, dtype=torch.int32, device="cuda")
    buf[:n] = idx
    return buf, torch.tensor([n], dtype=torch.int32, device="cuda")


DEVICE_COUNT_ROWS = (0, 1, 1023, 1024, 1025, 10_000, 100_000, 1_000_000)


def phase_device_count_entry(hist_mod):
    """The device-count entry of every instance against the host-count
    launch over the same sorted row list: byte-equal at every n of
    ``DEVICE_COUNT_ROWS`` and all rows, at Fp = 32 (one feature group,
    132 row blocks at most), Fp = 136 (five groups, 26 row blocks) and
    the bundle shape Gp = 16 at Bg = 72 bins over uint8 bins, and over
    uint16 bins at B = 1024 (Fp = 32: 4 groups), B = 4096 (Fp = 8) and B
    = 16384 (Fp = 8; two 8192-bin slabs a feature for integer rows);
    n = 0 must give zeros."""
    import torch
    S = 1 << 20
    checked = 0
    for Fp, B, seed in ((32, 256, 13), (136, 256, 14), (16, 72, 15),
                        (32, 1024, 16), (8, 4096, 17), (8, 16384, 18)):
        bins, gh, gh8, gh16, _ = make_hist_inputs(S, Fp, B, seed=seed)
        for n in DEVICE_COUNT_ROWS + (S,):
            idx = sub_index(S, n, seed=n + Fp) if n < S else torch.arange(
                S, dtype=torch.int32, device="cuda")
            buf, count = count_buffer(idx, S)
            for rows, f64 in ((gh, False), (gh, True), (gh8, False),
                              (gh16, False)):
                got = hist_mod.build_histogram(bins, rows, B, buf, count,
                                               f64=f64)
                want = hist_mod.build_histogram(bins, rows, B, idx,
                                                f64=f64)
                torch.cuda.synchronize()
                check(torch.equal(got.view(torch.int32),
                                  want.view(torch.int32)),
                      "device-count entry (%s%s, %s bins, Fp=%d, B=%d, "
                      "n=%d) differs from the host-count launch"
                      % (rows.dtype, " f64 sums" if f64 else "",
                         bins.dtype, Fp, B, n))
                check(n > 0 or not got.any(),
                      "device-count entry with no rows is not zero")
                checked += 1
    log("device-count entry: byte-equal to the host-count launch in %d "
        "cases (f32, f64 sums, int8, int16; uint8 bins at Fp 32 and 136 "
        "at B 256 and the bundle shape Gp 16 at Bg 72, uint16 bins at Fp "
        "32, B 1024 and Fp 8, B 4096 and 16384; n = %s and all %d rows)"
        % (checked, ", ".join(str(n) for n in DEVICE_COUNT_ROWS), S))


# ---------------------------------------------------------------------------
# phase 5: timing at the main path's root shape and at child sizes
# ---------------------------------------------------------------------------
def hist_bound_ms(S: int, Fp: int, B: int, C: int, gh_bytes: int,
                  with_idx: bool, bin_bytes: int = 1, f64: bool = False):
    """The least time of one histogram call: its bytes once (bins, gh,
    the row list, the output) at the card's memory rate, or its adds at
    the rate of their type (f32, f64 for the f64 sums, int8 for the
    integer rows), whichever is larger."""
    moved = S * Fp * bin_bytes + S * C * gh_bytes \
        + (4 * S if with_idx else 0) + Fp * B * C * 4
    ops = S * Fp * C
    rate = (F64_OPS_PER_S if f64 else F32_OPS_PER_S) if gh_bytes == 4 \
        else INT8_OPS_PER_S
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_histogram(hist_mod, bins, gh, B, name, idx=None, f64=False):
    """Kernel, plain and ``index_add_`` ms and the bound of one call:
    all rows (warm repeats; 336 MB of bins exceed the L2 anyway), or a
    child's row-index list with the L2 flushed before each call. With
    ``f64`` the f64-sum instance (and an f64 ``index_add_``)."""
    import torch
    Fp, C = bins.shape[1], gh.shape[1]
    S = bins.shape[0] if idx is None else idx.shape[0]
    timer = cuda_ms if idx is None else cuda_ms_cold
    kernel_ms = timer(lambda: hist_mod.build_histogram(bins, gh, B, idx,
                                                       f64=f64))
    plain_ms = timer(lambda: hist_mod.histogram_plain(bins, gh, B, idx,
                                                      f64=f64),
                     reps=3, warm=1)
    acc = hist_mod.acc_dtype(gh.dtype, f64)
    rg = gh if idx is None else gh[idx.long()]
    flat = (torch.arange(Fp, dtype=torch.int64, device="cuda")[None, :]
            * B + hist_mod.bin_values(bins, idx)).reshape(-1)
    vals = rg.to(acc)[:, None, :].expand(S, Fp, C).reshape(-1, C)
    out = torch.zeros(Fp * B, C, dtype=acc, device="cuda")
    library_ms = timer(lambda: out.index_add_(0, flat, vals), reps=3,
                       warm=1)
    del flat, vals, out, rg
    bound, by = hist_bound_ms(S, Fp, B, C, gh.element_size(),
                              idx is not None, bins.element_size(), f64)
    log("%s at S=%d%s Fp=%d B=%d C=%d (%s bins): kernel %.4f ms, plain "
        "%.4f ms, index_add_ %.4f ms, bound %.4f ms (%s)"
        % (name, S, "" if idx is None else " (row-index list, L2 flushed)",
           Fp, B, C, bins.dtype, kernel_ms, plain_ms, library_ms, bound,
           by))
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound, bound_by=by)


def phase_timing(hist_mod, bins, B, errs):
    import torch
    S = bins.shape[0]
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    gh = torch.stack([torch.randn(S, generator=g, device="cuda"),
                      torch.rand(S, generator=g, device="cuda"),
                      torch.ones(S, device="cuda"),
                      torch.ones(S, device="cuda")], dim=1).contiguous()
    gh8 = torch.randint(-127, 128, (S, 4), generator=g, device="cuda",
                        dtype=torch.int32).to(torch.int8)
    q16 = (2 ** 31 - 1) // S          # the learner's 16-bit cap at S rows
    gh16 = torch.randint(-q16, q16 + 1, (S, 4), generator=g, device="cuda",
                         dtype=torch.int32).to(torch.int16)
    # the error at this shape too (f32 against an f64 plain sum)
    errs["histogram_f32"] = max(errs["histogram_f32"],
                                compare_f32(hist_mod, bins, gh, B, None))
    compare_int(hist_mod, bins, gh8, B, None)
    compare_int(hist_mod, bins, gh16, B, None)
    e64, _ = compare_f64(hist_mod, bins, gh, B, None)
    errs["histogram_f64"] = max(errs["histogram_f64"], e64)
    log("kernel check at the root shape S=%d: int8 and int16 (|q| <= %d) "
        "byte-equal, f64 sums rounded once (max_abs_err %.3g)"
        % (S, q16, e64))
    return time_instances(hist_mod, bins, B, gh, gh8, gh16, errs, "")


#: the TPU function each instance replaces. The int16 and f64 instances
#: have no Pallas counterpart: the TPU package sends int16 rows through
#: its einsum (_tile_histogram) and f64 sums through its einsum and
#: segment-sum path (build_histogram)
REPLACES = {"f32": "lightgbm_tpu/ops/histogram.py:223",
            "i8": "lightgbm_tpu/ops/histogram.py:223",
            "i16": "lightgbm_tpu/ops/histogram.py:202",
            "f64": "lightgbm_tpu/ops/histogram.py:387"}


def time_instances(hist_mod, bins, B, gh, gh8, gh16, errs, prefix):
    """One kernels-line row per instance of the bins' dtype (``prefix``
    "" for uint8, "u16_" for uint16): its ms at the root shape beside its
    bound, plain and ``index_add_`` times, at children of 10k, 100k and
    1M rows (logged), and its device-count entry at the root list and
    the children."""
    import torch
    S = bins.shape[0]
    source = ("lightgbm_tpu_torch/csrc/histogram.cu" if not prefix else
              "lightgbm_tpu_torch/csrc/histogram_u16.cu")
    rows = []
    children = [sub_index(S, n, seed=n) for n in (10_000, 100_000,
                                                   1_000_000)]
    everything = torch.arange(S, dtype=torch.int32, device="cuda")
    for tag, rows_gh, f64 in (("f32", gh, False), ("f64", gh, True),
                              ("i8", gh8, False), ("i16", gh16, False)):
        name = "histogram_" + prefix + tag
        t = time_histogram(hist_mod, bins, rows_gh, B, name, f64=f64)
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=REPLACES[tag],
            launches=0, max_abs_err=errs[name], bins=str(bins.dtype), B=B,
            **t))
        rows[-1]["children_ms"] = {
            str(idx.shape[0]): time_histogram(hist_mod, bins, rows_gh, B,
                                              name, idx, f64=f64)["ms"]
            for idx in children}
        rows[-1]["device_count_ms"] = {
            str(idx.shape[0]): time_device_count(hist_mod, bins, rows_gh, B,
                                                 name, idx, f64=f64)
            for idx in [everything] + children}
    return rows


def time_device_count(hist_mod, bins, gh, B, name, idx, f64=False):
    """ms of the device-count entry over ``idx`` (all rows: warm
    repeats; a child's list: L2 flushed before each call), beside the
    host-count launch over the same list."""
    buf, count = count_buffer(idx, bins.shape[0])
    timer = cuda_ms if idx.shape[0] == bins.shape[0] else cuda_ms_cold
    ms = timer(lambda: hist_mod.build_histogram(bins, gh, B, buf, count,
                                                f64=f64))
    host_ms = timer(lambda: hist_mod.build_histogram(bins, gh, B, idx,
                                                     f64=f64))
    log("%s device-count entry at n=%d (row-index list%s): %.4f ms; "
        "host-count launch over the same list %.4f ms"
        % (name, idx.shape[0], "" if idx.shape[0] == bins.shape[0]
           else ", L2 flushed", ms, host_ms))
    return ms


def time_scan(B: int = 256, Fp: int = 32, calls: int = 200) -> None:
    """Host-clock ms per ``find_best_split`` call on the card (a leaf
    histogram of the main path's shape), with the prefix sums in the
    reference's order (``prefix_sum``, ~35 small ops) and with one
    ``torch.cumsum`` in their place, the order-free way to take them: the scan
    is launch-bound, so this is what the order costs per split step."""
    import torch
    from lightgbm_tpu_torch import config as port_config
    from lightgbm_tpu_torch.ops import split as S
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    hist = torch.stack([torch.randn(Fp, B, generator=g, device="cuda"),
                        torch.rand(Fp, B, generator=g, device="cuda"),
                        torch.randint(0, 50, (Fp, B), generator=g,
                                      device="cuda").float(),
                        torch.randint(0, 50, (Fp, B), generator=g,
                                      device="cuda").float()], dim=2)
    sums = hist[0].sum(dim=0)
    dev = torch.device("cuda")
    meta = S.FeatureMeta(
        num_bin=torch.full((Fp,), B, dtype=torch.int32, device=dev),
        missing_type=torch.zeros(Fp, dtype=torch.int32, device=dev),
        zero_bin=torch.zeros(Fp, dtype=torch.int32, device=dev))
    params = S.SplitParams.from_config(port_config.Config.from_params(
        {"min_data_in_leaf": 100, "verbosity": -1}), dev)
    mask = torch.ones(Fp, dtype=torch.bool, device=dev)
    parent = torch.zeros((), device=dev)

    def per_call_ms():
        for _ in range(5):
            S.find_best_split(hist, *sums, meta, params, mask, parent)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            S.find_best_split(hist, *sums, meta, params, mask, parent)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / calls

    ordered = per_call_ms()
    prefix_sum = S.prefix_sum
    S.prefix_sum = lambda x: torch.cumsum(x, dim=-1)
    try:
        plain = per_call_ms()
    finally:
        S.prefix_sum = prefix_sum
    log("split scan per call (host clock, %d calls, [%d, %d, 4]): %.3f ms "
        "with prefix_sum (the reference's order), %.3f ms with one "
        "torch.cumsum" % (calls, Fp, B, ordered, plain))


# ---------------------------------------------------------------------------
# phases 3 and 4: the slice through the public API
# ---------------------------------------------------------------------------
SLICE_PARAMS = {"objective": "binary", "max_bin": 255,
                "min_data_in_leaf": 100, "learning_rate": 0.1,
                "metric": "auc", "verbosity": -1}


def tree_splits(booster):
    return [(list(t.split_feature[:t.num_internal]),
             list(t.threshold[:t.num_internal]))
            for t in booster.inner.models]


def small_datasets(lgb, extra=None):
    """Phase 3's 200k training rows and 50k held-out rows of
    ``make_higgs_like(seed=7)``, binned once with ``extra``'s binning
    parameters (one Dataset pair serves both devices and every setting
    that bins alike)."""
    X, y = make_higgs_like(SMALL_ROWS + 50_000, seed=7)
    ds = lgb.Dataset(X[:SMALL_ROWS], label=y[:SMALL_ROWS],
                     params=dict(SLICE_PARAMS, **(extra or {}))).construct()
    valid = lgb.Dataset(X[SMALL_ROWS:], label=y[SMALL_ROWS:],
                        reference=ds).construct()
    return ds, valid


def phase_small(lgb, hist_mod, extra, kernel, auc_tol, rounds=3,
                data=None):
    """Train ``rounds`` rounds at 200k rows on cuda and on cpu; tree 1
    must make the same splits, and the cuda run must go through
    ``kernel``. The held-out AUCs must agree within ``auc_tol`` where
    that is given (f32 sums run in another order on the card, so later
    trees may fork at near-ties). ``data`` is a pair of
    :func:`small_datasets` binned as ``extra`` bins (made here when
    None); both devices train on it."""
    import torch
    ds, valid = data if data is not None else small_datasets(lgb, extra)
    res = {}
    threads = torch.get_num_threads()
    for dev in ("cuda", "cpu"):
        # the CPU run is many small ops: one intra-op thread is fastest
        torch.set_num_threads(1 if dev == "cpu" else threads)
        params = dict(SLICE_PARAMS, num_leaves=63, device_type=dev, **extra)
        evals = {}
        hist_mod.reset_launch_counts()
        t0 = time.perf_counter()
        bst = lgb.train(params, ds, num_boost_round=rounds,
                        valid_sets=[valid], valid_names=["held_out"],
                        callbacks=[lgb.record_evaluation(evals)])
        log("small slice %s on %s: %.3f s" % (json.dumps(extra), dev,
                                              time.perf_counter() - t0))
        res[dev] = (tree_splits(bst)[0], evals["held_out"]["auc"][-1],
                    dict(hist_mod.launch_counts),
                    check_device_launches(hist_mod, bst, kernel, dev)
                    if dev == "cuda" else None)
    torch.set_num_threads(threads)
    check(res["cuda"][0] == res["cpu"][0],
          "tree 1 differs between cuda and cpu at %d rows (%s)"
          % (SMALL_ROWS, json.dumps(extra)))
    if auc_tol is not None:
        check(abs(res["cuda"][1] - res["cpu"][1]) <= auc_tol,
              "held-out AUC cuda %.6f vs cpu %.6f" % (res["cuda"][1],
                                                      res["cpu"][1]))
    launches = res["cuda"][3]
    check(sum(res["cpu"][2].values()) == 0, "the cpu run launched a kernel")
    log("small slice (%d rows, 63 leaves, %d round(s), %s): tree 1 splits "
        "equal on cuda and cpu; held-out AUC cuda %.6f cpu %.6f; %d "
        "launches of %s on cuda"
        % (SMALL_ROWS, rounds, json.dumps(extra), res["cuda"][1],
           res["cpu"][1], launches[kernel], kernel))
    return launches


def check_device_launches(hist_mod, bst, kernel, what, per_root=1,
                          per_step=1):
    """Every histogram of a training run went through ``kernel``: its
    device counter (graph replays included) == the learner's roots +
    split steps (times the launches a root and a step make: one per
    shard on a mesh, two children's per shard when voting), one root per
    tree, a step for every split (the whole-tree loop may run a few past
    a tree's end, with no rows), and no other instance launched. Returns
    the device counts."""
    dev = hist_mod.device_launch_counts()
    stats = bst.inner.learner.grow_stats
    trees = bst.inner.models
    splits = sum(t.num_leaves - 1 for t in trees)
    want = per_root * stats["roots"] + per_step * stats["steps"]
    check(dev[kernel] == want
          and stats["roots"] == len(trees) and stats["steps"] >= splits,
          "%s: %s device launches %d, %d x roots %d + %d x steps %d "
          "(trees %d, splits %d)" % (what, kernel, dev[kernel], per_root,
                                     stats["roots"], per_step,
                                     stats["steps"], len(trees), splits))
    check(sum(dev.values()) == dev[kernel],
          "%s: another histogram instance was launched: %s" % (what, dev))
    log("%s: %d device launches of %s == %d x %d roots + %d x %d steps "
        "(%d graph replays, %d captures) for %d splits"
        % (what, dev[kernel], kernel, per_root, stats["roots"], per_step,
           stats["steps"], stats["replays"], stats["captures"], splits))
    return dev


class _EventTimer:
    """CUDA events around every call of a function. ``patch`` is a plain
    function, so it can stand in for a module function or, set on a
    class, for a method. ``size_of(*args)``, where given, records a size
    per call (rows of a histogram)."""

    def __init__(self, fn, size_of=None):
        self.fn = fn
        self.size_of = size_of
        self.events = []
        self.sizes = []
        self.patch = lambda *args, **kwargs: self(*args, **kwargs)

    def __call__(self, *args, **kwargs):
        import torch
        if torch.cuda.is_current_stream_capturing():
            # a graph capture runs the call once and its replays not at
            # all: only eager calls are timed
            return self.fn(*args, **kwargs)
        if self.size_of is not None:
            self.sizes.append(self.size_of(*args, **kwargs))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args, **kwargs)
        end.record()
        self.events.append((start, end))
        return out

    def each_ms(self):
        return [a.elapsed_time(b) for a, b in self.events]

    def total_ms(self) -> float:
        return sum(self.each_ms())


def hist_rows(bins, gh, num_bins, idx=None, count=None, f64=False):
    """Rows summed by one ``build_histogram`` call; a count on the
    device is kept as a copy (no host read in the call) and read after
    the run."""
    if count is not None:
        return count.clone()
    return bins.shape[0] if idx is None else idx.shape[0]


ROW_BUCKETS = (1_000, 10_000, 100_000, 1_000_000)


def log_launch_sizes(timer: _EventTimer, kernel: str) -> None:
    """Launches and kernel ms summed by rows per launch."""
    edges = (0,) + ROW_BUCKETS + (float("inf"),)
    sizes = [int(n) for n in timer.sizes]
    parts = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        ms = [t for n, t in zip(sizes, timer.each_ms())
              if lo <= n < hi]
        parts.append("[%s, %s): %d launches, %.3f ms"
                     % (lo, "inf" if hi == float("inf") else int(hi),
                        len(ms), sum(ms)))
    log("%s by rows per launch: %s" % (kernel, "; ".join(parts)))


#: phase 15e's rows: the first LINEAR_ROWS training rows of full_data
LINEAR_ROWS = 1 << 21
HEAD = {}


def full_data(lgb, keep_head=False):
    """The full-size data of phases 4 and 7: 10.5M Higgs-shaped training
    rows binned at max_bin 255, and a 500k held-out set. With
    ``keep_head`` a copy of the first LINEAR_ROWS training rows and
    labels stays in ``HEAD`` (phases 15, 16, 19 and 22 bin or spill them
    again)."""
    t0 = time.perf_counter()
    X, y = make_higgs_like(FULL_ROWS + HELD_OUT_ROWS)
    Xt, yt = X[:FULL_ROWS], y[:FULL_ROWS]
    Xv, yv = X[FULL_ROWS:], y[FULL_ROWS:]
    if keep_head:
        HEAD["X"] = X[:LINEAR_ROWS].copy()
        HEAD["y"] = y[:LINEAR_ROWS].copy()
    log("full size: generated %d + %d rows x %d in %.1f s"
        % (FULL_ROWS, HELD_OUT_ROWS, X.shape[1], time.perf_counter() - t0))
    t0 = time.perf_counter()
    ds = lgb.Dataset(Xt, label=yt, params=SLICE_PARAMS).construct()
    valid = lgb.Dataset(Xv, label=yv, reference=ds).construct()
    log("binning seconds: %.3f" % (time.perf_counter() - t0))
    return ds, valid, Xv, yv


def train_full(lgb, hist_mod, data, extra, kernel, rounds=5, tag=None):
    """Train the full-size data through ``lightgbm_tpu_torch.train``
    (:func:`train_path`). Returns (booster, launches, held-out AUC per
    round, seconds per iteration, quantize ms per tree)."""
    ds, valid, _, _ = data
    run = train_path(lgb, hist_mod, ds, valid,
                     dict(SLICE_PARAMS, num_leaves=255, **extra), kernel,
                     rounds, tag=tag)
    return (run["booster"], run["launches"], run["evals"]["auc"],
            run["per_iter"], run["quant_ms"])


class _StageTimer(_EventTimer):
    """An :class:`_EventTimer` that also reads the device memory a call
    needs above what was allocated when it started (peak during the
    call, from ``torch.cuda.max_memory_allocated``). The peak counter is
    reset per call, so the caller's own peak is kept in ``outer_peak``."""

    def __init__(self, fn):
        super().__init__(fn)
        self.peaks = []
        self.outer_peak = 0

    def __call__(self, *args, **kwargs):
        import torch
        self.outer_peak = max(self.outer_peak,
                              torch.cuda.max_memory_allocated())
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = super().__call__(*args, **kwargs)
        torch.cuda.synchronize()
        self.peaks.append(torch.cuda.max_memory_allocated() - before)
        return out


def train_path(lgb, hist_mod, ds, valid, params, kernel, rounds,
               grad_cls=None, tag=None, extra_syncs=0, per_root=1,
               per_step=1):
    """Train through ``lightgbm_tpu_torch.train`` with the launch counts
    set to 0 just before and read just after; every histogram must go
    through ``kernel`` (:func:`check_device_launches`: its device
    counter == roots + split steps summed over all trees, K per
    iteration for multiclass; no other instance launched). Each tree's
    host syncs are counted with ``torch.cuda.set_sync_debug_mode("warn")``
    around the learner's ``train``; in the whole-tree loop they must stay
    within ``ceil((L - 1) / FUSED_CHUNK) + 2``. CUDA events time every
    eager histogram, scan and quantize call (a graph replay runs none of
    them through Python), and, when ``grad_cls`` names the objective's
    class, every gradient call with the device memory it needs.
    ``extra_syncs`` widens the sync bound by the syncs a tree is asked to
    make on top (a fenced stage). ``per_root`` / ``per_step``: the
    kernel launches of a root and of a step (a mesh learner's shards).
    Returns a dict of the run's numbers."""
    import torch
    from lightgbm_tpu_torch.parallel import data_parallel, feature_parallel
    from lightgbm_tpu_torch.treelearner import serial
    tag = tag or json.dumps({k: v for k, v in params.items()
                             if k not in SLICE_PARAMS})
    hist_timer = _EventTimer(serial.build_histogram, hist_rows)
    scan_timer = _EventTimer(serial.find_best_split)
    # the mesh learners' own references to the kernel's wrapper and the
    # scan are timed too
    patched = [(m, "build_histogram", hist_timer)
               for m in (serial, data_parallel, feature_parallel)] + [
        (m, "find_best_split", scan_timer)
        for m in (serial, feature_parallel)]
    quant_timer = _EventTimer(serial.SerialTreeLearner._quantize_stage)
    grad_timer = (_StageTimer(grad_cls.get_gradients) if grad_cls
                  else None)
    grow = serial.SerialTreeLearner.train
    tree_seconds, tree_syncs = [], []

    def timed_grow(self, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = grow(self, *args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        tree_seconds.append(time.perf_counter() - t)
        tree_syncs.append(sum("synchroniz" in str(w.message)
                              for w in caught))
        return out
    iter_starts = []

    def mark(env):
        torch.cuda.synchronize()
        iter_starts.append(time.perf_counter())
    mark.before_iteration = True
    evals = {}
    for mod, name, timer in patched:
        setattr(mod, name, timer.patch)
    serial.SerialTreeLearner._quantize_stage = quant_timer.patch
    serial.SerialTreeLearner.train = timed_grow
    if grad_timer:
        grad_cls.get_gradients = grad_timer.patch
    torch.cuda.reset_peak_memory_stats()
    hist_mod.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        bst = lgb.train(params, ds, num_boost_round=rounds,
                        valid_sets=[valid], valid_names=["held_out"],
                        callbacks=[mark, lgb.record_evaluation(evals)])
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
    finally:
        for mod, name, timer in patched:
            setattr(mod, name, timer.fn)
        serial.SerialTreeLearner._quantize_stage = quant_timer.fn
        serial.SerialTreeLearner.train = grow
        if grad_timer:
            grad_cls.get_gradients = grad_timer.fn
    peak = max(torch.cuda.max_memory_allocated(),
               grad_timer.outer_peak if grad_timer else 0)
    iter_starts.append(time.perf_counter())
    per_iter = list(np.diff(iter_starts))
    trees = bst.inner.models
    K = bst.inner.num_tree_per_iteration
    splits = sum(t.num_leaves - 1 for t in trees)
    SPLIT_MS[tag] = 1e3 * sum(tree_seconds) / max(splits, 1)
    TREE_SYNCS[tag] = list(tree_syncs)
    check(len(trees) == rounds * K, "expected %d trees, got %d"
          % (rounds * K, len(trees)))
    check(all(t.num_leaves > 1 for t in trees), "a tree has one leaf")
    launches = check_device_launches(hist_mod, bst, kernel, tag, per_root,
                                     per_step)
    learner = bst.inner.learner
    stats = learner.grow_stats
    # the loop the config asks for: per-node masks and CEGB take the
    # per-split loop whatever tpu_fused_tree says. The whole-tree loop
    # reads one record buffer per tree and no split record; the
    # per-split loop one record per split (one more for a tree that ends
    # before num_leaves) and no record buffer
    # (and so do the intermediate and advanced monotone methods, which
    # read one more record after each split's rescans); forced splits
    # read one record each before either loop
    mono = learner._mono_tracker is not None
    fused = (learner._fused_growth and not learner._cegb_enabled
             and not mono and (learner._forced is not None
                               or not learner._needs_per_node_masks()))
    forced = stats["forced_reads"]
    if fused:
        check(stats["split_reads"] == 0
              and stats["record_reads"] == len(trees),
              "%s: the whole-tree loop read %d split records and %d "
              "record buffers for %d trees" % (
                  tag, stats["split_reads"], stats["record_reads"],
                  len(trees)))
    else:
        most = (2 * splits if mono else splits) + len(trees)
        check(stats["record_reads"] == 0
              and splits - forced <= stats["split_reads"] <= most,
              "%s: the per-split loop read %d record buffers and %d split "
              "records for %d splits in %d trees" % (
                  tag, stats["record_reads"], stats["split_reads"], splits,
                  len(trees)))
    # a forced split is a host-stepped split with two host syncs: the
    # read of its record (``tolist``) and the partition's ``nonzero``
    # (SerialTreeLearner._apply_forced and _split)
    sync_bound = (math.ceil((learner.L - 1) / serial.FUSED_CHUNK) + 2
                  + math.ceil(2 * forced / len(trees)) + extra_syncs)
    if fused:
        check(max(tree_syncs) <= sync_bound,
              "%s: %d host syncs in a tree, more than ceil((L-1)/%d) + 2 "
              "(+ 2 per forced split) = %d"
              % (tag, max(tree_syncs), serial.FUSED_CHUNK, sync_bound))
    hist_ms = hist_timer.total_ms()
    quant_ms = quant_timer.each_ms()
    log("train %s: %.3f s for %d rounds (%d trees); seconds per tree: %s; "
        "seconds per iteration (trees + gradients + held-out eval): %s; "
        "leaves per tree: %s"
        % (tag, t_train, rounds, len(trees),
           " ".join("%.3f" % v for v in tree_seconds),
           " ".join("%.3f" % v for v in per_iter),
           [t.num_leaves for t in trees]))
    log("%s loop: ms per split (tree seconds / splits): %s; host syncs per "
        "tree: %s (sync debug mode; bound for the whole-tree loop "
        "ceil((L-1)/%d) + 2, plus 2 per forced split = %d); graph "
        "captures %d, capture ms %.1f; "
        "replays per tree %.1f; device launches of %s %d == roots %d + "
        "steps %d (replays %d), splits %d; counter reads %d, record "
        "reads %d"
        % ("whole-tree" if fused else "per-split",
           " ".join("%.3f" % (1e3 * s / max(t.num_leaves - 1, 1))
                    for s, t in zip(tree_seconds, trees)),
           " ".join(str(v) for v in tree_syncs), serial.FUSED_CHUNK,
           sync_bound, stats["captures"], stats["capture_ms"],
           stats["replays"] / len(trees), kernel, launches[kernel],
           stats["roots"], stats["steps"], stats["replays"], splits,
           stats["flag_reads"], stats["record_reads"]))
    log("eager histogram calls: %.1f ms = %.1f%% of tree time (%.3f s), "
        "%d calls%s"
        % (hist_ms, 100.0 * hist_ms / 1e3 / sum(tree_seconds),
           sum(tree_seconds), len(hist_timer.events),
           "; quantize stage ms per tree: " + " ".join(
               "%.3f" % v for v in quant_ms) if quant_ms else ""))
    log_launch_sizes(hist_timer, kernel)
    scan_ms = scan_timer.each_ms()
    log("split scan: %d eager calls, %.3f ms each on average (CUDA "
        "events)" % (len(scan_ms), float(np.mean(scan_ms)) if scan_ms
                     else 0.0))
    grad_ms = grad_timer.each_ms() if grad_timer else []
    if grad_timer:
        log("gradient stage (%s.get_gradients, CUDA events) ms per "
            "iteration: %s; device memory it needs above its inputs: "
            "%.3f GiB at most"
            % (grad_cls.__name__, " ".join("%.3f" % v for v in grad_ms),
               max(grad_timer.peaks) / 2 ** 30))
    log("peak torch.cuda.max_memory_allocated: %.3f GiB"
        % (peak / 2 ** 30))
    return dict(booster=bst, launches=launches,
                evals=evals["held_out"], per_iter=per_iter,
                tree_seconds=tree_seconds, quant_ms=quant_ms,
                grad_ms=grad_ms, peak=peak, tree_syncs=tree_syncs,
                splits=splits, fused=fused)


#: mean ms per split of each training run (tree seconds / splits), by tag
SPLIT_MS = {}
#: host syncs of each tree of each training run, by tag
TREE_SYNCS = {}
#: the tag of phase 4's run
PHASE4_TAG = json.dumps({"num_leaves": 255})
#: the tag of phase 7's run
PHASE7_TAG = json.dumps({"num_leaves": 255, "use_quantized_grad": True,
                         "quant_grad_bits": 8})


def check_predict(bst, data, device_auc):
    """Host-walk predictions of the held-out set: finite, of the right
    shape, AUC > 0.7 and equal to the device valid-score AUC."""
    _, _, Xv, yv = data
    t0 = time.perf_counter()
    pred = bst.predict(Xv, predict_on_device=False)
    t_pred = time.perf_counter() - t0
    check(pred.shape == (HELD_OUT_ROWS,) and bool(np.isfinite(pred).all()),
          "predictions are not finite or of the wrong shape")
    a = auc(yv, pred)
    check(a > 0.7, "held-out AUC %.4f <= 0.7" % a)
    check(abs(a - device_auc[-1]) < 1e-4,
          "host-walk AUC %.6f != device valid-score AUC %.6f"
          % (a, device_auc[-1]))
    log("predict (host walk): %d rows in %.3f s = %.0f rows/s; held-out "
        "AUC %.6f (per round: %s)"
        % (HELD_OUT_ROWS, t_pred, HELD_OUT_ROWS / t_pred, a,
           " ".join("%.6f" % v for v in device_auc)))
    return a


def loops_agree(lgb, hist_mod, ds, valid, params, what):
    """``RERUN_ROUNDS`` rounds at ``CUT_LEAVES`` leaves through the
    whole-tree loop and through the per-split loop must give the same
    trees, text for text."""
    cut = dict(params, num_leaves=CUT_LEAVES)
    trees = []
    for fused, loop in ((True, "whole-tree"), (False, "per-split")):
        bst = train_path(lgb, hist_mod, ds, valid,
                         dict(cut, tpu_fused_tree=fused), "histogram_f32",
                         RERUN_ROUNDS, tag="%s %s, %d leaves"
                         % (what, loop, CUT_LEAVES))["booster"]
        trees.append([t.to_string() for t in bst.inner.models])
        del bst
    check(trees[0] == trees[1], "a per-split %s run gave other trees than "
          "the whole-tree run" % what)
    log("%s at %d leaves (%d round(s)): all %d trees text-equal through "
        "the whole-tree and the per-split loop"
        % (what, CUT_LEAVES, RERUN_ROUNDS, len(trees[0])))


def check_rerun(lgb, hist_mod, data, extra, kernel, bst, what,
                rounds=RERUN_ROUNDS):
    """A second run of ``rounds`` rounds through the per-split loop must
    give the first (whole-tree) run's first trees, text for text."""
    again, _, _, _, _ = train_full(lgb, hist_mod, data,
                                   dict(extra, tpu_fused_tree=False),
                                   kernel, rounds=rounds)
    first = [t.to_string() for t in bst.inner.models[:rounds]]
    second = [t.to_string() for t in again.inner.models]
    check(first == second, "a per-split %s run gave other trees than the "
          "whole-tree run" % what)
    log("%s per-split rerun (%d round(s)): the first %d tree(s) text-equal "
        "to the whole-tree run's" % (what, rounds, rounds))


def phase_full(lgb, hist_mod, data):
    """The main path at full size (f32 gradients), and a 1-round rerun
    that must give the same trees (the f32 histograms and scans are
    deterministic); returns (booster, launches, held-out AUC per round,
    seconds per iteration)."""
    bst, launches, aucs, per_iter, _ = train_full(lgb, hist_mod, data, {},
                                                  "histogram_f32")
    check_predict(bst, data, aucs)
    check_stacked(bst, data[2], "phase 4 higgs")
    check_rerun(lgb, hist_mod, data, {}, "histogram_f32", bst, "f32")
    return bst, launches, aucs, per_iter


# ---------------------------------------------------------------------------
# phase 6: quantized rows on the card against the CPU
# ---------------------------------------------------------------------------
def phase_quantize():
    """``uniform`` and ``quantize_gh`` at N = 10.5M on cuda and cpu from
    the same inputs and key: byte-equal (integer threefry and IEEE f32
    division are exact on both)."""
    import torch
    from lightgbm_tpu_torch.ops import quantize as Q
    from lightgbm_tpu_torch.utils import prng
    N = FULL_ROWS
    rng = np.random.RandomState(11)
    # binary-objective-like rows: grad = p - y in (-1, 1), hess = p(1-p)
    p = rng.rand(N).astype(np.float32)
    y = (rng.rand(N) < 0.5).astype(np.float32)
    host = {"grad": p - y, "hess": p * (1.0 - p),
            "ind": (rng.rand(N) < 0.8).astype(np.float32)}
    out = {}
    for dev in ("cuda", "cpu"):
        t = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        key = Q.tree_key(prng.PRNGKey(0, dev), 1)
        res = {"u": prng.uniform(key, (N, 2)).view(torch.int32)}
        for bits in (8, 16):
            qmax = Q.effective_quant_max(bits, N)
            gh, qs = Q.quantize_gh(t["grad"], t["hess"], t["ind"], key,
                                   qmax, Q.quant_dtype(bits))
            res["gh%d" % bits] = gh
            res["qscale%d" % bits] = qs.view(torch.int32)
        if dev == "cuda":
            torch.cuda.synchronize()
            ms = {
                "uniform": cuda_ms(lambda: prng.uniform(key, (N, 2)),
                                   reps=5, warm=1),
                "quantize_gh_8": cuda_ms(lambda: Q.quantize_gh(
                    t["grad"], t["hess"], t["ind"], key,
                    Q.effective_quant_max(8, N), torch.int8),
                    reps=5, warm=1)}
        out[dev] = {k: v.cpu() for k, v in res.items()}
    for k in out["cpu"]:
        check(torch.equal(out["cuda"][k], out["cpu"][k]),
              "quantized rows differ between cuda and cpu: %s" % k)
    log("quantize at N=%d: uniform bits, int8 and int16 rows and scales "
        "byte-equal on cuda and cpu (qmax 8-bit %d, 16-bit %d); card "
        "uniform %.3f ms, quantize_gh 8-bit %.3f ms"
        % (N, Q.effective_quant_max(8, N), Q.effective_quant_max(16, N),
           ms["uniform"], ms["quantize_gh_8"]))


# ---------------------------------------------------------------------------
# phase 7: quantized training at full size
# ---------------------------------------------------------------------------
def phase_full_quantized(lgb, hist_mod, data, f32_auc):
    """Quantized-gradient training (8 bits) on the data of phase 4; a
    per-split rerun of 1 round must give the same first tree. Returns the
    launches, the trees, the held-out AUC per round and the seconds per
    iteration."""
    extra = {"use_quantized_grad": True, "quant_grad_bits": 8}
    bst, launches, aucs, per_iter, quant_ms = train_full(
        lgb, hist_mod, data, extra, "histogram_i8")
    a = check_predict(bst, data, aucs)
    log("quantized (8-bit) vs f32 held-out AUC: %.6f vs %s (gap %s); "
        "mean seconds per iteration %.3f; mean quantize ms per tree %.3f"
        % (a, "%.6f" % f32_auc if f32_auc is not None else "not run",
           "%+.6f" % (a - f32_auc) if f32_auc is not None else "n/a",
           float(np.mean(per_iter)), float(np.mean(quant_ms))))
    check_rerun(lgb, hist_mod, data, extra, "histogram_i8", bst,
                "quantized")
    return launches, bst.inner.models, aucs, per_iter


# ---------------------------------------------------------------------------
# phase 9: multiclass at Covertype's shape
# ---------------------------------------------------------------------------
# Covertype's class shares (classes 1..7 as labels 0..6) and the order of
# the classes along the synthetic elevation-like latent, as the forest
# types lie along elevation: Cottonwood, Ponderosa, Douglas-fir, Aspen,
# Lodgepole, Spruce/Fir, Krummholz
COVERTYPE_SHARES = (0.365, 0.488, 0.062, 0.005, 0.016, 0.030, 0.035)
COVERTYPE_ORDER = (3, 2, 5, 4, 1, 0, 6)


def make_covertype_like(n: int, seed: int):
    """Covertype-shaped synthetic rows: 10 numeric columns (elevation,
    aspect, slope, distances and hillshades), 4 one-hot wilderness
    columns and 40 one-hot soil columns; 7 classes with Covertype's
    shares, cut from a noisy latent of the columns at the shares'
    quantiles."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 54), dtype=np.float32)
    elev = rng.normal(0.0, 1.0, n)
    X[:, 0] = 2960 + 280 * elev                          # elevation
    X[:, 1] = rng.uniform(0, 360, n)                     # aspect
    X[:, 2] = rng.gamma(3.0, 4.5, n)                     # slope
    X[:, 3] = rng.gamma(1.5, 180, n)                     # to hydrology
    X[:, 4] = rng.normal(46, 58, n)                      # vertical
    X[:, 5] = rng.gamma(1.8, 1300, n)                    # to roadways
    X[:, 6] = np.clip(rng.normal(212, 27, n), 0, 254)    # hillshade 9am
    X[:, 7] = np.clip(rng.normal(223, 20, n), 0, 254)    # noon
    X[:, 8] = np.clip(rng.normal(143, 38, n), 0, 254)    # 3pm
    X[:, 9] = rng.gamma(2.0, 1000, n)                    # to fire points
    wild = rng.choice(4, n, p=(0.45, 0.05, 0.44, 0.06))
    soil_p = rng.dirichlet(np.full(40, 0.5))
    soil = rng.choice(40, n, p=soil_p)
    X[np.arange(n), 10 + wild] = 1.0
    X[np.arange(n), 14 + soil] = 1.0
    soil_effect = np.random.RandomState(seed + 1000).normal(0, 0.5, 40)
    latent = (elev + np.array((0.3, -0.4, 0.1, -0.6))[wild]
              + soil_effect[soil] + 0.2 * np.cos(np.radians(X[:, 1]))
              - 0.01 * X[:, 2] + 0.0003 * (X[:, 5] - 2340)
              + 0.4 * rng.randn(n))
    cuts = np.quantile(latent, np.cumsum(
        [COVERTYPE_SHARES[c] for c in COVERTYPE_ORDER])[:-1])
    y = np.asarray(COVERTYPE_ORDER)[np.searchsorted(cuts, latent)]
    return X, y.astype(np.float64)


def covertype_splits(Xt, yt, Xv, yv, lgb, params):
    """The training and held-out Datasets of a Covertype-shaped run."""
    ds = lgb.Dataset(Xt, label=yt, params=params).construct()
    valid = lgb.Dataset(Xv, label=yv, reference=ds).construct()
    return ds, valid


def check_multiclass(bst, run, Xv, yv, what):
    """The phase 9 checks of a 7-class run: held-out multi_logloss falls
    every round, multi_error ends below the majority class's, the device
    validation scores equal the host walk within 1e-4, the probabilities
    sum to 1, and the stacked path (auto mode) equals the host walk."""
    evals = run["evals"]
    loss, err = evals["multi_logloss"], evals["multi_error"]
    check(all(b < a for a, b in zip(loss, loss[1:])),
          "%s: held-out multi_logloss did not fall every round: %s"
          % (what, loss))
    majority_error = 1.0 - max(COVERTYPE_SHARES)
    check(err[-1] < majority_error,
          "%s: held-out multi_error %.4f is not below the majority-class "
          "error %.3f" % (what, err[-1], majority_error))
    host = bst.predict(Xv, raw_score=True, predict_on_device=False)
    dev = bst.inner.valid_data[0].scores
    check(host.shape == dev.shape == (len(yv), 7)
          and bool(np.isfinite(host).all()),
          "%s: raw scores are not finite or of the wrong shape" % what)
    gap = float(np.abs(host - dev).max())
    check(gap <= 1e-4, "%s: host-walk scores differ from the device "
          "validation scores by %.3g" % (what, gap))
    prob = bst.predict(Xv, predict_on_device=False)
    check(bool(np.allclose(prob.sum(axis=1), 1.0)),
          "%s: class probabilities do not sum to 1" % what)
    check_stacked(bst, Xv, what)
    learner = bst.inner.learner
    log("%s: held-out multi_logloss %s; multi_error %s (majority-class "
        "error %.3f); host walk vs device scores max |diff| %.3g; mean "
        "seconds per iteration %.3f; ms per split (mean over trees) %.3f; "
        "peak memory %.3f GiB; gradient ms per iteration %s"
        % (what, " ".join("%.6f" % v for v in loss),
           " ".join("%.6f" % v for v in err), majority_error, gap,
           float(np.mean(run["per_iter"])),
           1e3 * sum(run["tree_seconds"]) / max(run["splits"], 1),
           run["peak"] / 2 ** 30,
           " ".join("%.3f" % v for v in run["grad_ms"])))
    return learner


def first_tree_cuda_vs_cpu(lgb, Xt, yt, params, what, sub=50_000,
                           categorical_feature=None):
    """Tree 1 (class 0) at ``sub`` rows and ``CROSS_LEAVES`` leaves with
    8-bit gradients (integer histograms: the same sums in any order) on
    cuda and on cpu."""
    first = {}
    for dev_type in ("cuda", "cpu"):
        sds = lgb.Dataset(Xt[:sub], label=yt[:sub],
                          categorical_feature=categorical_feature)
        b = lgb.train(dict(params, device_type=dev_type,
                           num_leaves=CROSS_LEAVES,
                           use_quantized_grad=True, quant_grad_bits=8),
                      sds, num_boost_round=1)
        t = b.inner.models[0]
        first[dev_type] = (tree_splits_of(t), list(t.cat_boundaries),
                           list(t.cat_threshold),
                           list(t.leaf_count[:t.num_leaves]))
    check(first["cuda"] == first["cpu"],
          "%s: 8-bit tree 1 (class 0) differs between cuda and cpu at %d "
          "rows" % (what, sub))
    log("%s 8-bit at %d rows: tree 1 (class 0) makes the same %d splits "
        "(categories and leaf counts too) on cuda and cpu"
        % (what, sub, first["cuda"][0][0] - 1))


def phase_covertype(lgb, hist_mod):
    """Multiclass (softmax, 7 classes, K = 7 trees per iteration) at
    Covertype's shape: 581,012 training rows x 54 columns, 255 leaves,
    ``MULTICLASS_ROUNDS`` rounds, with EFB at its default (``enable_bundle=true``): the 44
    one-hot columns bundle and the kernel runs over the bundle columns.
    Then a 2-round unbundled run (held-out loss within 1e-4; the f32
    prediction gap printed), the bundled histograms held against f64
    sums over the unbundled bins and both learners timed on the same
    gradients, the same rows as a scipy CSR matrix (bins byte-equal, 2
    rounds text-equal), the LUT-node encoding of the stacked forest, 2
    rounds with 8-bit gradients bundled and unbundled (text-equal), and
    an 8-bit run on a 50k-row subset on cuda and cpu. Returns the
    launches by path and the learner's bundle columns with their width,
    for timing."""
    import scipy.sparse as sp
    from lightgbm_tpu_torch.objective.multiclass import MulticlassSoftmax
    t0 = time.perf_counter()
    X, y = make_covertype_like(COVERTYPE_ROWS + COVERTYPE_HELD_OUT, seed=9)
    Xt, yt = X[:COVERTYPE_ROWS], y[:COVERTYPE_ROWS]
    Xv, yv = X[COVERTYPE_ROWS:], y[COVERTYPE_ROWS:]
    shares = np.bincount(yt.astype(int), minlength=7) / len(yt)
    params = {"objective": "multiclass", "num_class": 7, "num_leaves": 255,
              "learning_rate": 0.1, "max_bin": 255,
              "metric": "multi_logloss,multi_error", "verbosity": -1}
    t_gen = time.perf_counter() - t0
    ds, valid = covertype_splits(Xt, yt, Xv, yv, lgb, params)
    lay = ds.handle.bundle
    check(lay is not None, "covertype: the one-hot columns did not bundle")
    log("covertype-like: %d + %d rows x %d, class shares %s; generated in "
        "%.1f s, binned in %.1f s; EFB: %d features in %d bundle columns "
        "(%d of them shared: %s), %d bundle bins"
        % (len(yt), len(yv), X.shape[1],
           " ".join("%.3f" % v for v in shares), t_gen,
           time.perf_counter() - t0 - t_gen, ds.handle.num_features,
           lay.num_groups, sum(len(g) > 1 for g in lay.groups),
           [len(g) for g in lay.groups if len(g) > 1],
           lay.num_bundled_bins))
    run = train_path(lgb, hist_mod, ds, valid, params, "histogram_f32",
                     MULTICLASS_ROUNDS, grad_cls=MulticlassSoftmax,
                     tag="covertype multiclass bundled")
    bst = run["booster"]
    learner = check_multiclass(bst, run, Xv, yv, "phase 9 covertype")
    check(learner._bundled and learner.bins.shape[1] == learner.Gp,
          "covertype: the learner does not hold the bundle columns")
    log("phase 9 covertype bundled: G = %d (Gp = %d) bundle columns at "
        "Bg = %d bins, against Fp = %d features at B = %d"
        % (lay.num_groups, learner.Gp, learner.Bg, learner.Fp, learner.B))
    loops_agree(lgb, hist_mod, ds, valid, params, "covertype bundled")
    R = RERUN_ROUNDS
    launches = {"phase9_covertype_bundled": run["launches"]["histogram_f32"]}
    # unbundled, 2 rounds, against the reference's contract for bundles
    # (tests/test_efb.py::test_bundled_matches_unbundled_predictions,
    # rtol 1e-4 at 2,000 rows). In f32 a bundled feature's zero bin is
    # summed from other bins than the unbundled one's rows, and sibling
    # subtraction carries that rounding (an ulp of the root's sums) into
    # small leaves, so the f32 gap is measured and held at level (c):
    # the held-out loss within 1e-4, and the bundled histograms within
    # the f32 tolerance of their f64 sums (check_bundled_histograms);
    # the 8-bit pair below, with exact integer histograms, must be
    # text-equal
    p0 = dict(params, enable_bundle=False)
    ds0, valid0 = covertype_splits(Xt, yt, Xv, yv, lgb, p0)
    unb = train_path(lgb, hist_mod, ds0, valid0, p0, "histogram_f32", 2,
                     tag="covertype unbundled 2 rounds")
    plain = unb["booster"]
    check(not plain.inner.learner._bundled, "enable_bundle=false bundled")
    p_b = bst.predict(Xv, num_iteration=2, predict_on_device=False)
    p_u = plain.predict(Xv, predict_on_device=False)
    same = sum(tree_structure(a) == tree_structure(b)
               for a, b in zip(bst.inner.models[:14], plain.inner.models))
    gap = np.abs(p_b - p_u)
    within = bool(np.allclose(p_b, p_u, rtol=1e-4, atol=1e-5))
    loss_gap = abs(run["evals"]["multi_logloss"][1]
                   - unb["evals"]["multi_logloss"][1])
    log("covertype bundled vs unbundled, f32 (2 rounds): %d of 14 trees "
        "structure-equal; predictions max |diff| %.3g, %.4f%% of values "
        "beyond rtol 1e-4 + atol 1e-5 (all within: %s); held-out "
        "multi_logloss round 2 %.6f vs %.6f"
        % (same, float(gap.max()),
           100.0 * float(np.mean(gap > 1e-5 + 1e-4 * np.abs(p_u))), within,
           run["evals"]["multi_logloss"][1],
           unb["evals"]["multi_logloss"][1]))
    check(loss_gap <= 1e-4, "bundled and unbundled held-out multi_logloss "
          "differ by %.3g" % loss_gap)
    diff = first_split_difference(bst.inner.models[:14],
                                  plain.inner.models)
    if diff is not None:
        t, i, u, v = diff
        log("covertype bundled vs unbundled, f32 (2 rounds): the first "
            "split that differs is split %d of tree %d (class %d of "
            "iteration %d): bundled (feature, bin, type, gain) %s, "
            "unbundled %s" % (i + 1, t, t % 7, t // 7, u, v))
    time_bundled_step(bst.inner.learner, plain.inner.learner, hist_mod,
                      tree0_gradients(lgb, ds, params))
    del plain, unb
    # the same rows as a CSR matrix
    t0 = time.perf_counter()
    Xs = sp.csr_matrix(Xt)
    dss, valids = covertype_splits(Xs, yt, Xv, yv, lgb, params)
    t_sparse = time.perf_counter() - t0
    check(dss.handle.bins.tobytes() == ds.handle.bins.tobytes(),
          "CSR bins differ from the dense bundled bins")
    sparse = train_path(lgb, hist_mod, dss, valids, params, "histogram_f32",
                        R, tag="covertype CSR")["booster"]
    check([t.to_string() for t in bst.inner.models[:7 * R]]
          == [t.to_string() for t in sparse.inner.models],
          "CSR covertype run gave other trees than the dense run")
    log("covertype as a CSR matrix (%d stored values): bins byte-equal to "
        "the dense bundled bins (built in %.1f s); %d round(s) text-equal "
        "to the dense run's" % (Xs.nnz, t_sparse, R))
    del sparse, dss, valids, Xs
    time_lut_encoding(bst, Xv, "phase 9 covertype bundled")
    bins = (learner.bins, learner.Bg)
    del bst, learner
    q8 = dict(params, use_quantized_grad=True, quant_grad_bits=8)
    qrun = train_path(lgb, hist_mod, ds, valid, q8, "histogram_i8", R,
                      tag="covertype multiclass bundled 8-bit")
    launches["phase9_covertype_bundled_8bit"] = \
        qrun["launches"]["histogram_i8"]
    qplain = train_path(lgb, hist_mod, ds0, valid0,
                        dict(q8, enable_bundle=False), "histogram_i8", R,
                        tag="covertype multiclass unbundled 8-bit")
    check([t.to_string() for t in qrun["booster"].inner.models]
          == [t.to_string() for t in qplain["booster"].inner.models],
          "8-bit bundled and unbundled covertype runs gave other trees")
    log("covertype 8-bit: bundled and unbundled %d-round runs text-equal "
        "(all %d trees; integer histograms, exact zero bins); held-out "
        "multi_logloss %s (f32 %s)"
        % (R, 7 * R,
           " ".join("%.6f" % v for v in qrun["evals"]["multi_logloss"]),
           " ".join("%.6f" % v for v in run["evals"]["multi_logloss"][:R])))
    del qrun, qplain, ds0, valid0
    first_tree_cuda_vs_cpu(lgb, Xt, yt, params, "phase 9 covertype")
    return launches, bins


def check_bundled_histograms(bundled, unbundled, gh, hist_mod):
    """The bundled learner's f32 histograms against f64 sums over the
    unbundled learner's bins, on the same rows: the root (totals from
    ``sum_gh``, as ``_root`` passes them) and the smaller child of the
    root's winning split (totals from its record row, as ``_step``
    passes them). Counts must be exact, so totals of other rows than
    the leaf's fail there. A grad/hess bin may be off by ``REL_TOL``
    times the f64 sum of its rows' absolute values (the bound of
    :func:`compare_f32`); a rebuilt zero bin (totals minus the feature's
    other bins) carries the rounding of the totals, which sum every row
    of the leaf at the root and come from the root's histogram for the
    child, so its bound is ``REL_TOL`` times the root's absolute sum.
    The unbundled kernel
    is held to the same per-bin bound, and the largest bundled -
    unbundled difference is printed."""
    import torch
    from lightgbm_tpu_torch.ops import split as S
    from lightgbm_tpu_torch.ops.quantize import sum_gh
    check(bundled.B == unbundled.B and bundled.F == unbundled.F,
          "bundled and unbundled learners differ in shape")
    B, F = bundled.B, bundled.F       # pad features past F hold nothing
    bt = bundled._btab
    zero_at = torch.zeros((bundled.Fp, B), dtype=torch.bool,
                          device=gh.device)
    zero_at[torch.arange(bundled.Fp, device=gh.device),
            bundled.meta.zero_bin.long()] = bt.zero_fix
    zero_at = zero_at[:F]
    state = bundled._new_state(gh)
    bundled._root(state)
    row = state.cand[0]
    check(bool(torch.isfinite(row[S.GAIN])), "covertype root has no split")
    gl = bundled._go_left(row)
    left = bool(row[S.LEFT_TOTAL_COUNT] <= row[S.RIGHT_TOTAL_COUNT])
    side = S.LEFT_SUM_GRAD if left else S.RIGHT_SUM_GRAD
    small = torch.nonzero(gl if left else ~gl).view(-1).to(torch.int32)
    cases = (("root", None, sum_gh(gh, bundled._padded_rows)),
             ("root's smaller child", small, row[side:side + 4]))
    worst, root_mag = {}, None
    for what, idx, totals in cases:
        got = bundled._leaf_histogram(gh, idx, totals=totals)[:F].double()
        flat = unbundled.bins
        ref = hist_mod.histogram_plain(flat, gh.double(), B, idx)[:F]
        mag = hist_mod.histogram_plain(flat, gh[:, :2].double().abs(), B,
                                       idx)[:F]
        if root_mag is None:
            root_mag = mag[0].sum(dim=0)     # [2]: every row in one bin
        bound = REL_TOL * torch.where(zero_at[..., None], root_mag, mag)
        check(torch.equal(got[..., 2:], ref[..., 2:]),
              "bundled %s histogram: count channels differ from the "
              "unbundled bins' counts" % what)
        err = (got[..., :2] - ref[..., :2]).abs()
        check(bool((err <= bound).all()),
              "bundled %s histogram off the f64 sums by %.3g (%.3g of its "
              "bound)" % (what, float(err.max()),
                          float((err / bound.clamp(min=1e-300)).max())))
        flat_got = hist_mod.build_histogram(flat, gh, B, idx)[:F].double()
        ferr = (flat_got[..., :2] - ref[..., :2]).abs()
        check(bool((ferr <= REL_TOL * mag).all()),
              "unbundled %s histogram off the f64 sums by %.3g"
              % (what, float(ferr.max())))
        worst[what] = (float(err.max()), float(ferr.max()),
                       float((got - flat_got).abs().max()),
                       int(zero_at.sum()), len(gh) if idx is None
                       else len(idx))
    log("covertype bundled f32 histograms against f64 sums over the "
        "unbundled bins (%d rebuilt zero bins; bound REL_TOL x abs sum "
        "per bin, the root's for a rebuilt bin): %s"
        % (int(zero_at.sum()), "; ".join(
            "%s (%d rows): max err bundled %.3g, unbundled %.3g, bundled "
            "- unbundled %.3g" % (k, v[4], v[0], v[1], v[2])
            for k, v in worst.items())))


def time_bundled_step(bundled, unbundled, hist_mod, real, trees: int = 2):
    """The whole-tree loop of a bundled and an unbundled learner on the
    same rows and the same gradients (synthetic, from a seed), in turns
    (unbundled, bundled, bundled, unbundled): ms per split of each, on
    one card in one call. First the bundled histograms on those
    gradients are checked (:func:`check_bundled_histograms`). Then
    :func:`efb_first_difference` on those gradients and on ``real``,
    the (grad, hess) of the training run's tree 0."""
    import torch
    n, dev = bundled.N, bundled.device
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    grad = torch.rand(n, generator=g, device=dev) - 0.5
    hess = torch.rand(n, generator=g, device=dev) * 0.25
    gh = torch.stack([grad, hess, torch.ones_like(grad),
                      torch.ones_like(grad)], dim=1)
    check_bundled_histograms(bundled, unbundled, gh, hist_mod)
    ms = {"unbundled": [], "bundled": []}
    grown = {}
    for name in ("unbundled", "bundled", "bundled", "unbundled"):
        learner = bundled if name == "bundled" else unbundled
        for _ in range(trees):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tree, _ = learner._grow_fused(gh)
            torch.cuda.synchronize()
            ms[name].append(1e3 * (time.perf_counter() - t0)
                            / max(tree.num_leaves - 1, 1))
            grown[name] = tree
    log("whole-tree loop on the same gradients (covertype, 255 leaves; "
        "in turns): ms per split unbundled %s, bundled %s"
        % (" ".join("%.3f" % v for v in ms["unbundled"]),
           " ".join("%.3f" % v for v in ms["bundled"])))
    efb_first_difference(bundled, unbundled, gh, grown["bundled"],
                         grown["unbundled"], "synthetic gradients")
    ones = torch.ones_like(real[0])
    gh = torch.stack([real[0], real[1], ones, ones], dim=1)
    efb_first_difference(bundled, unbundled, gh,
                         bundled._grow_fused(gh)[0],
                         unbundled._grow_fused(gh)[0],
                         "tree 0's gradients")


def tree0_gradients(lgb, ds, params):
    """The (grad, hess) that the learner got for tree 0 (class 0 of
    iteration 0) of a run of ``params`` on ``ds``: the run is stopped at
    its first tree."""
    from lightgbm_tpu_torch.treelearner import serial
    grow = serial.SerialTreeLearner.train
    got = []

    def capture(self, grad, hess, bag=None):
        check(bag is None, "tree 0 of the covertype run has a bag")
        got.append((grad.clone(), hess.clone()))
        raise _StopTrace()
    serial.SerialTreeLearner.train = capture
    try:
        lgb.train(params, ds, num_boost_round=1)
    except _StopTrace:
        pass
    finally:
        serial.SerialTreeLearner.train = grow
    return got[0]


def _node_splits(tree):
    """(inner feature, threshold bin, decision type, gain) of each
    internal node, in the order the splits were made (node i is split
    i)."""
    return [(int(tree.split_feature_inner[i]),
             int(tree.threshold_in_bin[i]), int(tree.decision_type[i]),
             float(tree.split_gain[i])) for i in range(tree.num_internal)]


def first_split_difference(bundled_trees, unbundled_trees):
    """(tree, split, bundled split, unbundled split) of the first split
    that differs in (feature, threshold bin, decision type), in tree
    order and then split order, or None."""
    for t, (a, b) in enumerate(zip(bundled_trees, unbundled_trees)):
        sa, sb = _node_splits(a), _node_splits(b)
        for i in range(max(len(sa), len(sb))):
            u = sa[i] if i < len(sa) else None
            v = sb[i] if i < len(sb) else None
            if u is None or v is None or u[:3] != v[:3]:
                return t, i, u, v
    return None


class _StopTrace(Exception):
    pass


def _candidate_tables(learner, gh, upto):
    """The per-split loop of ``learner`` on the rows ``gh``, stopped
    at split ``upto`` (0-based): each split's winner (leaf, feature,
    threshold bin) and the candidate table it won from (every leaf's
    [gain, feature, threshold bin], read before the split), and the
    loop's state before split ``upto``."""
    from lightgbm_tpu_torch.ops import split as S
    from lightgbm_tpu_torch.treelearner import serial
    split = serial.SerialTreeLearner._split
    cols = [S.GAIN, S.FEATURE, S.THRESHOLD_BIN]
    trace, last = [], []

    def traced(self, state, rec, *args):
        trace.append(((rec.leaf, rec.feature, rec.threshold_bin),
                      state.cand[:, cols].cpu().numpy()))
        if len(trace) > upto:
            last.append(state)
            raise _StopTrace()
        return split(self, state, rec, *args)
    serial.SerialTreeLearner._split = traced
    try:
        learner._grow_stepped(gh)
    except _StopTrace:
        pass
    finally:
        serial.SerialTreeLearner._split = split
    return trace, last[0] if last else None


def _feature_gain(learner, state, leaf: int, feature: int) -> float:
    """The best gain of one feature in one leaf of the per-split loop's
    ``state``: the leaf's scan with every other feature masked out (the
    leaf's sums from its candidate row, as the loop splits it)."""
    import torch
    from lightgbm_tpu_torch.ops import split as S
    row = state.cand[leaf]
    sums = (row[S.LEFT_SUM_GRAD:S.LEFT_SUM_GRAD + 4]
            + row[S.RIGHT_SUM_GRAD:S.RIGHT_SUM_GRAD + 4])
    mask = torch.zeros_like(learner.feature_mask)
    mask[feature] = True
    info = learner._scan(state.hists[leaf], sums,
                         S.calculate_leaf_output(sums[0], sums[1],
                                                 learner.params),
                         learner._qscale, mask=mask)
    return float(info[S.GAIN])


def efb_first_difference(bundled, unbundled, gh, t_bundled, t_unbundled,
                         what, names=("bundled", "unbundled"), label="EFB",
                         shape="covertype, 255 leaves, f32"):
    """Why bundled and unbundled f32 trees part: the first split where
    the bundled and the unbundled learner part on the SAME rows and
    gradients (f32), with both winners' gains, and both candidate
    tables at that split (each learner's per-split loop, stopped
    there): whether the two winners are a near-tie, each learner's gap
    between them no larger than the largest gain difference of one
    candidate that both tables hold (the f32 rounding of the two
    histograms). Printed, not checked: a flip past that bound would be
    a fault of the bundled path, inside it a fact of f32 sums."""
    na, nb = names
    diff = first_split_difference([t_bundled], [t_unbundled])
    if diff is None:
        log("%s, %s (%s): the %s and the %s learner grow the same tree "
            "(%d splits)" % (label, what, shape, na, nb,
                             t_bundled.num_internal))
        return
    _, k, u, v = diff
    tables, states = {}, {}
    for name, learner in ((na, bundled), (nb, unbundled)):
        tables[name], states[name] = _candidate_tables(learner, gh, k)
    (wa, ca), (wb, cb) = tables[na][k], tables[nb][k]
    same_before = all(x[0] == y[0] for x, y in zip(tables[na][:k],
                                                   tables[nb][:k]))
    live = np.isfinite(ca[:, 0]) & np.isfinite(cb[:, 0])
    agree = live & np.all(ca[:, 1:] == cb[:, 1:], axis=1)
    rounding = float(np.abs(ca[agree, 0].astype(np.float64)
                            - cb[agree, 0]).max()) if agree.any() else 0.0
    # the two winners as candidates (leaf, feature), each scanned alone
    # by both learners: the bundled winner A, the unbundled winner B
    gains = {name: [_feature_gain(learner, states[name], w[0], w[1])
                    for w in (wa, wb)]
             for name, learner in ((na, bundled), (nb, unbundled))}
    (ga_b, gb_b), (ga_u, gb_u) = gains[na], gains[nb]
    pair = max(abs(ga_b - ga_u), abs(gb_b - gb_u))
    bound = max(pair, rounding)
    gap_b, gap_u = ga_b - gb_b, gb_u - ga_u
    near = 0.0 <= gap_b <= bound and 0.0 <= gap_u <= bound
    log("%s, %s (%s): splits 1-%d equal (per-split loop: %s); split %d: "
        "%s splits leaf %d (feature %d, bin %d, gain %.9g), %s leaf %d "
        "(feature %d, bin %d, gain %.9g); each winner scanned alone in "
        "its leaf: %s gives A %.9g, B %.9g (gap %.3g, %.1f ulp), %s A "
        "%.9g, B %.9g (gap %.3g, %.1f ulp); the same candidate's gain "
        "differs across the two learners by up to %.3g (A, B), %.3g (the "
        "%d of %d live leaves whose tables agree); a near-tie within the "
        "f32 rounding of the two histograms: %s"
        % (label, what, shape, k, same_before, k + 1, na, wa[0], wa[1],
           wa[2], float(ca[wa[0], 0]), nb, wb[0], wb[1], wb[2],
           float(cb[wb[0], 0]), na, ga_b, gb_b, gap_b, _ulps(ga_b, gb_b),
           nb, ga_u, gb_u, gap_u, _ulps(ga_u, gb_u), pair, rounding,
           int(agree.sum()), int(live.sum()), near))
    return near


def time_lut_encoding(bst, X, what):
    """The LUT-node encoding (``lut=True``) of a booster's stacked
    forest against the compare encoding and the host walk (leaf ids
    equal, raw scores byte-equal), and each encoding's ms per
    65,536-row bucket by stage."""
    from lightgbm_tpu_torch.serve import StackedForest
    host_leaf = bst.predict(X, pred_leaf=True, predict_on_device=False)
    host_raw = bst.predict(X, raw_score=True, predict_on_device=False)
    stages = {}
    for lut in (False, True):
        forest = StackedForest.from_gbdt(bst, lut=lut).place("cuda")
        check(forest.lut_nodes == lut, "lut=%s was not built" % lut)
        check(np.array_equal(forest.leaves(X), host_leaf),
              "%s: lut=%s leaf ids differ from the host walk" % (what, lut))
        check(np.array_equal(forest.predict_raw(X), host_raw),
              "%s: lut=%s raw scores differ from the host walk"
              % (what, lut))
        Xb = np.ascontiguousarray(np.resize(X, (1 << 16, X.shape[1])),
                                  dtype=np.float32)
        stages["lut" if lut else "compare"] = time_dispatch(forest, Xb)
    log("%s stacked forest: the LUT-node encoding and the compare encoding "
        "give the host walk's leaf ids and raw bytes on %d rows; ms per "
        "65536-row bucket by stage (CUDA events): %s"
        % (what, X.shape[0], json.dumps({
            k: {s: round(v, 4) for s, v in st.items()}
            for k, st in stages.items()})))


# ---------------------------------------------------------------------------
# phase 13: Covertype in its categorical form
# ---------------------------------------------------------------------------
def make_covertype_categorical(n: int, seed: int):
    """Phase 9's generator with its 4 wilderness and 40 soil one-hot
    columns collapsed into one categorical column each (values 0..3 and
    0..39): 12 columns."""
    X, y = make_covertype_like(n, seed)
    wild = np.argmax(X[:, 10:14], axis=1).astype(np.float32)
    soil = np.argmax(X[:, 14:54], axis=1).astype(np.float32)
    return np.column_stack([X[:, :10], wild, soil]), y


def unusual_categories(Xv: np.ndarray) -> np.ndarray:
    """Held-out rows with NaN, negative, fractional and unseen values in
    the two categorical columns (every 1000-row block one kind)."""
    Xu = Xv.copy()
    for k, (col, val) in enumerate(((10, np.nan), (10, -1.0), (10, 9.0),
                                    (10, 2.5), (11, np.nan), (11, -5.0),
                                    (11, 77.0), (11, 40.0), (11, 31.0))):
        Xu[k * 1000:(k + 1) * 1000, col] = val
    return Xu


def cat_nodes(bst, feature):
    """(category sets of the categorical nodes on ``feature``, count of
    categorical nodes) over the booster's trees."""
    sets, total = [], 0
    for t in bst.inner.models:
        for j in range(t.num_internal):
            if int(t.decision_type[j]) & 1:
                total += 1
                if int(t.split_feature[j]) == feature:
                    sets.append(t._cats_of(int(t.threshold_in_bin[j])))
    return sets, total


def phase_covertype_categorical(lgb, hist_mod):
    """Phase 9's rows in their categorical form: 581,012 + 50,000 held
    out x 12 columns, ``categorical_feature=[10, 11]`` (wilderness: 4
    values, num_bin 5 > max_cat_to_onehot 4, so both columns take the
    sorted subset), 7 classes, 255 leaves, ``MULTICLASS_ROUNDS`` rounds
    through the
    whole-tree loop; phase 9's checks, categorical nodes in the model
    text, the stacked path (auto mode) on rows with NaN, negative and
    unseen categories, 1 round at ``CUT_LEAVES`` leaves through both
    loops, 1 round with ``max_cat_to_onehot: 8`` (wilderness in one-hot
    mode) and an 8-bit
    tree 1 at 50k rows on cuda and cpu. Returns the launches by path and
    the learner's bins for timing."""
    from lightgbm_tpu_torch.objective.multiclass import MulticlassSoftmax
    t0 = time.perf_counter()
    X, y = make_covertype_categorical(COVERTYPE_ROWS + COVERTYPE_HELD_OUT,
                                      seed=9)
    Xt, yt = X[:COVERTYPE_ROWS], y[:COVERTYPE_ROWS]
    Xv, yv = X[COVERTYPE_ROWS:], y[COVERTYPE_ROWS:]
    params = {"objective": "multiclass", "num_class": 7, "num_leaves": 255,
              "learning_rate": 0.1, "max_bin": 255,
              "categorical_feature": [10, 11],
              "metric": "multi_logloss,multi_error", "verbosity": -1}
    ds, valid = covertype_splits(Xt, yt, Xv, yv, lgb, params)
    mappers = ds.handle.bin_mappers
    nb = [m.num_bin for m in mappers[-2:]]
    # wilderness: 4 categories + bin 0 = 5 bins > max_cat_to_onehot 4,
    # so the sorted subset scans it; soil keeps the categories that
    # cover 99% of the sample (bin.cpp:424-491)
    check([m.bin_type for m in mappers[-2:]] == [1, 1] and nb[0] == 5,
          "covertype categorical: columns 10, 11 are not categorical, "
          "wilderness with 5 bins: %s" % nb)
    log("covertype categorical: %d + %d rows x %d (wilderness %d bins, "
        "soil %d bins); generated and binned in %.1f s"
        % (len(yt), len(yv), X.shape[1], nb[0], nb[1],
           time.perf_counter() - t0))
    run = train_path(lgb, hist_mod, ds, valid, params, "histogram_f32",
                     MULTICLASS_ROUNDS, grad_cls=MulticlassSoftmax,
                     tag="covertype multiclass categorical")
    bst = run["booster"]
    learner = check_multiclass(bst, run, Xv, yv, "phase 13 covertype "
                               "categorical")
    check(learner._has_cat and not learner._bundled,
          "covertype categorical: the learner has no categorical scan")
    text = bst.model_to_string()
    wild_sets, n_cat = cat_nodes(bst, 10)
    soil_sets, _ = cat_nodes(bst, 11)
    check(n_cat > 0 and "cat_threshold=" in text,
          "covertype categorical: no categorical node in the model text")
    log("phase 13 categorical nodes: %d of %d (wilderness %d, soil %d; "
        "soil sets of %s categories)"
        % (n_cat, sum(t.num_internal for t in bst.inner.models),
           len(wild_sets), len(soil_sets),
           sorted({len(c) for c in soil_sets})))
    check_stacked(bst, unusual_categories(Xv),
                  "phase 13 covertype categorical, NaN / negative / "
                  "unseen categories")
    loops_agree(lgb, hist_mod, ds, valid, params, "covertype categorical")
    R = RERUN_ROUNDS
    launches = {"phase13_covertype_categorical":
                run["launches"]["histogram_f32"]}
    bins = (learner.bins, learner.B)
    del bst, learner
    oh = dict(params, max_cat_to_onehot=8)
    ohrun = train_path(lgb, hist_mod, ds, valid, oh, "histogram_f32", R,
                       tag="covertype categorical, wilderness one-hot")
    wild_oh, _ = cat_nodes(ohrun["booster"], 10)
    check(len(wild_oh) > 0 and all(len(c) == 1 for c in wild_oh),
          "max_cat_to_onehot=8: wilderness splits are not one-hot: %s"
          % wild_oh[:5])
    log("covertype categorical, max_cat_to_onehot 8: %d wilderness splits, "
        "each one category (one-hot mode); held-out multi_logloss %s"
        % (len(wild_oh), " ".join(
            "%.6f" % v for v in ohrun["evals"]["multi_logloss"])))
    launches["phase13_covertype_categorical_onehot"] = \
        ohrun["launches"]["histogram_f32"]
    del ohrun
    first_tree_cuda_vs_cpu(lgb, Xt, yt, params, "phase 13 covertype "
                           "categorical")
    return launches, bins


# ---------------------------------------------------------------------------
# phase 10: lambdarank at MSLR-WEB30K's shape
# ---------------------------------------------------------------------------
# MSLR-WEB30K's label shares (0..4)
MSLR_SHARES = (0.51, 0.32, 0.13, 0.03, 0.01)
MSLR_RELEVANCE_SEED = 20


def make_mslr_like(num_queries: int, seed: int, total_rows=None):
    """MSLR-WEB30K-shaped synthetic rows: query lengths log-normal with a
    mean near 120, one query of the maximum length 1,251 (and, when
    ``total_rows`` is given, lengths adjusted to sum to it); 136 dense
    features, a third of them constant within a query (query-level
    features); labels 0-4 with MSLR's shares, cut at the shares'
    quantiles of a noisy function of the features."""
    rng = np.random.RandomState(seed)
    lengths = np.clip(np.round(rng.lognormal(np.log(90.0), 0.75,
                                             num_queries)), 1,
                      MSLR_MAX_LEN).astype(np.int64)
    lengths[rng.randint(num_queries)] = MSLR_MAX_LEN
    if total_rows is not None:
        diff = total_rows - int(lengths.sum())
        while diff != 0:
            q = rng.randint(num_queries)
            step = int(np.clip(diff, 1 - lengths[q],
                               MSLR_MAX_LEN - lengths[q]))
            if lengths[q] == MSLR_MAX_LEN and step > 0:
                continue
            lengths[q] += step
            diff -= step
    n = int(lengths.sum())
    qid = np.repeat(np.arange(num_queries), lengths)
    X = np.empty((n, 136), dtype=np.float32)
    chunk = 1 << 19
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        X[lo:hi] = rng.randn(hi - lo, 136)
    qfeat = rng.randn(num_queries, 45).astype(np.float32)
    X[:, 91:] = qfeat[qid]
    X[:, 1:91:3] = np.abs(X[:, 1:91:3]) ** 1.5          # heavy tails
    # one relevance function for the training and the held-out queries
    wrng = np.random.RandomState(MSLR_RELEVANCE_SEED)
    w = np.zeros(136, dtype=np.float32)
    w[wrng.choice(91, 24, replace=False)] = wrng.randn(24) * 0.6
    w[91:96] = wrng.randn(5) * 0.3
    latent = X @ w + rng.randn(n).astype(np.float32) * 0.8
    cuts = np.quantile(latent, np.cumsum(MSLR_SHARES)[:-1])
    y = np.searchsorted(cuts, latent).astype(np.float64)
    return X, y, lengths


def phase_mslr(lgb, hist_mod):
    """lambdarank at MSLR-WEB30K's shape: 2,270,296 rows x 136 features
    in 18,919 queries (at most 1,251 docs), 255 leaves,
    min_data_in_leaf 100, ndcg@1,3,5 on 2,000 held-out queries, 5
    rounds; a 1-round rerun must give the same tree; then 1 round of
    rank_xendcg, twice, with equal trees. Returns the f32 launches and
    the learner's bins for timing."""
    from lightgbm_tpu_torch.objective.rank import LambdarankNDCG
    t0 = time.perf_counter()
    X, y, group = make_mslr_like(MSLR_QUERIES, seed=21, total_rows=MSLR_ROWS)
    Xv, yv, gv = make_mslr_like(MSLR_HELD_OUT_QUERIES, seed=22)
    t_gen = time.perf_counter() - t0
    params = {"objective": "lambdarank", "num_leaves": 255,
              "min_data_in_leaf": 100, "learning_rate": 0.1,
              "max_bin": 255, "eval_at": "1,3,5", "metric": "ndcg",
              "verbosity": -1}
    ds = lgb.Dataset(X, label=y, group=group, params=params).construct()
    valid = lgb.Dataset(Xv, label=yv, group=gv, reference=ds).construct()
    del X
    shares = np.bincount(y.astype(int), minlength=5) / len(y)
    log("mslr-like: %d rows x 136 in %d queries (mean %.1f, max %d docs), "
        "held out %d rows in %d queries; label shares %s; generated in "
        "%.1f s, binned in %.1f s"
        % (len(y), len(group), group.mean(), group.max(), len(yv), len(gv),
           " ".join("%.3f" % v for v in shares), t_gen,
           time.perf_counter() - t0 - t_gen))
    run = train_path(lgb, hist_mod, ds, valid, params, "histogram_f32", 5,
                     grad_cls=LambdarankNDCG, tag="mslr lambdarank")
    bst, evals = run["booster"], run["evals"]
    ndcg5 = evals["ndcg@5"]
    check(ndcg5[-1] > ndcg5[0], "held-out ndcg@5 did not rise: %s" % ndcg5)
    check_stacked(bst, Xv, "phase 10 mslr")
    log("mslr lambdarank: held-out ndcg@1 %s; ndcg@3 %s; ndcg@5 %s; mean "
        "seconds per iteration %.3f; lambdarank gradient stage ms per "
        "iteration %s"
        % tuple([" ".join("%.6f" % v for v in evals[k])
                 for k in ("ndcg@1", "ndcg@3", "ndcg@5")]
                + [float(np.mean(run["per_iter"])),
                   " ".join("%.3f" % v for v in run["grad_ms"])]))
    R = RERUN_ROUNDS
    again = train_path(lgb, hist_mod, ds, valid,
                       dict(params, tpu_fused_tree=False), "histogram_f32",
                       R, tag="mslr lambdarank per-split rerun")["booster"]
    check([t.to_string() for t in bst.inner.models[:R]]
          == [t.to_string() for t in again.inner.models],
          "a per-split lambdarank run gave other trees than the whole-tree "
          "run")
    log("mslr lambdarank per-split rerun (%d round(s)): text-equal to the "
        "whole-tree run's first trees" % R)
    launches = run["launches"]["histogram_f32"]
    bins = bst.inner.learner.bins
    del bst, again
    xe = dict(params, objective="rank_xendcg")
    from lightgbm_tpu_torch.objective.rank import RankXENDCG
    texts = []
    for fused in (True, False):
        r = train_path(lgb, hist_mod, ds, valid,
                       dict(xe, tpu_fused_tree=fused), "histogram_f32", R,
                       grad_cls=RankXENDCG,
                       tag="mslr rank_xendcg %s" % ("whole-tree" if fused
                                                    else "per-split"))
        texts.append([t.to_string() for t in r["booster"].inner.models])
        launches += r["launches"]["histogram_f32"]
    check(texts[0] == texts[1], "the per-split rank_xendcg run gave other "
          "trees than the whole-tree run")
    log("mslr rank_xendcg: whole-tree and per-split %d-round runs "
        "text-equal; held-out ndcg@5 %s"
        % (R, " ".join("%.6f" % v for v in r["evals"]["ndcg@5"])))
    return launches, bins


# ---------------------------------------------------------------------------
# phase 11: every other objective, small
# ---------------------------------------------------------------------------
def other_objective_labels(X: np.ndarray, seed: int):
    """Labels for each remaining objective from the Higgs-shaped rows:
    a noisy continuous target, positive ones for poisson, gamma and
    tweedie, [0, 1] ones for the cross-entropies, 3 classes for
    multiclassova."""
    rng = np.random.RandomState(seed)
    n = X.shape[0]
    cont = (0.8 * X[:, 0] + X[:, 1] - 0.5 * X[:, 2] * X[:, 3]
            + 0.3 * rng.randn(n))
    counts = rng.poisson(np.exp(0.3 * cont)).astype(np.float64)
    return {
        "regression_l1": cont, "huber": cont, "fair": cont,
        "quantile": cont, "mape": 10.0 + 3.0 * cont,
        "poisson": counts,
        "gamma": np.exp(0.3 * cont) * rng.gamma(2.0, 0.5, n),
        "tweedie": counts * rng.gamma(2.0, 0.5, n),
        "cross_entropy": 1.0 / (1.0 + np.exp(-cont)),
        "cross_entropy_lambda": 1.0 / (1.0 + np.exp(-cont)),
        "multiclassova": np.digitize(cont, np.quantile(cont, (0.3, 0.7))
                                     ).astype(np.float64),
    }


def phase_other_objectives(lgb, hist_mod):
    """Each remaining objective at ``CROSS_ROWS`` Higgs-shaped rows
    (phase 3's generator, binned once), 63 leaves, 1 round, on cuda and on cpu: tree 1 must
    have the same structure (:func:`tree_structure`), the cuda run must
    go through the f32 instance only, and for l1, quantile and mape the
    renewed leaf values of tree 1 must be equal. Host-clock ms of each
    renewal (its score-column and partition copies to the host
    included). Returns the f32 launches."""
    import torch
    from lightgbm_tpu_torch.boosting import gbdt
    X, _ = make_higgs_like(CROSS_ROWS, seed=7)
    labels = other_objective_labels(X, seed=8)
    base = {"num_leaves": 63, "min_data_in_leaf": 100,
            "learning_rate": 0.1, "verbosity": -1}
    ds = lgb.Dataset(X, label=labels["regression_l1"],
                     params=base).construct()
    renew = gbdt.GBDT._renew_tree_output
    renew_ms = []

    def timed_renew(self, *args):
        t = time.perf_counter()
        renew(self, *args)
        renew_ms.append(1e3 * (time.perf_counter() - t))
    threads = torch.get_num_threads()
    total = 0
    for name, y in labels.items():
        ds.handle.metadata.set_label(y)
        params = dict(base, objective=name)
        if name == "multiclassova":
            params["num_class"] = 3
        res = {}
        for dev in ("cuda", "cpu"):
            torch.set_num_threads(1 if dev == "cpu" else threads)
            renew_ms.clear()
            gbdt.GBDT._renew_tree_output = timed_renew
            hist_mod.reset_launch_counts()
            try:
                t0 = time.perf_counter()
                b = lgb.train(dict(params, device_type=dev), ds,
                              num_boost_round=1)
                secs = time.perf_counter() - t0
            finally:
                gbdt.GBDT._renew_tree_output = renew
            res[dev] = (b.inner.models,
                        check_device_launches(hist_mod, b, "histogram_f32",
                                              name)
                        if dev == "cuda" else dict(hist_mod.launch_counts),
                        secs, list(renew_ms))
        torch.set_num_threads(threads)
        cuda_trees, launches, secs, rms = res["cuda"]
        a, c = cuda_trees[0], res["cpu"][0][0]
        check(tree_structure(a) == tree_structure(c),
              "%s: tree 1 differs between cuda and cpu" % name)
        same_order = tree_splits_of(a) == tree_splits_of(c)
        check(sum(res["cpu"][1].values()) == 0,
              "%s: the cpu run launched a kernel" % name)
        renewed = b.inner.objective.is_renew_tree_output
        if renewed:
            check(np.array_equal(a.leaf_value[:a.num_leaves],
                                 c.leaf_value[:c.num_leaves]),
                  "%s: renewed leaf values of tree 1 differ between cuda "
                  "and cpu" % name)
        total += launches["histogram_f32"]
        log("objective %s (63 leaves, 1 round, %d trees): tree 1 the same "
            "tree on cuda and cpu (%s)%s; cuda %.3f s, cpu %.3f s; %d "
            "launches of histogram_f32%s"
            % (name, len(cuda_trees),
               "splits in the same order" if same_order else
               "the same splits, added in another order",
               ", renewed leaf values equal" if renewed else "", secs,
               res["cpu"][2], launches["histogram_f32"],
               "; renewal ms per tree on cuda (host, copies included): "
               + " ".join("%.2f" % v for v in rms) if rms else ""))
    return total


# ---------------------------------------------------------------------------
# phase 12: prediction through the stacked forest
# ---------------------------------------------------------------------------
def timed(fn):
    """(result, host seconds) of ``fn()``, the card synchronised before
    and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def stacked_predictor(bst):
    """The booster's cached ``BucketedPredictor`` (None before its first
    stacked dispatch)."""
    cached = getattr(bst, "_stacked_cache", None)
    return None if cached is None else cached[1]


def check_stacked(bst, X, what):
    """``Booster.predict`` in auto mode (the stacked forest on the card)
    against the host walk (``predict_on_device=False``) on ``X``: the
    stacked path must dispatch, leaf ids must be equal and raw scores and
    values byte-equal. Returns the host-walk and stacked rows/s of the
    raw scores."""
    n = X.shape[0]
    bst._stacked_cache = None
    raw, t_dev = timed(lambda: bst.predict(X, raw_score=True))
    pred = stacked_predictor(bst)
    check(pred is not None and sum(pred.entries.values()) > 0,
          "%s: auto mode did not dispatch the stacked path" % what)
    host, t_host = timed(lambda: bst.predict(X, raw_score=True,
                                             predict_on_device=False))
    check(raw.shape == host.shape and np.array_equal(raw, host),
          "%s: stacked raw scores differ from the host walk (max |diff| "
          "%.3g)" % (what, float(np.nanmax(np.abs(raw - host)))))
    check(np.array_equal(bst.predict(X),
                         bst.predict(X, predict_on_device=False)),
          "%s: stacked values differ from the host walk" % what)
    leaves = bst.predict(X, pred_leaf=True)
    check(np.array_equal(leaves, bst.predict(X, pred_leaf=True,
                                             predict_on_device=False)),
          "%s: stacked leaf ids differ from the host walk" % what)
    log("%s: stacked path == host walk on %d rows x %d trees (leaf ids "
        "equal, raw and values byte-equal); raw scores %.0f rows/s "
        "stacked (the first call packs the forest), %.0f rows/s host "
        "walk; bucket dispatches %s"
        % (what, n, leaves.shape[1], n / t_dev, n / t_host,
           json.dumps({"%s %s" % (k[1], "/".join(k[2:])): v
                       for k, v in sorted(pred.entries.items(),
                                          key=str)})))
    return n / t_host, n / t_dev


def time_dispatch(forest, Xb):
    """CUDA-event ms of one bucket's stages on the card: the rows' copy
    to the card, quantize, the walk of all trees, the f64 tree-order sum
    and the Kahan f32 sum, and the read-back of [n, K] f64."""
    import torch
    from lightgbm_tpu_torch.ops import predict as P
    K = forest.num_classes
    Xd = torch.from_numpy(Xb).cuda()
    bins_t = P._quantize_rows_impl(Xd, forest._qt)
    leaves = P._walk_stacked(bins_t, forest._nodes, forest.trips,
                             forest._cat_lut)
    raw = P._sum_leaf_values_f64(leaves, forest._leaf_f64, K)
    return {
        "copy_in": cuda_ms(lambda: torch.from_numpy(Xb).cuda(), reps=5),
        "quantize": cuda_ms(lambda: P._quantize_rows_impl(Xd, forest._qt),
                            reps=5),
        "walk": cuda_ms(lambda: P._walk_stacked(bins_t, forest._nodes,
                                                forest.trips,
                                                forest._cat_lut), reps=5),
        "sum_f64": cuda_ms(lambda: P._sum_leaf_values_f64(
            leaves, forest._leaf_f64, K), reps=5),
        "sum_kahan_f32": cuda_ms(lambda: P._raw_from_leaves(
            P.stacked_leaf_values(Xd, leaves, forest._nodes), K), reps=5),
        "copy_out": cuda_ms(lambda: raw.cpu(), reps=5),
    }


def phase_predict(lgb, hist_mod):
    """Train binary (255 leaves, min_data_in_leaf 100, lr 0.1) for
    ``PREDICT_ROUNDS`` rounds on phase 3's 200k Higgs-shaped rows,
    predict the reference bench's 262,144-row batch three ways against
    the host walk, time the stacked path, then continue the model after
    half the rounds for the other half through ``init_model`` and
    round-trip it through pickle. Returns the f32 histogram launches of
    the two training runs."""
    import pickle
    import torch
    X, y = make_higgs_like(SMALL_ROWS + 50_000, seed=7)
    params = dict(SLICE_PARAMS, num_leaves=255)
    ds = lgb.Dataset(X[:SMALL_ROWS], label=y[:SMALL_ROWS],
                     params=params).construct()
    valid = lgb.Dataset(X[SMALL_ROWS:], label=y[SMALL_ROWS:],
                        reference=ds).construct()
    run = train_path(lgb, hist_mod, ds, valid, params, "histogram_f32",
                     PREDICT_ROUNDS, tag="phase 12 binary, 255 leaves, %d "
                     "rounds" % PREDICT_ROUNDS)
    bst = run["booster"]
    PHASE12["model"] = bst.model_to_string(num_iteration=REFIT_ITERATIONS)
    PHASE12["model_full"] = bst.model_to_string()
    launches = {"phase12_binary_%d_rounds" % PREDICT_ROUNDS:
                run["launches"]["histogram_f32"]}
    Xp, _ = make_higgs_like(PREDICT_ROWS, seed=1)
    n = PREDICT_ROWS

    # the host walk: raw scores, values, leaf ids
    host_raw, t_host = timed(lambda: bst.predict(
        Xp, raw_score=True, predict_on_device=False))
    # the host walk's values: its raw scores through the objective's
    # convert_output, as GBDT.predict computes them
    host_val = bst.inner.objective.convert_output(host_raw)
    # leaf ids on the first bucket (the raw scores of every row are held
    # byte-equal below)
    host_leaf = bst.predict(Xp[:1 << 16], pred_leaf=True,
                            predict_on_device=False)
    # Booster.predict in auto mode: must take the stacked path
    bst._stacked_cache = None
    bst.predict(Xp[:4096])                 # packs and places the forest
    pred = stacked_predictor(bst)
    check(pred is not None, "auto mode did not dispatch the stacked path")
    forest = pred.forest
    forest.transfer_bytes.update(to_device=0, from_device=0)
    pred.entries.clear()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    val, t_val = timed(lambda: bst.predict(Xp))
    peak = torch.cuda.max_memory_allocated() - base_mem
    moved = dict(forest.transfer_bytes)
    check(pred.entries == {(pred.model_version, 1 << 16, "value"): 4},
          "auto mode dispatched %s, not 4 buckets of 65536 rows"
          % pred.entries)
    check(np.array_equal(val, host_val),
          "stacked values differ from the host walk")
    raw = bst.predict(Xp, raw_score=True)
    check(np.array_equal(raw, host_raw),
          "stacked raw scores differ from the host walk")
    leaf = bst.predict(Xp[:1 << 16], pred_leaf=True)
    check(np.array_equal(leaf, host_leaf),
          "stacked leaf ids differ from the host walk")
    # the throughput path: the Kahan f32 sum of the whole batch in one
    # pass, as the reference bench times it
    Xd32 = np.ascontiguousarray(Xp, dtype=np.float32)
    forest.predict_raw_device(Xd32)          # warm
    fast, t_fast = timed(lambda: forest.predict_raw_device(Xd32))
    # Kahan's bound (Higham, Accuracy and Stability, 4.3): the error of
    # the compensated f32 sum of x_1..x_T is at most (2u + O(T u^2)) *
    # sum |x_i|, u = 2^-24, so at most 2 f32 ulp of sum |x_i|; with
    # leaf values of one sign (the reference's 512 positive stumps)
    # that is 2 ulp of the sum itself. x_i are the f32 leaf values the
    # card adds; their exact sum is taken in f64
    leaves_dev = forest.leaves_device(Xd32)
    f32_vals = forest._nodes.leaf_value.gather(1, leaves_dev.long()).double()
    exact = f32_vals.sum(dim=0).cpu().numpy()
    mass = f32_vals.abs().sum(dim=0).cpu().numpy()
    fast = fast[:, 0].cpu().numpy().astype(np.float64)
    err = np.abs(fast - exact)
    gap = err / np.spacing(mass.astype(np.float32)).astype(np.float64)
    check(float(gap.max()) <= 2.0,
          "raw_device is %.3f f32 ulp of sum |leaf values| from the f64 "
          "sum of its leaf values" % float(gap.max()))
    ulp_sum = np.spacing(np.abs(exact).astype(np.float32)).astype(
        np.float64)
    gap_sum = err / ulp_sum
    host_gap = np.abs(fast - host_raw) / ulp_sum
    # f64 rows: the double-double path, byte-equal to the host walk
    X64 = Xp[:4096].astype(np.float64) + 1e-12
    dd = bst.predict(X64)
    check(any(k[-1] == "dd" for k in pred.entries),
          "the f64 batch did not take the dd path")
    check(np.array_equal(dd, bst.predict(X64, predict_on_device=False)),
          "dd values differ from the host walk")
    stages = time_dispatch(forest, Xd32[:1 << 16])
    log("phase 12 predict, %d rows x %d trees (255 leaves, trips %d): "
        "host walk %.0f rows/s (%.3f s raw); stacked value path (auto "
        "mode, 4 buckets of 65536) %.0f rows/s (%.3f s); raw_device (one "
        "pass, Kahan f32) %.0f rows/s (%.3f s); leaf ids equal (first "
        "65536 rows), value and raw byte-equal to the host walk (every "
        "row); raw_device from the f64 sum of "
        "its f32 leaf values: at most %.3f f32 ulp of sum |leaf values| "
        "(bound 2), in f32 ulp of the sum itself at most %.1f, median "
        "%.3f, %.2f%% of rows within 2; from the host's f64 sum of f64 "
        "leaf values: at most %.1f, median %.3f ulp of the sum; 4096 f64 "
        "rows (dd) byte-equal"
        % (n, forest.num_trees, forest.trips, n / t_host, t_host,
           n / t_val, t_val, n / t_fast, t_fast, float(gap.max()),
           float(gap_sum.max()), float(np.median(gap_sum)),
           100.0 * float(np.mean(gap_sum <= 2.0)), float(host_gap.max()),
           float(np.median(host_gap))))
    log("phase 12 ms per 65536-row bucket on the card (CUDA events): %s; "
        "sum of the value path's stages %.3f ms; bytes to the card %d, "
        "from the card %d for the %d-row value call; peak memory above "
        "the model %.3f GiB"
        % (json.dumps({k: round(v, 4) for k, v in stages.items()}),
           sum(v for k, v in stages.items() if k != "sum_kahan_f32"),
           moved["to_device"], moved["from_device"], n, peak / 2 ** 30))

    # continued training on the card from the model after half the rounds
    half = PREDICT_ROUNDS // 2
    yv = y[SMALL_ROWS:]
    auc50 = auc(yv, bst.predict(X[SMALL_ROWS:], num_iteration=half))
    auc100 = auc(yv, bst.predict(X[SMALL_ROWS:]))
    first50 = lgb.Booster(model_str=bst.model_to_string(num_iteration=half))
    hist_mod.reset_launch_counts()
    cont = lgb.train(params, ds, num_boost_round=PREDICT_ROUNDS - half,
                     valid_sets=[valid], valid_names=["held_out"],
                     init_model=first50)
    stats = cont.inner.learner.grow_stats
    dev = hist_mod.device_launch_counts()["histogram_f32"]
    check(cont.num_trees() == PREDICT_ROUNDS
          and stats["roots"] == PREDICT_ROUNDS - half
          and dev == stats["roots"] + stats["steps"],
          "continued run: %d trees, roots %d, steps %d, launches %d"
          % (cont.num_trees(), stats["roots"], stats["steps"], dev))
    launches["phase12_continued_%d_rounds" % (PREDICT_ROUNDS - half)] = dev
    auc_cont = auc(yv, cont.predict(X[SMALL_ROWS:]))
    check(auc_cont >= auc50, "held-out AUC fell in continued training: "
          "%.6f after %d rounds, %.6f after %d more"
          % (auc50, half, auc_cont, PREDICT_ROUNDS - half))
    back = pickle.loads(pickle.dumps(cont))
    check(np.array_equal(back.predict(Xp), cont.predict(Xp)),
          "a pickle round trip predicts other values")
    log("phase 12 continued training: held-out AUC %.6f after %d rounds, "
        "%.6f after %d more through init_model (%.6f for %d rounds in "
        "one run); %d launches of histogram_f32 == %d roots + %d steps; "
        "pickle round trip predicts the same %d values"
        % (auc50, half, auc_cont, PREDICT_ROUNDS - half, auc100,
           PREDICT_ROUNDS, dev, stats["roots"], stats["steps"], n))
    return launches


# ---------------------------------------------------------------------------
# phase 14: row and column sampling and the per-node filters
# ---------------------------------------------------------------------------
# interaction constraint groups of phase 14d: the generator's one
# interaction term, sin(x0) * x1, lies inside the first group
HIGGS_GROUPS = [list(range(14)), list(range(14, 28))]
# phase 14e: CEGB vectors over the 28 columns. A split's gain is at most
# sum over its rows of g^2 / h (Cauchy-Schwarz), about one per row for
# the binary loss near p = 0.5, so ~1e7 at 10.5M rows: a coupled penalty
# of 1e9 on columns 20-27 keeps them out of every tree
CEGB_PARAMS = {"cegb_penalty_split": 1e-5,
               "cegb_penalty_feature_coupled": [100.0] * 20 + [1e9] * 8,
               "cegb_penalty_feature_lazy": [1e-3] * 28}


def _record_tree_masks():
    """Wrap the learner's ``train`` to keep each tree's feature mask as
    the learner copied it to the card (its host copy; no device read).
    Returns (masks, restore)."""
    from lightgbm_tpu_torch.treelearner import serial
    grow = serial.SerialTreeLearner.train
    masks = []

    def train(self, *args):
        out = grow(self, *args)
        masks.append(self._mask_host.copy())
        return out
    serial.SerialTreeLearner.train = train

    def restore():
        serial.SerialTreeLearner.train = grow
    return masks, restore


def kernels_per_replay(learner):
    """Device kernels (copies and fills apart) of one replay of the
    learner's captured step, by torch.profiler, and its ms (CUDA events,
    mean of 20 replays). The step after a tree's end launches every
    kernel of a split and changes nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    buf = learner._fused
    for _ in range(3):
        learner._graph.replay()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        learner._graph.replay()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda
               and not e.name.startswith(("Memcpy", "Memset"))]
    ms = cuda_ms(lambda: learner._graph.replay(), reps=20, warm=2)
    check(int(buf.state.step) <= learner.L - 1, "replays past the tree's "
          "end moved its step counter")
    return len(kernels), ms


def phase14_ff_extra_trees(lgb, hist_mod, data):
    """14a: feature_fraction 0.9 + extra_trees, 5 rounds, whole-tree
    loop."""
    import torch
    extra = {"feature_fraction": 0.9, "extra_trees": True}
    ds, valid, Xv, _ = data
    masks, restore = _record_tree_masks()
    try:
        run = train_path(lgb, hist_mod, ds, valid,
                         dict(SLICE_PARAMS, num_leaves=255, **extra),
                         "histogram_f32", 5, tag="14a ff + extra_trees")
    finally:
        restore()
    bst = run["booster"]
    learner = bst.inner.learner
    check(learner._fused_growth and learner.grow_stats["captures"] == 1,
          "14a did not train through the captured whole-tree step")
    check(len(masks) == 5 and all(m.sum() == round(28 * 0.9) for m in masks),
          "14a: expected 5 tree masks of %d features" % round(28 * 0.9))
    for t, m in zip(bst.inner.models, masks):
        used = t.split_feature_inner[:t.num_internal]
        check(bool(m[used].all()), "14a: a split feature lies outside its "
              "tree's mask")
    check(np.array_equal(learner.feature_mask.cpu().numpy(), masks[-1]),
          "14a: the learner's device mask is not the last tree's")
    a = check_predict(bst, data, run["evals"]["auc"])
    check_stacked(bst, Xv, "phase 14a ff + extra_trees")
    n_et, ms_et = kernels_per_replay(learner)
    # the same learner's step without the extra_trees draws
    learner._extra_trees = False
    learner._graph = None
    learner._capture(learner._fused)
    n_plain, ms_plain = kernels_per_replay(learner)
    log("14a ff 0.9 + extra_trees: held-out AUC %.6f; ms per split %.3f "
        "(phase 4 in this call: %s); one replayed step: %d kernels, %.3f "
        "ms; without the extra_trees draws: %d kernels, %.3f ms (the "
        "threefry draws: %+d kernels, %+.3f ms per split)"
        % (a, SPLIT_MS["14a ff + extra_trees"],
           "%.3f" % SPLIT_MS[PHASE4_TAG] if PHASE4_TAG in SPLIT_MS
           else "not run",
           n_et, ms_et, n_plain, ms_plain, n_et - n_plain,
           ms_et - ms_plain))
    check_rerun(lgb, hist_mod, data, extra, "histogram_f32", bst,
                "ff + extra_trees")
    del bst, learner
    torch.cuda.empty_cache()
    return run["launches"]["histogram_f32"]


def phase14_goss(lgb, hist_mod, data):
    """14b: GOSS at its default rates, lr 0.1, 13 rounds (warm-up 10, so
    trees 11-13 are GOSS trees); the draw on the card against the CPU's
    at all rows; top-k ms by torch.topk and torch.kthvalue."""
    import torch
    from lightgbm_tpu_torch.boosting import sample_strategy as SS
    from lightgbm_tpu_torch.utils.prng import PRNGKey
    extra = {"data_sample_strategy": "goss"}
    ds, valid, _, _ = data
    draw = SS.goss_draw
    draws = []

    def recorded(grad, hess, *args):
        out = draw(grad, hess, *args)
        # top rows: in bag and not scaled (the scale of a sampled row,
        # (n - top_k) / other_k = 8 here, changes every hessian > 0)
        draws.append(torch.stack([out[2].sum(), ((out[2] > 0)
                                                 & (out[1] == hess)).sum()]))
        return out
    SS.goss_draw = recorded
    try:
        run = train_path(lgb, hist_mod, ds, valid,
                         dict(SLICE_PARAMS, num_leaves=255, **extra),
                         "histogram_f32", 13, tag="14b goss")
    finally:
        SS.goss_draw = draw
    bst = run["booster"]
    strat = bst.inner.sample_strategy
    check(isinstance(strat, SS.GOSSStrategy) and strat.warmup == 10,
          "14b: GOSS strategy with warm-up 10 expected")
    n = FULL_ROWS
    in_bag = [int(sum(t.leaf_count[:t.num_leaves]))
              for t in bst.inner.models]
    check(all(v == n for v in in_bag[:10]) and len(draws) == 3,
          "14b: the 10 warm-up trees must take every row, then 3 draws")
    for v, (bag, top) in zip(in_bag[10:], torch.stack(draws).tolist()):
        # rows tied at the threshold are top rows too; each other row is
        # sampled with probability other_k / (n - top_k)
        want = strat.other_k * (n - top) / (n - strat.top_k)
        check(v == bag and top >= strat.top_k
              and abs(bag - top - want) <= 0.01 * strat.other_k,
              "14b: a GOSS tree's %d in-bag rows are not top %d (top_k "
              "%d) + %.0f sampled within 1%% of other_k %d"
              % (v, top, strat.top_k, want, strat.other_k))
    a = check_predict(bst, data, run["evals"]["auc"])
    # the draw on the card and on the CPU from the same gradients
    g, h = bst.inner.objective.get_gradients(bst.inner.train_score[:, 0])
    key = PRNGKey(int(bst.inner.config.bagging_seed) & 0x7FFFFFFF, "cuda")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    card = SS.goss_draw(g, h, key, 12, strat.top_k, strat.other_k)
    end.record()
    torch.cuda.synchronize()
    draw_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated() - before
    threads = torch.get_num_threads()
    torch.set_num_threads(max(threads, 8))
    t0 = time.perf_counter()
    cpu = SS.goss_draw(g.cpu(), h.cpu(), key.cpu(), 12, strat.top_k,
                       strat.other_k)
    cpu_s = time.perf_counter() - t0
    torch.set_num_threads(threads)
    for name, x, y in zip(("grad", "hess", "bag"), card, cpu):
        check(torch.equal(x.cpu().view(torch.int32), y.view(torch.int32)),
              "14b: the GOSS %s on the card differs from the CPU's" % name)
    w = torch.abs(g * h)
    k = strat.top_k
    v_topk = torch.topk(w, k).values[-1]
    v_kth = torch.kthvalue(w, n - k + 1).values
    check(bool(v_topk == v_kth) and bool(v_topk == SS.goss_threshold(w, k)),
          "14b: topk and kthvalue disagree")
    topk_ms = cuda_ms(lambda: torch.topk(w, k).values[-1], reps=5)
    kth_ms = cuda_ms(lambda: torch.kthvalue(w, n - k + 1).values, reps=5)
    log("14b GOSS (top_rate 0.2, other_rate 0.1, lr 0.1, 13 rounds): "
        "in-bag rows per GOSS tree %s (top_k %d + other_k %d); held-out AUC "
        "%.6f; the draw at %d rows byte-equal on the card and the CPU "
        "(grad, hess, bag); draw %.3f ms on the card (CPU %.1f s), device "
        "memory it needs above its inputs %.3f GiB; the %d-th largest |g "
        "h| by torch.topk %.3f ms, by torch.kthvalue %.3f ms (the port's "
        "goss_threshold takes topk)"
        % (in_bag[10:], strat.top_k, strat.other_k, a, n, draw_ms, cpu_s,
           peak / 2 ** 30, k, topk_ms, kth_ms))
    del bst, card, cpu, g, h, w
    torch.cuda.empty_cache()
    return run["launches"]["histogram_f32"]


def phase14_goss_quantized(lgb, hist_mod, data):
    """14c: GOSS with 8-bit gradients, lr 0.5 (warm-up 2), 4 rounds:
    every histogram through the int8 instance. (Its 3-round per-split
    rerun was cut for the script's time: whole-tree == per-split stays
    held on the card for 8-bit by phase 7's rerun, and for GOSS on the
    CPU by ``tests/test_torch_sampling.py``.)"""
    extra = {"data_sample_strategy": "goss", "learning_rate": 0.5,
             "use_quantized_grad": True, "quant_grad_bits": 8}
    bst, launches, aucs, _, _ = train_full(lgb, hist_mod, data, extra,
                                           "histogram_i8", rounds=4,
                                           tag="14c goss 8-bit")
    a = check_predict(bst, data, aucs)
    log("14c GOSS + 8-bit (lr 0.5, 4 rounds, trees 3-4 GOSS): held-out "
        "AUC %.6f; ms per split %.3f" % (a, SPLIT_MS["14c goss 8-bit"]))
    return launches["histogram_i8"]


def _paths_in_one_group(tree, groups):
    def walk(node, path):
        if node < 0:
            return True
        p = path | {int(tree.split_feature[node])}
        return (any(p <= set(g) for g in groups)
                and walk(int(tree.left_child[node]), p)
                and walk(int(tree.right_child[node]), p))
    return tree.num_leaves == 1 or walk(0, frozenset())


def phase14_node_filters(lgb, hist_mod, data):
    """14d: feature_fraction_bynode 0.5 + interaction constraints (two
    groups of 14 columns), 1 round (cut from 2 for time), through the per-split
    loop."""
    extra = {"feature_fraction_bynode": 0.5,
             "interaction_constraints": HIGGS_GROUPS}
    ds, valid, _, _ = data
    run = train_path(lgb, hist_mod, ds, valid,
                     dict(SLICE_PARAMS, num_leaves=255, **extra),
                     "histogram_f32", 1, tag="14d bynode + constraints")
    bst = run["booster"]
    check(all(_paths_in_one_group(t, HIGGS_GROUPS)
              for t in bst.inner.models),
          "14d: a root-to-leaf path mixes the constraint groups")
    reads = bst.inner.learner.grow_stats["split_reads"]
    a = check_predict(bst, data, run["evals"]["auc"])
    log("14d bynode 0.5 + interaction constraints: every path inside one "
        "group; %d record reads for %d splits; host syncs per tree %s; "
        "ms per split %.3f; held-out AUC %.6f"
        % (reads, run["splits"], run["tree_syncs"],
           SPLIT_MS["14d bynode + constraints"], a))
    return run["launches"]["histogram_f32"]


def _subtree_leaves(tree, node):
    if node < 0:
        return [~node]
    return (_subtree_leaves(tree, int(tree.left_child[node]))
            + _subtree_leaves(tree, int(tree.right_child[node])))


def phase14_cegb(lgb, hist_mod, data):
    """14e: CEGB (split, coupled and lazy penalties), 1 round (cut from 2
    for time), through the per-split loop; the lazy fetched state after tree 1
    against the tree's own partition."""
    import torch
    from lightgbm_tpu_torch.treelearner import serial
    ds, valid, _, _ = data
    grow = serial.SerialTreeLearner.train
    after_tree1 = {}

    def train(self, *args):
        tree, leaf_of_row = grow(self, *args)
        if not after_tree1:
            after_tree1.update(tree=tree, leaf_of_row=leaf_of_row.clone(),
                               fetched=self._cegb_fetched.clone(),
                               used=self._cegb_used.clone())
        return tree, leaf_of_row
    serial.SerialTreeLearner.train = train
    try:
        run = train_path(lgb, hist_mod, ds, valid,
                         dict(SLICE_PARAMS, num_leaves=255, **CEGB_PARAMS),
                         "histogram_f32", 1, tag="14e cegb")
    finally:
        serial.SerialTreeLearner.train = grow
    bst = run["booster"]
    learner = bst.inner.learner
    reads = bst.inner.learner.grow_stats["split_reads"]
    used = {int(f) for t in bst.inner.models
            for f in t.split_feature[:t.num_internal]}
    check(not used & set(range(20, 28)),
          "14e: a column with coupled penalty 1e9 was split on: %s"
          % sorted(used & set(range(20, 28))))
    plain = train_path(lgb, hist_mod, ds, valid,
                       dict(SLICE_PARAMS, num_leaves=255), "histogram_f32",
                       1, tag="14e without penalties")["booster"]
    check([t.to_string() for t in plain.inner.models]
          != [t.to_string() for t in bst.inner.models],
          "14e: the CEGB trees equal the trees without penalties")
    # tree 1: row r has fetched feature f iff its leaf lies under a node
    # that splits on f; no other feature is fetched
    t1 = after_tree1["tree"]
    leaf_of_row = after_tree1["leaf_of_row"]
    fetched = after_tree1["fetched"]
    nodes = {}
    for node in range(t1.num_internal):
        nodes.setdefault(int(t1.split_feature_inner[node]), []).append(node)
    for f in range(learner.F):
        leaves = [lf for node in nodes.get(f, [])
                  for lf in _subtree_leaves(t1, node)]
        want = torch.isin(leaf_of_row, torch.tensor(
            sorted(set(leaves)), dtype=leaf_of_row.dtype, device="cuda"))
        check(torch.equal(fetched[:, f], want),
              "14e: fetched column %d after tree 1 is not the rows that "
              "passed a node on it" % f)
    check(torch.equal(after_tree1["used"][:learner.F].cpu(),
                      torch.tensor([f in nodes for f in range(learner.F)])),
          "14e: the used-feature vector after tree 1 is not tree 1's "
          "features")
    a = check_predict(bst, data, run["evals"]["auc"])
    log("14e CEGB: columns split on %s (20-27 never); trees differ from "
        "the run without penalties; fetched after tree 1 == the rows "
        "under each feature's nodes for all %d features; fetched state "
        "%d bytes (bool [%d, %d]); %d record reads for %d splits; ms per "
        "split %.3f (without penalties, whole-tree: %.3f); held-out AUC "
        "%.6f"
        % (sorted(used), learner.F, fetched.numel(), fetched.shape[0],
           fetched.shape[1], reads, run["splits"], SPLIT_MS["14e cegb"],
           SPLIT_MS["14e without penalties"], a))
    del bst, plain, after_tree1, fetched, learner
    torch.cuda.empty_cache()
    return run["launches"]["histogram_f32"]


def _split_trace(lgb, params, X, y):
    """Tree 1 of ``params`` with, for each split of the per-split loop in
    the order it was made, the winner (leaf, feature, threshold bin) and
    the candidate table it won from: every leaf's [gain, feature,
    threshold bin], read before the split."""
    from lightgbm_tpu_torch.ops import split as S
    from lightgbm_tpu_torch.treelearner import serial
    split = serial.SerialTreeLearner._split
    cols = [S.GAIN, S.FEATURE, S.THRESHOLD_BIN]
    trace = []

    def traced(self, state, rec, *args):
        trace.append(((rec.leaf, rec.feature, rec.threshold_bin),
                      state.cand[:, cols].cpu().numpy()))
        return split(self, state, rec, *args)
    serial.SerialTreeLearner._split = traced
    try:
        b = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=1)
    finally:
        serial.SerialTreeLearner._split = split
    return b.inner.models[0], trace


def _ulps(a, b) -> float:
    """|a - b| in f32 spacings at the larger magnitude."""
    return abs(float(a) - float(b)) / float(
        np.spacing(np.float32(max(abs(a), abs(b)))))


def phase14_node_filters_f32_order(lgb, X, y, base):
    """14d in f32, tree 1 on cuda against cpu, split by split. Node masks
    are drawn from one host RNG in the order the splits are made, so the
    trees agree as long as the split order does. Up to the first split
    where the winners differ, the winners must agree; at that split the
    candidate tables of both devices must hold the same candidate
    (feature, threshold) in every leaf -- the same masks and partitions
    -- and the two winners must be a near-tie: each device's gap
    between them no larger than the largest cross-device gain difference
    of one candidate in that table (the f32 rounding of the two
    devices' histograms)."""
    import torch
    extra = {"feature_fraction_bynode": 0.5,
             "interaction_constraints": HIGGS_GROUPS}
    threads = torch.get_num_threads()
    res = {}
    for dev in ("cuda", "cpu"):
        torch.set_num_threads(1 if dev == "cpu" else threads)
        res[dev] = _split_trace(lgb, dict(base, device_type=dev, **extra),
                                X, y)
    torch.set_num_threads(threads)
    (t_cuda, tr_cuda), (t_cpu, tr_cpu) = res["cuda"], res["cpu"]
    k = next((i for i, (u, v) in enumerate(zip(tr_cuda, tr_cpu))
              if u[0] != v[0]), None)
    if k is None:
        check(len(tr_cuda) == len(tr_cpu)
              and tree_structure(t_cuda) == tree_structure(t_cpu),
              "14d f32: the same split order, yet tree 1 differs between "
              "cuda and cpu")
        log("14d bynode + constraints, f32 at %d rows: tree 1 the same "
            "tree on cuda and cpu, %d splits in the same order"
            % (CROSS_ROWS, len(tr_cuda)))
        return
    (wa, ca), (wb, cb) = tr_cuda[k], tr_cpu[k]
    live = np.isfinite(ca[:, 0]) & np.isfinite(cb[:, 0])
    same_cands = (np.array_equal(np.isfinite(ca[:, 0]),
                                 np.isfinite(cb[:, 0]))
                  and np.array_equal(ca[live, 1:], cb[live, 1:]))
    diff = np.abs(ca[live, 0].astype(np.float64) - cb[live, 0])
    worst = int(np.flatnonzero(live)[int(np.argmax(diff))])
    rounding = float(diff.max())
    a, b = wa[0], wb[0]
    gap_cuda = float(ca[a, 0]) - float(ca[b, 0])
    gap_cpu = float(cb[b, 0]) - float(cb[a, 0])
    log("14d bynode + constraints, f32 at %d rows: splits 1-%d the same "
        "on cuda and cpu; split %d: cuda splits leaf %d (feature %d, bin "
        "%d), cpu leaf %d (feature %d, bin %d); gains on cuda %.9g vs "
        "%.9g (gap %.3g, %.1f ulp), on cpu %.9g vs %.9g (gap %.3g, %.1f "
        "ulp); the candidate tables hold the same (feature, bin) in "
        "every leaf: %s; largest cross-device gain difference of one "
        "candidate %.3g (%.1f ulp, leaf %d)"
        % (CROSS_ROWS, k, k + 1, a, wa[1], wa[2], b, wb[1], wb[2],
           ca[a, 0], ca[b, 0], gap_cuda, _ulps(ca[a, 0], ca[b, 0]),
           cb[b, 0], cb[a, 0], gap_cpu, _ulps(cb[a, 0], cb[b, 0]),
           same_cands, rounding, _ulps(ca[worst, 0], cb[worst, 0]),
           worst))
    check(same_cands, "14d f32: at split %d the candidate tables of cuda "
          "and cpu differ (masks or partitions differ)" % (k + 1))
    check(a != b and 0.0 <= gap_cuda <= rounding
          and 0.0 <= gap_cpu <= rounding,
          "14d f32: the first differing split %d is not a near-tie "
          "between two leaves" % (k + 1))


def phase14_cuda_vs_cpu(lgb):
    """Tree 1 on cuda and on cpu at ``CROSS_ROWS`` rows of phase 3's
    generator, 63 leaves, for
    14a's, 14d's and 14e's settings and GOSS: the same tree (structure,
    as phase 11 compares). GOSS runs at learning_rate 2.0, whose warm-up
    int(1 / lr) is 0, so that tree 1 is a GOSS tree. 14d's node masks
    are drawn in the order the splits are made, so two leaves whose f32
    gains tie within rounding, split in the other order, re-deal every
    later mask: 14d's whole tree is compared with 8-bit gradients, whose
    integer histograms give both devices the same sums, and in f32 up to
    its first differing split (:func:`phase14_node_filters_f32_order`)."""
    import torch
    X, y = make_higgs_like(CROSS_ROWS, seed=7)
    base = dict(SLICE_PARAMS, num_leaves=63)
    cases = (("14a ff + extra_trees",
              {"feature_fraction": 0.9, "extra_trees": True}),
             ("14b GOSS", {"data_sample_strategy": "goss",
                           "learning_rate": 2.0}),
             ("14d bynode + constraints, 8-bit",
              {"feature_fraction_bynode": 0.5,
               "interaction_constraints": HIGGS_GROUPS,
               "use_quantized_grad": True, "quant_grad_bits": 8}),
             ("14e CEGB", CEGB_PARAMS))
    threads = torch.get_num_threads()
    for what, extra in cases:
        trees = {}
        for dev in ("cuda", "cpu"):
            torch.set_num_threads(1 if dev == "cpu" else threads)
            b = lgb.train(dict(base, device_type=dev, **extra),
                          lgb.Dataset(X, label=y), num_boost_round=1)
            trees[dev] = b.inner.models[0]
        torch.set_num_threads(threads)
        check(tree_structure(trees["cuda"]) == tree_structure(trees["cpu"]),
              "%s: tree 1 differs between cuda and cpu: first splits "
              "(leaves, features, thresholds) %s against %s"
              % (what, [v[:12] if isinstance(v, list) else v
                        for v in tree_splits_of(trees["cuda"])],
                 [v[:12] if isinstance(v, list) else v
                  for v in tree_splits_of(trees["cpu"])]))
        log("%s at %d rows: tree 1 the same tree on cuda and cpu (%s, %d "
            "leaves)" % (what, CROSS_ROWS,
                         "splits in the same order"
                         if tree_splits_of(trees["cuda"])
                         == tree_splits_of(trees["cpu"])
                         else "the same splits, added in another order",
                         trees["cuda"].num_leaves))
    phase14_node_filters_f32_order(lgb, X, y, base)


def phase_sampling(lgb, hist_mod, data):
    """Phase 14: returns the launches of each run by kernel and path."""
    runs = {"histogram_f32": {}, "histogram_i8": {}}
    f32 = runs["histogram_f32"]
    f32["phase14a_higgs_ff_extra_trees"] = phase14_ff_extra_trees(
        lgb, hist_mod, data)
    f32["phase14b_higgs_goss"] = phase14_goss(lgb, hist_mod, data)
    runs["histogram_i8"]["phase14c_higgs_goss_8bit"] = \
        phase14_goss_quantized(lgb, hist_mod, data)
    f32["phase14d_higgs_bynode_constraints"] = phase14_node_filters(
        lgb, hist_mod, data)
    f32["phase14e_higgs_cegb"] = phase14_cegb(lgb, hist_mod, data)
    phase14_cuda_vs_cpu(lgb)
    return runs


# ---------------------------------------------------------------------------
# phase 15: monotone constraints, forced splits, linear trees
# ---------------------------------------------------------------------------
def higgs_constraints(rows: int = 100_000):
    """+1 on the 4 columns most positively correlated with the label in
    the first ``rows`` training rows, -1 on the 2 most negative."""
    X = HEAD["X"][:rows].astype(np.float64)
    y = HEAD["y"][:rows]
    corr = np.array([np.corrcoef(X[:, j], y)[0, 1]
                     for j in range(X.shape[1])])
    order = np.argsort(corr)
    mc = [0] * X.shape[1]
    for j in order[-4:]:
        mc[int(j)] = 1
    for j in order[:2]:
        mc[int(j)] = -1
    check(all(corr[j] > 0 for j in order[-4:])
          and all(corr[j] < 0 for j in order[:2]),
          "15: the constrained columns' correlations have the wrong sign")
    log("15 constraints: +1 on columns %s (corr %s), -1 on %s (corr %s)"
        % ([int(j) for j in order[-4:]],
           " ".join("%.4f" % corr[j] for j in order[-4:]),
           [int(j) for j in order[:2]],
           " ".join("%.4f" % corr[j] for j in order[:2])))
    return mc


def constrained(lgb, data, mc):
    """The first ``LINEAR_ROWS`` of phase 4's training rows and its
    held-out set as Datasets with the monotone constraints ``mc``, built
    through the Dataset entry point (binned again; all 10.5M rows until
    the budget of phases 21 and 22)."""
    _, _, Xv, yv = data
    t0 = time.perf_counter()
    dsm = lgb.Dataset(HEAD["X"], label=HEAD["y"],
                      params=dict(SLICE_PARAMS,
                                  monotone_constraints=mc)).construct()
    vm = lgb.Dataset(Xv, label=yv, reference=dsm).construct()
    log("15a-c: the first %d training rows binned again with "
        "monotone_constraints in %.3f s"
        % (len(HEAD["y"]), time.perf_counter() - t0))
    return dsm, vm


def check_monotone_grid(bst, Xv, mc, what, rows=1000, points=64):
    """Raw predictions (stacked path) of ``rows`` held-out rows with each
    constrained column set to a 64-point grid over its 1-99% range must
    be monotone in the constraint's direction, exactly."""
    X = Xv[:rows]
    worst = {}
    for j, sign in enumerate(mc):
        if not sign:
            continue
        lo, hi = np.percentile(X[:, j], [1, 99])
        grid = np.linspace(lo, hi, points).astype(np.float32)
        Xg = np.repeat(X[None], points, axis=0)
        Xg[:, :, j] = grid[:, None]
        pred = bst.predict(Xg.reshape(-1, X.shape[1]), raw_score=True)
        d = np.diff(pred.reshape(points, rows), axis=0) * sign
        worst[j] = float(d.min())
        check(worst[j] >= 0.0, "%s: predictions fall along column %d "
              "against its +%d constraint (step %.3g)"
              % (what, j, sign, worst[j]))
    pred = stacked_predictor(bst)
    check(pred is not None and sum(pred.entries.values()) > 0,
          "%s: the grid did not go through the stacked path" % what)
    log("%s: predictions monotone on %d held-out rows x %d grid points in "
        "each constrained column (stacked path; smallest step along the "
        "constraint per column: %s)"
        % (what, rows, points, " ".join("%d: %.3g" % kv
                                         for kv in worst.items())))


def rerun_equal(lgb, hist_mod, ds, valid, params, kernel, bst, what,
                rounds=RERUN_ROUNDS):
    """A per-split run of ``rounds`` rounds must give ``bst``'s first
    trees, text for text."""
    again = train_path(lgb, hist_mod, ds, valid,
                       dict(params, tpu_fused_tree=False), kernel, rounds,
                       tag="%s per-split rerun" % what)["booster"]
    first = [t.to_string() for t in bst.inner.models[:rounds]]
    check(first == [t.to_string() for t in again.inner.models],
          "%s: the per-split rerun gave other trees" % what)
    log("%s per-split rerun (%d rounds): text-equal to the whole-tree "
        "run's first %d trees" % (what, rounds, rounds))


def phase15_basic(lgb, hist_mod, data, mc):
    """15a: basic monotone, 5 rounds through the captured whole-tree
    step; returns the constrained (train, valid) Datasets, the launches
    and the held-out AUC per round."""
    _, _, Xv, _ = data
    dsm, valid = constrained(lgb, data, mc)
    params = dict(SLICE_PARAMS, num_leaves=255, monotone_constraints=mc)
    tag = "15a basic monotone"
    run = train_path(lgb, hist_mod, dsm, valid, params, "histogram_f32", 5,
                     tag=tag)
    bst = run["booster"]
    learner = bst.inner.learner
    check(learner._has_mono and run["fused"]
          and learner.grow_stats["captures"] == 1,
          "15a did not train through the captured whole-tree step")
    a = check_predict(bst, data, run["evals"]["auc"])
    check_monotone_grid(bst, Xv, mc, "15a")
    log("15a basic monotone: s per iteration %s; ms per split %.3f "
        "(phase 4 in this call: %s); host syncs per tree %s; held-out "
        "AUC %.6f"
        % (" ".join("%.3f" % v for v in run["per_iter"]), SPLIT_MS[tag],
           "%.3f" % SPLIT_MS[PHASE4_TAG] if PHASE4_TAG in SPLIT_MS
           else "not run", run["tree_syncs"], a))
    rerun_equal(lgb, hist_mod, dsm, valid, params, "histogram_f32", bst,
                "15a basic monotone")
    del bst, learner
    return (dsm, valid), run["launches"]["histogram_f32"], \
        run["evals"]["auc"]


def phase15_methods(lgb, hist_mod, data, sets, mc, basic_aucs):
    """15b: the intermediate method, 1 round (cut from 2 for time), and the
    advanced method, 1 round at ``CUT_LEAVES`` leaves beside a basic round at as many (~80
    s a tree at 255 leaves), on the constrained ``sets``."""
    Xv = data[2]
    dsm, valid = sets
    out = {}
    for method, rounds, leaves in (("intermediate", 1, 255),
                                   ("advanced", 1, CUT_LEAVES)):
        tag = "15b %s" % method
        basic_auc = basic_aucs[rounds - 1]
        if leaves != 255:
            base = train_path(lgb, hist_mod, dsm, valid,
                              dict(SLICE_PARAMS, num_leaves=leaves,
                                   monotone_constraints=mc),
                              "histogram_f32", rounds,
                              tag="15b basic, %d leaves" % leaves)
            basic_auc = base["evals"]["auc"][rounds - 1]
            out["phase15b_higgs_basic_%d_leaves" % leaves] = \
                base["launches"]["histogram_f32"]
            del base
        run = train_path(lgb, hist_mod, dsm, valid,
                         dict(SLICE_PARAMS, num_leaves=leaves,
                              monotone_constraints=mc,
                              monotone_constraints_method=method),
                         "histogram_f32", rounds, tag=tag)
        bst = run["booster"]
        learner = bst.inner.learner
        stats = learner.grow_stats
        check(learner._mono_tracker is not None and not run["fused"],
              "%s did not take the host-tracked per-split loop" % tag)
        a = check_predict(bst, data, run["evals"]["auc"])
        check(a >= basic_auc - 0.002, "%s: held-out AUC %.6f below basic's "
              "%.6f - 0.002 after %d rounds" % (tag, a, basic_auc, rounds))
        check_monotone_grid(bst, Xv, mc, tag)
        splits = run["splits"]
        log("%s, %d leaves: ms per split %.3f (tree seconds / splits); "
            "host syncs per split %.2f (%s per tree); record reads per "
            "split %.2f; rescans per tree %.1f; held-out AUC %.6f (basic "
            "after %d rounds at as many leaves %.6f)"
            % (tag, leaves, SPLIT_MS[tag], sum(run["tree_syncs"]) / splits,
               run["tree_syncs"], stats["split_reads"] / splits,
               stats["rescans"] / len(bst.inner.models), a, rounds,
               basic_auc))
        out["phase15b_higgs_%s" % method] = run["launches"]["histogram_f32"]
        del bst, learner
    return out


def _shallow_features(tree, depth: int):
    """The split columns of the nodes at depth <= ``depth``."""
    out, frontier = [], [0] if tree.num_leaves > 1 else []
    for _ in range(depth + 1):
        nxt = []
        for node in frontier:
            out.append(int(tree.split_feature[node]))
            nxt += [int(c) for c in (tree.left_child[node],
                                     tree.right_child[node]) if c >= 0]
        frontier = nxt
    return out


def phase15_penalty(lgb, hist_mod, data, sets, mc):
    """15c: monotone_penalty 2.0 with the basic method, 2 rounds: no
    constrained column splits at depth 0 or 1."""
    dsm, valid = sets
    run = train_path(lgb, hist_mod, dsm, valid,
                     dict(SLICE_PARAMS, num_leaves=255,
                          monotone_constraints=mc, monotone_penalty=2.0),
                     "histogram_f32", 2, tag="15c monotone_penalty 2.0")
    shallow = [_shallow_features(t, 1) for t in run["booster"].inner.models]
    check(all(mc[f] == 0 for fs in shallow for f in fs),
          "15c: a constrained column splits at depth 0 or 1: %s" % shallow)
    log("15c monotone_penalty 2.0: the columns split at depths 0-1 of each "
        "tree: %s (none constrained)" % shallow)
    return run["launches"]["histogram_f32"]


def forced_spec():
    """Three forced nodes: the root on column 0 and its children on
    columns 1 and 2, each at the column's median in the head rows."""
    med = np.median(HEAD["X"][:100_000, :3], axis=0)
    return {"feature": 0, "threshold": float(med[0]),
            "left": {"feature": 1, "threshold": float(med[1])},
            "right": {"feature": 2, "threshold": float(med[2])}}


def phase15_forced(lgb, hist_mod, data, path):
    """15d: forced splits, 3 rounds in f32 and in 8-bit through the
    whole-tree loop; every tree starts with the three forced nodes, and
    1-round per-split reruns are text-equal."""
    ds, valid, _, _ = data
    spec = forced_spec()
    out = {}
    for bits, kernel in (("f32", "histogram_f32"), ("8-bit",
                                                     "histogram_i8")):
        extra = {"forcedsplits_filename": path}
        if bits == "8-bit":
            extra.update(use_quantized_grad=True, quant_grad_bits=8)
        params = dict(SLICE_PARAMS, num_leaves=255, **extra)
        tag = "15d forced %s" % bits
        run = train_path(lgb, hist_mod, ds, valid, params, kernel, 3,
                         tag=tag)
        bst = run["booster"]
        stats = bst.inner.learner.grow_stats
        check(run["fused"] and stats["forced_reads"] == 9,
              "%s: expected the whole-tree loop and 3 forced reads per "
              "tree, got %d reads" % (tag, stats["forced_reads"]))
        mappers = bst.inner.train_data.bin_mappers
        want = [(n["feature"], int(mappers[n["feature"]].value_to_bin(
            np.asarray([n["threshold"]]))[0]))
            for n in (spec, spec["left"], spec["right"])]
        for t in bst.inner.models:
            got = [(int(t.split_feature[i]), int(t.threshold_in_bin[i]))
                   for i in range(3)]
            check(got == want and not t.split_gain[:3].any(),
                  "%s: a tree's first nodes %s are not the forced %s"
                  % (tag, got, want))
        log("%s: every tree's first three nodes are the forced (column, "
            "bin) %s, gain 0; s per iteration %s; ms per split %.3f; "
            "held-out AUC %.6f"
            % (tag, want, " ".join("%.3f" % v for v in run["per_iter"]),
               SPLIT_MS[tag], run["evals"]["auc"][-1]))
        rerun_equal(lgb, hist_mod, ds, valid, params, kernel, bst, tag)
        out[kernel] = run["launches"][kernel]
        del bst
    return out


def linear_f32_bound(trees, X, leaves):
    """[n] bound on |f32 raw_device - f64 host walk| of a linear forest,
    from the host's trees: a leaf with k fitted features gives ``const +
    sum(coeff * x)`` in f32 within (k + 3) f32 ulp of ``m = |const| +
    sum |coeff * x|`` (the constant's and each coefficient's rounding to
    f32, each product, the sum), and the Kahan sum over trees adds 2 ulp
    of each term; so eps32 * sum over trees of (k + 5) * m, with m =
    |leaf_value| at a leaf without a fit or a row with NaN in one of its
    features. ``leaves`` [n, T] are the host walk's leaf ids."""
    X = np.asarray(X, dtype=np.float64)
    out = np.zeros(X.shape[0])
    for t, tree in enumerate(trees):
        nl = tree.num_leaves
        coeff = np.zeros((nl, X.shape[1]))
        used = np.zeros((nl, X.shape[1]), dtype=bool)
        for lf in range(nl):
            feats = tree.leaf_features[lf]
            coeff[lf, feats] = tree.leaf_coeff[lf]
            used[lf, feats] = True
        k = used.sum(axis=1)
        lf = leaves[:, t]
        u = used[lf]
        terms = np.where(u, np.abs(coeff[lf] * X), 0.0)
        lin = np.abs(np.asarray(tree.leaf_const[:nl]))[lf] + terms.sum(1)
        plain = (k[lf] == 0) | (np.isnan(X) & u).any(axis=1)
        m = np.where(plain, np.abs(tree.leaf_value[:nl])[lf], lin)
        out += (k[lf] + 5) * m
    return np.finfo(np.float32).eps * out


def phase15_linear(lgb, hist_mod, data):
    """15e: linear trees (linear_lambda 0.1), 3 rounds on the first
    LINEAR_ROWS training rows."""
    import torch
    from lightgbm_tpu_torch.boosting import gbdt as G
    _, _, Xv, yv = data
    params = dict(SLICE_PARAMS, num_leaves=255, linear_tree=True,
                  linear_lambda=0.1)
    t0 = time.perf_counter()
    dsl = lgb.Dataset(HEAD["X"], label=HEAD["y"], params=params).construct()
    vl = lgb.Dataset(Xv, label=yv, reference=dsl, params=params).construct()
    log("15e linear trees: depth cut to the first %d of the %d training "
        "rows (a Dataset that keeps raw rows bins them again); binning "
        "seconds %.3f" % (LINEAR_ROWS, FULL_ROWS,
                          time.perf_counter() - t0))
    fit = G.fit_linear_leaves
    fit_ms = []

    def timed_fit(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fit(*args, **kwargs)
        torch.cuda.synchronize()
        fit_ms.append(1e3 * (time.perf_counter() - t))
    G.fit_linear_leaves = timed_fit
    try:
        run = train_path(lgb, hist_mod, dsl, vl, params, "histogram_f32", 3,
                         tag="15e linear")
    finally:
        G.fit_linear_leaves = fit
    bst = run["booster"]
    trees = bst.inner.models
    fitted = [sum(bool(f) for f in t.leaf_features[:t.num_leaves])
              for t in trees]
    check(all(t.is_linear for t in trees) and min(fitted) > 0,
          "15e: trees without linear leaves (%s)" % fitted)
    a = check_predict(bst, data, run["evals"]["auc"])
    Xs = Xv[:100_000]
    check_stacked(bst, Xs, "15e linear")
    forest = stacked_predictor(bst).forest
    raw32 = forest.predict_raw_device(Xs)[:, 0].double().cpu().numpy()
    vals = forest.tree_values_device(Xs).double().cpu().numpy()
    bound = 2 * np.finfo(np.float32).eps * np.abs(vals).sum(axis=0)
    err = np.abs(raw32 - vals.sum(axis=0))
    check(bool(np.all(err <= bound)), "15e: raw_device off the f64 sum of "
          "its f32 terms by %.3g, Kahan's bound %.3g"
          % (float(err.max()), float(bound.max())))
    # the card's f32 linear leaves against the host's f64 walk, which
    # shares none of their code
    host = bst.predict(Xs, raw_score=True, predict_on_device=False)
    host_bound = linear_f32_bound(trees, Xs, bst.predict(
        Xs, pred_leaf=True, predict_on_device=False))
    host_err = np.abs(raw32 - host)
    check(bool(np.all(host_err <= host_bound)), "15e: raw_device off the "
          "host f64 walk by %.3g where its f32 rounding bound is %.3g"
          % (float(host_err.max()),
             float(host_bound[int(np.argmax(host_err))])))
    text = bst.model_to_string()
    again = lgb.Booster(model_str=text, params={"device_type": "cpu"})

    def trees_of(s):
        return s[s.index("Tree=0"):s.index("end of trees")]
    check(trees_of(again.model_to_string()) == trees_of(text)
          and np.array_equal(again.predict(Xs[:4096],
                                           predict_on_device=False),
                             bst.predict(Xs[:4096],
                                         predict_on_device=False)),
          "15e: the linear model text does not round-trip")
    log("15e linear: fit ms per tree %s; fitted leaves per tree %s; s per "
        "iteration %s; ms per split %.3f; held-out AUC %.6f; raw_device "
        "within Kahan's bound of its own terms (max err %.3g, bound at that "
        "row %.3g) and within the f32 rounding bound of the host f64 walk "
        "(max err %.3g, bound at that row %.3g); the text round-trips"
        % (" ".join("%.3f" % v for v in fit_ms), fitted,
           " ".join("%.3f" % v for v in run["per_iter"]),
           SPLIT_MS["15e linear"], a, float(err.max()),
           float(bound[int(np.argmax(err))]), float(host_err.max()),
           float(host_bound[int(np.argmax(host_err))])))
    del bst, dsl, vl
    torch.cuda.empty_cache()
    return run["launches"]["histogram_f32"]


def phase15_cuda_vs_cpu(lgb, mc, path):
    """Tree 1 on cuda and on cpu at ``CROSS_ROWS`` rows of phase 3's
    generator (63 leaves):
    basic monotone (f32), intermediate (8-bit), forced (f32) and linear
    (f32) must be the same tree; the linear fit of the card's tree 1,
    run again on the CPU from the same inputs, gives its coefficients
    within rtol 1e-9."""
    import copy
    import torch
    from lightgbm_tpu_torch.boosting import gbdt as G
    X, y = make_higgs_like(CROSS_ROWS, seed=7)
    base = dict(SLICE_PARAMS, num_leaves=63)
    cases = (("15 basic monotone, f32", {"monotone_constraints": mc}),
             ("15 intermediate, 8-bit",
              {"monotone_constraints": mc,
               "monotone_constraints_method": "intermediate",
               "use_quantized_grad": True, "quant_grad_bits": 8}),
             ("15 forced, f32", {"forcedsplits_filename": path}),
             ("15 linear, f32", {"linear_tree": True, "linear_lambda": 0.1}))
    fit = G.fit_linear_leaves
    captured = []

    def capture(tree, *args):
        before = copy.deepcopy(tree)
        fit(tree, *args)
        captured.append((before, args, copy.deepcopy(tree)))
    threads = torch.get_num_threads()
    for what, extra in cases:
        trees = {}
        for dev in ("cuda", "cpu"):
            torch.set_num_threads(1 if dev == "cpu" else threads)
            G.fit_linear_leaves = capture if dev == "cuda" else fit
            try:
                b = lgb.train(dict(base, device_type=dev, **extra),
                              lgb.Dataset(X, label=y), num_boost_round=1)
            finally:
                G.fit_linear_leaves = fit
            trees[dev] = b.inner.models[0]
        torch.set_num_threads(threads)
        check(tree_structure(trees["cuda"]) == tree_structure(trees["cpu"]),
              "%s: tree 1 differs between cuda and cpu: first splits %s "
              "against %s"
              % (what, [v[:12] if isinstance(v, list) else v
                        for v in tree_splits_of(trees["cuda"])],
                 [v[:12] if isinstance(v, list) else v
                  for v in tree_splits_of(trees["cpu"])]))
        note = ""
        if "linear_tree" in extra:
            tree, args, card = captured[-1]
            fit(tree, *[a.cpu() if isinstance(a, torch.Tensor) else a
                        for a in args])
            nl = card.num_leaves
            check(tree.leaf_features[:nl] == card.leaf_features[:nl]
                  and any(card.leaf_features[:nl]),
                  "%s: the CPU refit chose other leaf features" % what)
            rel = max(float(np.max(np.abs(np.subtract(a, b))
                                   / np.maximum(np.abs(a), 1e-300)))
                      for a, b in zip(tree.leaf_coeff[:nl],
                                      card.leaf_coeff[:nl]) if a)
            check(rel <= 1e-9, "%s: the card's fit differs from the CPU's "
                  "on the same inputs by rtol %.3g" % (what, rel))
            cpu_rel = max(float(np.max(np.abs(np.subtract(a, b))
                                       / np.maximum(np.abs(a), 1e-300)))
                          for a, b in zip(trees["cpu"].leaf_coeff[:nl],
                                          trees["cuda"].leaf_coeff[:nl])
                          if a)
            note = ("; coefficients: the card's fit against the CPU's on "
                    "the same inputs rtol %.3g, against the CPU run's "
                    "own tree rtol %.3g" % (rel, cpu_rel))
        log("%s at %d rows: tree 1 the same tree on cuda and cpu (%s, %d "
            "leaves)%s" % (what, CROSS_ROWS,
                           "splits in the same order"
                           if tree_splits_of(trees["cuda"])
                           == tree_splits_of(trees["cpu"])
                           else "the same splits, added in another order",
                           trees["cuda"].num_leaves, note))


def phase_constraints(lgb, hist_mod, data):
    """Phase 15: returns the launches of each run by kernel and path."""
    import tempfile
    import torch
    runs = {"histogram_f32": {}, "histogram_i8": {}}
    f32 = runs["histogram_f32"]
    mc = higgs_constraints()
    sets, f32["phase15a_higgs_monotone_basic"], aucs = phase15_basic(
        lgb, hist_mod, data, mc)
    f32.update(phase15_methods(lgb, hist_mod, data, sets, mc, aucs))
    f32["phase15c_higgs_monotone_penalty"] = phase15_penalty(
        lgb, hist_mod, data, sets, mc)
    del sets
    torch.cuda.empty_cache()
    fd, path = tempfile.mkstemp(suffix=".json")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(forced_spec(), fh)
        forced = phase15_forced(lgb, hist_mod, data, path)
        f32["phase15d_higgs_forced"] = forced["histogram_f32"]
        runs["histogram_i8"]["phase15d_higgs_forced_8bit"] = \
            forced["histogram_i8"]
        f32["phase15e_higgs_linear"] = phase15_linear(lgb, hist_mod, data)
        phase15_cuda_vs_cpu(lgb, mc, path)
    finally:
        os.remove(path)
    return runs


def tree_splits_of(tree):
    ni = tree.num_internal
    return (tree.num_leaves, list(tree.split_feature[:ni]),
            list(tree.threshold[:ni]))


def tree_structure(tree, node: int = 0):
    """A tree as nested (feature, threshold, default left, left, right)
    with leaves as their row counts: the same splits compare equal
    whatever order the leaf-wise grower added them in (two leaves whose
    best gains tie within f32 rounding may be split in either order)."""
    if tree.num_leaves == 1:
        return int(tree.leaf_count[0])
    if node < 0:
        return int(tree.leaf_count[~node])
    return (int(tree.split_feature[node]), float(tree.threshold[node]),
            int(tree.decision_type[node]),
            tree_structure(tree, int(tree.left_child[node])),
            tree_structure(tree, int(tree.right_child[node])))


# ---------------------------------------------------------------------------
# phase 16: wide bins (max_bin 1023: uint16 bins, B = 1024)
# ---------------------------------------------------------------------------
WIDE_MAX_BIN = 1023
#: phase 12's model text (its first REFIT_ITERATIONS iterations),
#: refit in phase 18
PHASE12 = {}
REFIT_ITERATIONS = 20


def wide_data(lgb, data):
    """The first ``LINEAR_ROWS`` (2,097,152) of phase 4's training rows
    binned again at max_bin 1023 (uint16 bins; cut from all 10.5M for
    the budget of phases 21 and 22), and the held-out rows aligned to
    them."""
    _, _, Xv, yv = data
    t0 = time.perf_counter()
    ds = lgb.Dataset(HEAD["X"], label=HEAD["y"],
                     params=dict(SLICE_PARAMS,
                                 max_bin=WIDE_MAX_BIN)).construct()
    valid = lgb.Dataset(Xv, label=yv, reference=ds).construct()
    h = ds.handle
    nb = h.num_bin_per_feature
    check(h.bins.dtype == np.uint16 and h.max_num_bin > 256,
          "max_bin %d binned to %s with at most %d bins"
          % (WIDE_MAX_BIN, h.bins.dtype, h.max_num_bin))
    log("phase 16 binning seconds at max_bin %d (%d rows): %.3f; bins per "
        "feature %d-%d (uint16 matrix, %d MB)"
        % (WIDE_MAX_BIN, h.num_data, time.perf_counter() - t0,
           int(nb.min()), int(nb.max()), h.bins.nbytes >> 20))
    return ds, valid, Xv, yv


def phase_wide(lgb, hist_mod, data, errs, rows):
    """Training at max_bin 1023 on the first 2,097,152 of phase 4's rows
    (:func:`wide_data`): f32 for 5 rounds (held-
    out AUC > 0.7 and equal to the device scores', stacked predict ==
    host walk, a 2-round per-split rerun text-equal), 8-bit for 3 rounds
    and 16-bit for 2 (each a 1-round per-split rerun text-equal), each
    through its uint16 instance only (device launches == roots + steps);
    ms per split and syncs per tree beside phase 4's; tree 1 at 200k
    rows the same on cuda and cpu in f32, 8-bit and 16-bit (one binning
    of those rows for the three); then the uint16 instances timed over
    the learner's own bins repeated to phase 4's 10.5M rows, the root
    shape of the other instances (appended to ``rows`` when phase 5 made
    them). Returns (launches by kernel and path, the binned data)."""
    import torch
    wdata = wide_data(lgb, data)
    extra = {"max_bin": WIDE_MAX_BIN}
    tag = "phase 16 max_bin 1023 f32"
    bst, launches, aucs, _, _ = train_full(lgb, hist_mod, wdata, extra,
                                           "histogram_u16_f32", tag=tag)
    learner = bst.inner.learner
    check(learner.bins.dtype == torch.uint16 and learner.B == 1024,
          "phase 16: the learner holds %s bins at B = %d"
          % (learner.bins.dtype, learner.B))
    a = check_predict(bst, wdata, aucs)
    check_stacked(bst, wdata[2][:100_000], "phase 16 max_bin 1023")
    check_rerun(lgb, hist_mod, wdata, extra, "histogram_u16_f32", bst,
                "max_bin 1023 f32", rounds=2)
    by_path = {"histogram_u16_f32": {
        "phase16_higgs_max_bin_1023": launches["histogram_u16_f32"]}}
    log("phase 16 against phase 4 in this call: ms per split %.3f at "
        "max_bin 1023 (B = 1024, uint16) on %d rows vs %s at max_bin 255 "
        "on %d rows; held-out AUC %.6f"
        % (SPLIT_MS[tag], learner.N, "%.3f" % SPLIT_MS[PHASE4_TAG]
           if PHASE4_TAG in SPLIT_MS else "not run", FULL_ROWS, a))
    bins = learner.bins
    del bst, learner
    qtag = "phase 16 max_bin 1023 8-bit"
    q8 = dict(extra, use_quantized_grad=True)
    q, qlaunch, qaucs, _, _ = train_full(
        lgb, hist_mod, wdata, q8, "histogram_u16_i8", rounds=3, tag=qtag)
    check_predict(q, wdata, qaucs)
    check_rerun(lgb, hist_mod, wdata, q8, "histogram_u16_i8", q,
                "max_bin 1023 8-bit")
    by_path["histogram_u16_i8"] = {
        "phase16_higgs_max_bin_1023_8bit": qlaunch["histogram_u16_i8"]}
    del q
    q16p = dict(q8, quant_grad_bits=16)
    q16, q16launch, _, _, _ = train_full(
        lgb, hist_mod, wdata, q16p, "histogram_u16_i16", rounds=2,
        tag="phase 16 max_bin 1023 16-bit")
    check_rerun(lgb, hist_mod, wdata, q16p, "histogram_u16_i16", q16,
                "max_bin 1023 16-bit")
    by_path["histogram_u16_i16"] = {
        "phase16_higgs_max_bin_1023_16bit": q16launch["histogram_u16_i16"]}
    del q16
    sdata = small_datasets(lgb, extra)
    small = phase_small(lgb, hist_mod, extra, "histogram_u16_f32", None,
                        rounds=1, data=sdata)
    by_path["histogram_u16_f32"]["phase16_small_max_bin_1023"] = \
        small["histogram_u16_f32"]
    for p, kernel, tag in ((q8, "histogram_u16_i8", "8bit"),
                           (q16p, "histogram_u16_i16", "16bit")):
        small = phase_small(lgb, hist_mod, p, kernel, None, rounds=1,
                            data=sdata)
        by_path[kernel]["phase16_small_max_bin_1023_" + tag] = \
            small[kernel]
    del sdata
    if rows is not None:
        # the learner's bins repeated to the root shape of phase 4
        bins = bins.repeat(-(-FULL_ROWS // bins.shape[0]), 1)[
            :FULL_ROWS].contiguous()
        S = bins.shape[0]
        g = torch.Generator(device="cuda")
        g.manual_seed(16)
        gh = torch.stack([torch.randn(S, generator=g, device="cuda"),
                          torch.rand(S, generator=g, device="cuda"),
                          torch.ones(S, device="cuda"),
                          torch.ones(S, device="cuda")], dim=1).contiguous()
        gh8 = torch.randint(-127, 128, (S, 4), generator=g, device="cuda",
                            dtype=torch.int32).to(torch.int8)
        q = (2 ** 31 - 1) // S
        gh16 = torch.randint(-q, q + 1, (S, 4), generator=g, device="cuda",
                             dtype=torch.int32).to(torch.int16)
        errs["histogram_u16_f32"] = max(
            errs["histogram_u16_f32"], compare_f32(hist_mod, bins, gh, 1024,
                                                   None))
        errs["histogram_u16_f64"] = max(
            errs["histogram_u16_f64"],
            compare_f64(hist_mod, bins, gh, 1024, None)[0])
        compare_int(hist_mod, bins, gh8, 1024, None)
        compare_int(hist_mod, bins, gh16, 1024, None)
        rows.extend(time_instances(hist_mod, bins, 1024, gh, gh8, gh16,
                                   errs, "u16_"))
        del gh, gh8, gh16
    del bins
    return by_path, wdata


# ---------------------------------------------------------------------------
# phase 17: f64 histograms
# ---------------------------------------------------------------------------
def phase_f64(lgb, hist_mod, data, wdata):
    """f64 histogram sums (``tpu_use_f64_hist``) on phase 4's Dataset (3
    rounds, uint8 bins) and phase 16's (2 rounds, uint16 bins): every
    histogram through the f64 instance of the bins' dtype, held-out AUC
    > 0.7 and equal to the device scores'. Returns the launches by
    kernel and path."""
    f64 = {"tpu_use_f64_hist": True}
    bst, launches, aucs, _, _ = train_full(lgb, hist_mod, data, f64,
                                           "histogram_f64", rounds=3,
                                           tag="phase 17 f64 sums")
    a = check_predict(bst, data, aucs)
    by_path = {"histogram_f64": {
        "phase17_higgs_f64": launches["histogram_f64"]}}
    del bst
    out = {}
    if wdata is not None:
        wb, wl, waucs, _, _ = train_full(
            lgb, hist_mod, wdata, dict(f64, max_bin=WIDE_MAX_BIN),
            "histogram_u16_f64", rounds=2,
            tag="phase 17 f64 sums max_bin 1023")
        out["wide"] = check_predict(wb, wdata, waucs)
        by_path["histogram_u16_f64"] = {
            "phase17_higgs_max_bin_1023_f64": wl["histogram_u16_f64"]}
        del wb
    log("phase 17 f64 sums: held-out AUC %.6f after 3 rounds (uint8 bins)"
        "%s; ms per split %.3f against phase 4's f32 %s in this call"
        % (a, "; %.6f after 2 rounds at max_bin 1023" % out["wide"]
           if out else "", SPLIT_MS["phase 17 f64 sums"],
           "%.3f" % SPLIT_MS[PHASE4_TAG] if PHASE4_TAG in SPLIT_MS
           else "not run"))
    return by_path


def phase_f64_covertype(lgb, hist_mod):
    """Phase 9's Covertype rows bundled (EFB at its default) and
    unbundled, 2 rounds each with f64 histogram sums: the gap between
    their predictions against the reference's contract for bundles
    (rtol 1e-4; phase 9 logs the f32 gap). A finding: the run reports
    whether the f64 pair holds it and fails only on the launches.
    Returns the f64 launches by path."""
    t0 = time.perf_counter()
    X, y = make_covertype_like(COVERTYPE_ROWS + COVERTYPE_HELD_OUT, seed=9)
    Xt, yt = X[:COVERTYPE_ROWS], y[:COVERTYPE_ROWS]
    Xv, yv = X[COVERTYPE_ROWS:], y[COVERTYPE_ROWS:]
    params = {"objective": "multiclass", "num_class": 7, "num_leaves": 255,
              "learning_rate": 0.1, "max_bin": 255,
              "metric": "multi_logloss,multi_error", "verbosity": -1,
              "tpu_use_f64_hist": True}
    runs = {}
    for bundled in (True, False):
        p = dict(params, enable_bundle=bundled)
        ds, valid = covertype_splits(Xt, yt, Xv, yv, lgb, p)
        run = train_path(lgb, hist_mod, ds, valid, p, "histogram_f64", 2,
                         tag="phase 17 covertype f64 %s"
                         % ("bundled" if bundled else "unbundled"))
        check(run["booster"].inner.learner._bundled == bundled,
              "phase 17 covertype: enable_bundle=%s" % bundled)
        runs[bundled] = run
    b, u = runs[True]["booster"], runs[False]["booster"]
    p_b = b.predict(Xv, predict_on_device=False)
    p_u = u.predict(Xv, predict_on_device=False)
    same = sum(tree_structure(x) == tree_structure(z)
               for x, z in zip(b.inner.models, u.inner.models))
    gap = np.abs(p_b - p_u)
    within = bool(np.allclose(p_b, p_u, rtol=1e-4, atol=1e-5))
    log("phase 17 covertype bundled vs unbundled with f64 sums (2 rounds, "
        "%.1f s): %d of 14 trees structure-equal; predictions max |diff| "
        "%.3g, %.4f%% of values beyond rtol 1e-4 + atol 1e-5; the "
        "reference's bundle contract (rtol 1e-4) holds: %s; held-out "
        "multi_logloss round 2 %.6f vs %.6f"
        % (time.perf_counter() - t0, same, float(gap.max()),
           100.0 * float(np.mean(gap > 1e-5 + 1e-4 * np.abs(p_u))), within,
           runs[True]["evals"]["multi_logloss"][1],
           runs[False]["evals"]["multi_logloss"][1]))
    return {"phase17_covertype_f64_bundled":
            runs[True]["launches"]["histogram_f64"],
            "phase17_covertype_f64_unbundled":
            runs[False]["launches"]["histogram_f64"]}


# ---------------------------------------------------------------------------
# phase 18: DART, random forest and refit
# ---------------------------------------------------------------------------
def _record_drops():
    """Wrap DART's drop selection to keep every iteration's drop set.
    Returns (drops, restore)."""
    from lightgbm_tpu_torch.boosting.dart import DART
    select = DART._select_dropping_trees
    drops = []

    def recorded(self):
        select(self)
        drops.append(list(self.drop_index))
    DART._select_dropping_trees = recorded

    def restore():
        DART._select_dropping_trees = select
    return drops, restore


def phase_boosting(lgb, hist_mod, data):
    """DART (drop_rate 0.1, skip_drop 0, 5 rounds) and RF (bagging 0.632
    every round, feature_fraction 0.9, 5 rounds) on phase 4's Dataset
    through the whole-tree loop: launches == roots + steps, held-out AUC
    > 0.7 and equal to the device scores', stacked predict == host walk;
    ``average_output`` in the RF text; DART's drop sets (and tree
    weights) on the card equal those of a CPU run at 200k rows with the
    same seed (50k rows: the drops depend on the RNG and the tree
    weights only). The stacked checks run on 100k held-out rows. Returns
    the f32 launches by path."""
    import torch
    # skip_drop 0: at its default of 0.5 half the iterations drop
    # nothing, and 5 rounds at drop_rate 0.1 would likely drop no tree
    dart = {"boosting": "dart", "drop_rate": 0.1, "skip_drop": 0.0}
    drops, restore = _record_drops()
    try:
        bst, launches, aucs, _, _ = train_full(
            lgb, hist_mod, data, dart, "histogram_f32",
            tag="phase 18 dart")
        card = (list(drops), list(bst.inner.tree_weight))
        drops.clear()
        # the drops come from the host RNG and the tree weights: any rows
        # that grow a tree each iteration draw them the same
        X, y = make_higgs_like(50_000, seed=7)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            cpu = lgb.train(dict(SLICE_PARAMS, num_leaves=63,
                                 device_type="cpu", **dart),
                            lgb.Dataset(X, label=y), num_boost_round=5)
        finally:
            torch.set_num_threads(threads)
        host = (list(drops), list(cpu.inner.tree_weight))
    finally:
        restore()
    check(card == host, "DART drop sets or tree weights differ between "
          "cuda (%s) and cpu (%s)" % (card, host))
    check(any(card[0]), "DART dropped no tree in 5 rounds")
    a = check_predict(bst, data, aucs)
    check_stacked(bst, data[2][:100_000], "phase 18 dart")
    log("phase 18 DART: drop sets per iteration %s, tree weights %s, the "
        "same on cuda and cpu; held-out AUC %.6f"
        % (card[0], " ".join("%.6f" % w for w in card[1]), a))
    by_path = {"phase18_higgs_dart": launches["histogram_f32"]}
    del bst, cpu
    rf = {"boosting": "rf", "bagging_fraction": 0.632, "bagging_freq": 1,
          "feature_fraction": 0.9}
    bst, launches, aucs, _, _ = train_full(lgb, hist_mod, data, rf,
                                           "histogram_f32",
                                           tag="phase 18 rf")
    text = bst.model_to_string()
    check("\naverage_output\n" in text and bst.inner.average_output,
          "the RF model text has no average_output line")
    a = check_predict(bst, data, aucs)
    check_stacked(bst, data[2][:100_000], "phase 18 rf")
    again = lgb.Booster(model_str=text)
    check(np.array_equal(again.predict(data[2][:100_000]),
                         bst.predict(data[2][:100_000],
                                     predict_on_device=False)),
          "the RF text round trip predicts other values")
    log("phase 18 RF: average_output in the text, the text round trip "
        "and the stacked path equal the host walk; held-out AUC %.6f" % a)
    by_path["phase18_higgs_rf"] = launches["histogram_f32"]
    return by_path


def phase_refit(lgb):
    """``Booster.refit`` of phase 12's model (255 leaves; its first
    REFIT_ITERATIONS trees, which keeps the CPU refit short; as many
    trees trained at 200k rows when phase 12 did not run) on 200k fresh
    rows, on the card and on the CPU from the same model text: every
    leaf value within 1e-5 absolute (f32 per-leaf sums in another order
    on each device), the refit model's stacked predict == host walk on
    the card."""
    import torch
    model = PHASE12.get("model")
    if model is None:
        X, y = make_higgs_like(SMALL_ROWS, seed=7)
        model = lgb.train(dict(SLICE_PARAMS, num_leaves=255),
                          lgb.Dataset(X, label=y),
                          num_boost_round=REFIT_ITERATIONS).model_to_string()
    Xr, yr = make_higgs_like(SMALL_ROWS, seed=11)
    card = lgb.Booster(model_str=model)
    cpu = lgb.Booster(model_str=model, params={"device_type": "cpu"})
    before = [t.leaf_value[:t.num_leaves].copy() for t in card.inner.models]
    _, t_card = timed(lambda: card.refit(Xr, yr))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t0 = time.perf_counter()
        cpu.refit(Xr, yr)
        t_cpu = time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
    gap, moved = 0.0, 0
    for a, b, old in zip(card.inner.models, cpu.inner.models, before):
        va, vb = a.leaf_value[:a.num_leaves], b.leaf_value[:b.num_leaves]
        gap = max(gap, float(np.abs(va - vb).max()))
        moved += int(np.sum(va != old))
    check(gap <= 1e-5, "refit leaf values differ between cuda and cpu by "
          "%.3g" % gap)
    check(moved > 0, "refit changed no leaf value")
    check_stacked(card, Xr[:65_536], "phase 18 refit")
    log("phase 18 refit of a %d-tree model on %d rows: %.3f s on the card "
        "(one stacked leaf walk, per-leaf f32 sums), %.3f s on the cpu; "
        "%d leaf values changed; leaf values cuda vs cpu max |diff| %.3g "
        "(tol 1e-5)" % (len(card.inner.models), SMALL_ROWS, t_card, t_cpu,
                        moved, gap))


# ---------------------------------------------------------------------------
# phase 19: batched iterations, the sklearn estimator, cv and SHAP
# ---------------------------------------------------------------------------
#: phase 19's batch: iteration 0 looped, then one batch of 4 (5 rounds)
BATCH = 4
#: the LGBMClassifier defaults of phase 19c under LightGBM's own names
SKLEARN_MAPPED = {"objective": "binary", "boosting": "gbdt",
                  "num_leaves": 255, "max_depth": -1, "learning_rate": 0.1,
                  "subsample_for_bin": 200000, "min_split_gain": 0.0,
                  "min_child_weight": 1e-3, "min_child_samples": 100,
                  "subsample": 1.0, "subsample_freq": 0,
                  "colsample_bytree": 1.0, "reg_alpha": 0.0,
                  "reg_lambda": 0.0, "verbosity": -1}


def batched_contract(t1, t2, what: str, i: int, values: bool) -> bool:
    """The reference's batched contract (tests/test_batched_training.py:
    structure and leaf counts exact; with ``values``, leaf values within
    rtol 1e-5 and gains within rtol 1e-6 / atol 1e-4). Returns whether
    the two trees' text is equal too."""
    ni = t1.num_internal
    check(t1.num_leaves == t2.num_leaves
          and all(np.array_equal(getattr(t1, f)[:ni], getattr(t2, f)[:ni])
                  for f in ("split_feature", "threshold_in_bin",
                            "decision_type", "left_child", "right_child"))
          and np.array_equal(t1.leaf_count[:t1.num_leaves],
                             t2.leaf_count[:t2.num_leaves]),
          "%s: tree %d is not the looped run's tree" % (what, i))
    if values:
        check(np.allclose(t1.leaf_value[:t1.num_leaves],
                          t2.leaf_value[:t2.num_leaves], rtol=1e-5,
                          atol=1e-7)
              and np.allclose(t1.split_gain[:ni], t2.split_gain[:ni],
                              rtol=1e-6, atol=1e-4),
              "%s: tree %d's values are outside the batched tolerance"
              % (what, i))
    return t1.to_string() == t2.to_string()


def batch_turns(lgb, ds, params):
    """Seconds of 4 iterations looped (``Booster.update``, no
    evaluation) and of one batch of 4 (``train_batch``), on two boosters
    of phase 4's Dataset after their iteration 0, in turns looped,
    batched, batched, looped (one call, one card)."""
    import torch
    boosters = [lgb.Booster(params=params, train_set=ds) for _ in range(2)]
    for b in boosters:
        b.update()

    def looped():
        for _ in range(BATCH):
            boosters[0].update()
    out = {"looped": [], "batched": []}
    for name, fn in (("looped", looped),
                     ("batched", lambda: boosters[1].inner.train_batch(BATCH)),
                     ("batched", lambda: boosters[1].inner.train_batch(BATCH)),
                     ("looped", looped)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[name].append(time.perf_counter() - t)
    check([b.current_iteration for b in boosters] == [1 + 2 * BATCH] * 2,
          "batch turns: %s iterations" % [b.current_iteration
                                          for b in boosters])
    return out


def phase19_batched(lgb, hist_mod, data, looped, extra, kernel, what):
    """19a / 19b: phase 4's Dataset, 5 rounds at ``tpu_batch_iterations``
    4 with ``tpu_eval_iterations`` 4 (one evaluation, at the end): every
    histogram through ``kernel`` (launches == roots + steps), one record
    read for the batch and no step-counter read in it, the trees of the
    looped run (phase 4 or 7) under the batched contract, the held-out
    AUC the looped run's last; s per batch against the looped run's 4
    iterations, host syncs per batch (sync debug mode); in f32 also
    :func:`batch_turns`. Returns the launches and the booster."""
    import torch
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    ds, valid, _, _ = data
    ref_trees, ref_aucs, ref_per_iter = looped
    params = dict(SLICE_PARAMS, num_leaves=255, tpu_batch_iterations=BATCH,
                  tpu_eval_iterations=BATCH, **extra)
    real = GBDT.train_batch
    batches = []

    def timed_batch(self, n):
        before = dict(self.learner.grow_stats)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = real(self, n)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        after = self.learner.grow_stats
        batches.append(dict(
            seconds=time.perf_counter() - t, iters=n,
            syncs=sum("synchroniz" in str(w.message) for w in caught),
            **{k: after[k] - before[k] for k in ("record_reads",
                                                 "flag_reads", "roots")}))
        return out
    seen = []

    def cb(env):
        seen.append(env.iteration)
    evals = {}
    GBDT.train_batch = timed_batch
    hist_mod.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        bst = lgb.train(params, ds, num_boost_round=1 + BATCH,
                        valid_sets=[valid], valid_names=["held_out"],
                        callbacks=[cb, lgb.record_evaluation(evals)])
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
    finally:
        GBDT.train_batch = real
    trees = bst.inner.models
    check(len(trees) == 1 + BATCH, "%s: %d trees" % (what, len(trees)))
    launches = check_device_launches(hist_mod, bst, kernel, what)
    check(len(batches) == 1 and batches[0]["record_reads"] == 1
          and batches[0]["flag_reads"] == 0
          and batches[0]["roots"] == BATCH,
          "%s: the batch did not run as one record read with no counter "
          "read: %s" % (what, batches))
    check(seen == [BATCH], "%s: callbacks at %s, not once at the end "
          "(eval grid %d)" % (what, seen, BATCH))
    a = evals["held_out"]["auc"]
    check(len(a) == 1 and a[0] > 0.7 and abs(a[0] - ref_aucs[-1]) < 1e-4,
          "%s: held-out AUC %s against the looped run's %.6f"
          % (what, a, ref_aucs[-1]))
    exact = [batched_contract(t, r, what, i, values=kernel == "histogram_f32")
             for i, (t, r) in enumerate(zip(trees, ref_trees))]
    b = batches[0]
    looped_s = sum(ref_per_iter[1:1 + BATCH])
    log("%s: %d rounds (iteration 0 looped, 1 batch of %d) in %.3f s; "
        "batch %.3f s (%.3f s an iteration) against the looped run's "
        "iterations 1-%d %.3f s (trees + gradients + held-out eval each); "
        "host syncs in the batch %d (sync debug mode), record reads %d, "
        "counter reads %d; callbacks at %s; held-out AUC %.6f (looped "
        "%.6f); trees under the batched contract, text-equal to the looped "
        "run's: %s"
        % (what, 1 + BATCH, BATCH, t_train, b["seconds"],
           b["seconds"] / BATCH, BATCH, looped_s, b["syncs"],
           b["record_reads"], b["flag_reads"], seen, a[0], ref_aucs[-1],
           exact))
    if kernel == "histogram_f32":
        turns = batch_turns(lgb, ds, dict(SLICE_PARAMS, num_leaves=255))
        log("%s in turns (looped, batched, batched, looped), %d "
            "iterations each with no evaluation: looped %s s, batched %s s"
            % (what, BATCH, " / ".join("%.3f" % v for v in turns["looped"]),
               " / ".join("%.3f" % v for v in turns["batched"])))
    return launches[kernel], bst


def phase19_sklearn(lgb, hist_mod, data):
    """19c: ``LGBMClassifier`` (5 estimators, 255 leaves,
    min_child_samples 100) on the first LINEAR_ROWS training rows:
    launches == roots + steps, the model text of ``lgb.train`` with the
    mapped parameters, ``predict_proba`` of the 500k held-out rows
    through the stacked path with AUC > 0.7. Returns the launches, the
    estimator and the train Dataset (19d reuses it)."""
    import torch
    _, _, Xv, yv = data
    X, y = HEAD["X"], HEAD["y"]
    out = {}
    hist_mod.reset_launch_counts()
    t0 = time.perf_counter()
    est = lgb.LGBMClassifier(n_estimators=5, num_leaves=255,
                             min_child_samples=100).fit(X, y)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    out["phase19c_sklearn_classifier"] = check_device_launches(
        hist_mod, est.booster_, "histogram_f32", "19c LGBMClassifier.fit")[
            "histogram_f32"]
    ds = lgb.Dataset(X, label=y)
    hist_mod.reset_launch_counts()
    bst = lgb.train(SKLEARN_MAPPED, ds, num_boost_round=5)
    out["phase19c_train_mapped_params"] = check_device_launches(
        hist_mod, bst, "histogram_f32", "19c lgb.train")["histogram_f32"]
    check(est.booster_.model_to_string() == bst.model_to_string(),
          "19c: the classifier's model text is not lgb.train's with the "
          "mapped parameters")
    t0 = time.perf_counter()
    proba = est.predict_proba(Xv)
    t_pred = time.perf_counter() - t0
    cache = getattr(est.booster_, "_stacked_cache", None)
    check(cache is not None and cache[1] is not None,
          "19c: predict_proba did not take the stacked path")
    check(proba.shape == (len(yv), 2) and bool(np.isfinite(proba).all())
          and bool(np.allclose(proba.sum(axis=1), 1.0)),
          "19c: predict_proba is not [n, 2] finite probabilities")
    a = auc(yv, proba[:, 1])
    check(a > 0.7, "19c: held-out AUC %.4f <= 0.7" % a)
    log("19c LGBMClassifier(n_estimators=5, num_leaves=255, "
        "min_child_samples=100) on %d rows: fit %.3f s (binning included); "
        "model text == lgb.train's with the mapped parameters; "
        "predict_proba of %d held-out rows through the stacked path in "
        "%.3f s, AUC %.6f" % (len(y), t_fit, len(yv), t_pred, a))
    del bst
    return out, est, ds


def phase19_cv(lgb, hist_mod, ds):
    """19d: ``lgb.cv`` with 3 stratified folds and 3 rounds on 19c's
    Dataset: every fold's roots == its trees and steps >= its splits,
    the device launches == the folds' roots + steps, only the f32
    instance, and fold 0's booster text-equal to ``lgb.train`` on its
    subset. Returns the launches."""
    from lightgbm_tpu_torch.engine import _make_n_folds
    params = dict(SKLEARN_MAPPED, metric="auc")
    hist_mod.reset_launch_counts()
    t0 = time.perf_counter()
    res = lgb.cv(params, ds, num_boost_round=3, nfold=3,
                 return_cvbooster=True)
    t_cv = time.perf_counter() - t0
    dev = hist_mod.device_launch_counts()
    boosters = res["cvbooster"].boosters
    total = 0
    for i, b in enumerate(boosters):
        stats = b.inner.learner.grow_stats
        trees = b.inner.models
        check(stats["roots"] == len(trees) == 3
              and stats["steps"] >= sum(t.num_leaves - 1 for t in trees),
              "19d fold %d: roots %d, steps %d for %d trees"
              % (i, stats["roots"], stats["steps"], len(trees)))
        total += stats["roots"] + stats["steps"]
    check(len(boosters) == 3 and dev["histogram_f32"] == total
          and sum(dev.values()) == total,
          "19d: device launches %s, the folds' roots + steps %d"
          % (dev, total))
    train_idx, _ = _make_n_folds(ds, None, 3, params, 0, True, True)[0]
    alone = lgb.train(params, ds.subset(train_idx), num_boost_round=3)
    check(alone.model_to_string() == boosters[0].model_to_string(),
          "19d: fold 0 is not lgb.train on its subset")
    means = res["valid auc-mean"]
    check(len(means) == 3 and means[-1] > 0.7,
          "19d: cv AUC means %s" % means)
    log("19d lgb.cv (3 folds x 3 rounds on %d rows): %.3f s; valid "
        "auc-mean %s, stdv %s; %d launches of histogram_f32 == the folds' "
        "roots + steps; fold 0 text-equal to lgb.train on its %d rows"
        % (ds.num_data(), t_cv, " ".join("%.6f" % v for v in means),
           " ".join("%.6f" % v for v in res["valid auc-stdv"]), total,
           len(train_idx)))
    return {"phase19d_cv_3_folds": total}


def phase19_contrib(est, data, rows: int = 16):
    """19e: SHAP values of 19c's model for ``rows`` held-out rows: each
    row sums to its raw score within 1e-6 x the scores' scale."""
    Xv = data[2][:rows]
    t0 = time.perf_counter()
    contrib = est.predict(Xv, pred_contrib=True)
    ms = 1e3 * (time.perf_counter() - t0)
    raw = est.booster_.predict(Xv, raw_score=True, predict_on_device=False)
    scale = max(float(np.abs(raw).max()), 1.0)
    gap = float(np.abs(contrib.sum(axis=1) - raw).max())
    check(contrib.shape == (rows, Xv.shape[1] + 1)
          and gap <= 1e-6 * scale,
          "19e: SHAP row sums differ from the raw scores by %.3g" % gap)
    log("19e pred_contrib of %d rows x %d trees (255 leaves): %.1f ms on "
        "the host; row sums vs raw scores max |diff| %.3g (scale %.3f)"
        % (rows, est.booster_.num_trees(), ms, gap, scale))


def phase_surface(lgb, hist_mod, data, looped):
    """Phase 19: batched iterations in f32 (19a) and 8-bit (19b) against
    phases 4 and 7, then the classifier (19c), cv (19d) and SHAP (19e).
    Returns the launches by kernel and path."""
    out = {"histogram_f32": {}, "histogram_i8": {}}
    n, _ = phase19_batched(lgb, hist_mod, data, looped["f32"], {},
                           "histogram_f32", "19a batched f32")
    out["histogram_f32"]["phase19a_higgs_batched"] = n
    n, bst = phase19_batched(
        lgb, hist_mod, data, looped["8bit"],
        {"use_quantized_grad": True, "quant_grad_bits": 8},
        "histogram_i8", "19b batched 8-bit")
    out["histogram_i8"]["phase19b_higgs_batched_8bit"] = n
    scale = max(float(bst.inner.train_score.abs().max()), 1.0)
    dev = bst.inner.recheck_scores(reason="phase 19b")
    check(dev <= 1e-3 * scale, "19b: the replay of the trees differs "
          "from the maintained score by %.3g" % dev)
    log("19b recheck: a replay of the %d trees over the training rows "
        "against the batch-maintained score: max |diff| %.3g (scale "
        "%.3f)" % (len(bst.inner.models), dev, scale))
    del bst
    paths, est, ds = phase19_sklearn(lgb, hist_mod, data)
    out["histogram_f32"].update(paths)
    out["histogram_f32"].update(phase19_cv(lgb, hist_mod, ds))
    phase19_contrib(est, data)
    return out


# ---------------------------------------------------------------------------
# phase 20: observability and checkpoints on the card
# ---------------------------------------------------------------------------
#: the stages whose outputs the port watches (``obs.watch_ready``)
WATCHED = ("gbdt::gradients", "tree::stage_gh", "tree::root_histogram",
           "gbdt::score_update")


def log_stage_table(registry, what):
    """The registry's stage table, longest first: seconds, calls, p50
    and p99 ms per call."""
    table = registry.phases()
    log("%s: per-stage table (s, calls, p50 ms, p99 ms): %s"
        % (what, "; ".join(
            "%s %.6f %d %s %s" % (k, v["seconds"], v["calls"],
                                  v.get("p50_ms"), v.get("p99_ms"))
            for k, v in sorted(table.items(),
                               key=lambda kv: -kv[1]["seconds"]))))
    return table


def phase20_sample(lgb, hist_mod, data, tmp):
    """20a: sample mode with the span trace and the event log on, f32,
    3 rounds (the stage names, the readiness lane, the events, the host
    syncs, and the registry's launch counts against the device's)."""
    from lightgbm_tpu_torch.obs import events, trace
    from lightgbm_tpu_torch.obs.registry import registry
    ds, valid, _, _ = data
    trace_path = os.path.join(tmp, "trace.json")
    log_path = os.path.join(tmp, "events.jsonl")
    registry.reset()
    registry.enable(sampling=True)
    trace.configure(trace_path)
    events.configure(log_path)
    try:
        run = train_path(lgb, hist_mod, ds, valid,
                         dict(SLICE_PARAMS, num_leaves=255),
                         "histogram_f32", 3,
                         tag="phase 20a sample mode f32, traced")
        drained = registry.drain_ready(timeout=60)
        dev = hist_mod.device_launch_counts()
        snap = registry.snapshot()
        table = log_stage_table(registry, "20a sample mode")
        trace.flush()
        events.flush()
    finally:
        trace.configure(None)
        events.configure(None)
        registry.disable()
        registry.timer.sampling = False
    check(drained, "20a: the readiness drainer did not empty in 60 s")
    with open(trace_path) as f:
        doc = json.load(f)
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    names = {e["name"] for e in spans}
    for stage in ("tree::grow", "gbdt::gradients", "gbdt::score_update",
                  "gbdt::eval_metrics"):
        check(stage in names, "20a: no %s span in the trace" % stage)
    by_id = {e["args"].get("span_id"): e for e in spans}
    ready = {}
    for stage in WATCHED:
        lane = [e for e in spans if e["name"] == stage + "::ready"]
        ready[stage] = len(lane)
        check(lane and all(
            by_id.get(e["args"].get("parent_span_id"), {}).get("name")
            == stage for e in lane),
            "20a: %s has no readiness span parented to it" % stage)
    recs = events.read_jsonl(log_path)
    iters = [r for r in recs if r["event"] == "train_iter"]
    check(len(iters) == 3, "20a: %d train_iter events for 3 rounds"
          % len(iters))
    bst = run["booster"]
    stats = bst.inner.learner.grow_stats
    k1 = "histogram_f32"
    want = stats["roots"] + stats["steps"]
    gauge = snap["gauges"].get("kernel/device_launches/" + k1)
    host = snap["counters"].get("kernel/launches/" + k1, 0)
    check(gauge == dev[k1] == want,
          "20a: registry launch gauge %s, device counter %d, roots + "
          "steps %d" % (gauge, dev[k1], want))
    # the host counts where Python launched: roots, eager steps and the
    # capture (recorded, not run); the card runs the replays instead
    check(host - stats["captures"] + stats["replays"] == want,
          "20a: registry host launches %d - captures %d + replays %d != "
          "roots + steps %d" % (host, stats["captures"], stats["replays"],
                                want))
    phase4 = TREE_SYNCS.get(PHASE4_TAG)
    if phase4:
        check(max(run["tree_syncs"]) <= max(phase4),
              "20a: %d host syncs in a tree under sample mode, phase 4's "
              "most %d" % (max(run["tree_syncs"]), max(phase4)))
    log("20a sample mode, f32, 3 rounds: trace %d spans (%d bytes), %d "
        "events (%s); readiness spans per watched stage %s; host syncs "
        "per tree %s (phase 4: %s); K1 launches: registry gauge %s == "
        "device %d == roots %d + steps %d; registry host count %d - "
        "captures %d + replays %d; ::ready seconds %s"
        % (len(spans), os.path.getsize(trace_path), len(recs),
           sorted({r["event"] for r in recs}), ready, run["tree_syncs"],
           phase4, gauge, dev[k1], stats["roots"], stats["steps"], host,
           stats["captures"], stats["replays"],
           {k: table[k + "::ready"]["seconds"]
                              for k in WATCHED}))
    return run["launches"][k1]


def phase20_fenced(lgb, hist_mod, data):
    """20b: fencing mode, 8-bit, 2 rounds: every watched stage
    synchronizes its stream, so the stage table holds the port's
    per-stage device times; two fences a tree inside the learner."""
    from lightgbm_tpu_torch.obs.registry import registry
    ds, valid, _, _ = data
    registry.reset()
    registry.enable(sampling=False)
    registry.fences = True
    try:
        check(registry.fence(), "20b: fencing mode is not on")
        run = train_path(lgb, hist_mod, ds, valid,
                         dict(SLICE_PARAMS, num_leaves=255,
                              use_quantized_grad=True, quant_grad_bits=8),
                         "histogram_i8", 2,
                         tag="phase 20b fencing mode 8-bit",
                         extra_syncs=2)
        log_stage_table(registry, "20b fencing mode, 8-bit, 2 rounds")
    finally:
        registry.fences = False
        registry.disable()
    return run["launches"]["histogram_i8"]


def _resumed_pair(lgb, hist_mod, ds, params, d, kernel, rounds=4):
    """``rounds`` rounds with a checkpoint every 2, then a run resumed
    from the first checkpoint (the later ones removed) to the same
    rounds. Returns both boosters and the device launches of the two
    runs, which must all be launches of ``kernel``: the roots + steps
    of both learners."""
    import shutil
    hist_mod.reset_launch_counts()
    t0 = time.perf_counter()
    first = lgb.train(params, ds, num_boost_round=rounds,
                      checkpoint_dir=d, checkpoint_freq=2)
    t_first = time.perf_counter() - t0
    names = sorted(os.listdir(d))
    check(names == ["ckpt-%08d" % i for i in range(2, rounds + 1, 2)],
          "checkpoints written: %s" % names)
    for name in names[1:]:
        shutil.rmtree(os.path.join(d, name))
    t0 = time.perf_counter()
    again = lgb.train(params, ds, num_boost_round=rounds,
                      checkpoint_dir=d, checkpoint_freq=2, resume=True)
    t_again = time.perf_counter() - t0
    dev = hist_mod.device_launch_counts()
    s1, s2 = first.inner.learner.grow_stats, again.inner.learner.grow_stats
    want = s1["roots"] + s1["steps"] + s2["roots"] + s2["steps"]
    check(dev[kernel] == want and sum(dev.values()) == dev[kernel],
          "resume %s: device launches %s, roots + steps of both runs %d"
          % (kernel, dev, want))
    check(s2["roots"] == rounds - 2 and s2["captures"] == 1,
          "resume: the resumed run grew %d trees with %d captures"
          % (s2["roots"], s2["captures"]))
    return first, again, dev[kernel], t_first, t_again


def phase20_resume(lgb, hist_mod, data, looped, tmp):
    """20c: resume on the card, text-equal to the uninterrupted trees."""
    import torch
    ds = data[0]
    launches = {"histogram_f32": {}, "histogram_i8": {}}
    first, again, n, t1, t2 = _resumed_pair(
        lgb, hist_mod, ds, dict(SLICE_PARAMS, num_leaves=255),
        os.path.join(tmp, "ck_f32"), "histogram_f32")
    texts = [t.to_string() for t in again.inner.models]
    check(texts == [t.to_string() for t in first.inner.models],
          "20c f32: the resumed trees differ from the uninterrupted run's")
    check(bool((again.inner.train_score.view(torch.int32)
                == first.inner.train_score.view(torch.int32)).all()),
          "20c f32: resumed training score bits differ")
    if "f32" in looped:
        check(texts == [t.to_string() for t in looped["f32"][0][:4]],
              "20c f32: the resumed trees differ from phase 4's first 4")
    launches["histogram_f32"]["phase20c_resume_f32"] = n
    log("20c resume, f32 at %d rows: 4 rounds with checkpoints at 2 and 4 "
        "in %.3f s, resumed from the first to 4 in %.3f s; trees "
        "text-equal to the uninterrupted run's%s, score bits equal; %d "
        "launches of histogram_f32"
        % (FULL_ROWS, t1, t2, " and phase 4's" if "f32" in looped else "",
           n))
    del first, again
    X, y = make_higgs_like(SMALL_ROWS, seed=7)
    small = lgb.Dataset(X, label=y).construct()
    for tag, extra, kernel in (
            ("8-bit, bagging", {"use_quantized_grad": True,
                                "quant_grad_bits": 8,
                                "bagging_fraction": 0.7,
                                "bagging_freq": 1}, "histogram_i8"),
            ("DART", {"boosting": "dart", "drop_rate": 0.3,
                      "skip_drop": 0.0}, "histogram_f32")):
        first, again, n, t1, t2 = _resumed_pair(
            lgb, hist_mod, small, dict(SLICE_PARAMS, num_leaves=63, **extra),
            os.path.join(tmp, "ck_" + kernel + tag[:4]), kernel)
        check([t.to_string() for t in again.inner.models]
              == [t.to_string() for t in first.inner.models],
              "20c %s: the resumed trees differ" % tag)
        check(bool((again.inner.train_score.view(torch.int32)
                    == first.inner.train_score.view(torch.int32)).all()),
              "20c %s: resumed training score bits differ" % tag)
        key = "phase20c_resume_" + ("8bit_bagging" if kernel ==
                                    "histogram_i8" else "dart")
        launches[kernel][key] = n
        log("20c resume, %s at %d rows, 63 leaves: resumed from the "
            "2-round checkpoint to 4 (%.3f s; the run %.3f s): text and "
            "score bits equal; %d launches of %s"
            % (tag, SMALL_ROWS, t2, t1, n, kernel))
    return launches


def phase_observability(lgb, hist_mod, data, looped):
    """Phase 20; returns the launches by kernel and path."""
    import tempfile
    out = {"histogram_f32": {}, "histogram_i8": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke20-") as tmp:
        t0 = time.perf_counter()
        out["histogram_f32"]["phase20a_sample_mode_f32"] = \
            phase20_sample(lgb, hist_mod, data, tmp)
        t1 = time.perf_counter()
        out["histogram_i8"]["phase20b_fencing_8bit"] = \
            phase20_fenced(lgb, hist_mod, data)
        t2 = time.perf_counter()
        for kernel, paths in phase20_resume(lgb, hist_mod, data, looped,
                                            tmp).items():
            out[kernel].update(paths)
        log("phase 20 seconds: 20a %.1f, 20b %.1f, 20c %.1f"
            % (t1 - t0, t2 - t1, time.perf_counter() - t2))
    return out


# ---------------------------------------------------------------------------
# phase 21: the serving plane (PredictServer, replicas, registry)
# ---------------------------------------------------------------------------
#: seconds of closed-loop traffic per replica count
SERVE_WINDOW_S = 5.0
#: client threads of the traffic window, and every how many requests one
#: is a 1000-row block (split across dispatches by max_batch 256)
SERVE_CLIENTS = 16
SERVE_BLOCK_EVERY = 25
SERVE_BLOCK_ROWS = 1000


def serve_window(srv, X, want, seconds):
    """``SERVE_CLIENTS`` threads submit closed-loop (each waits for its
    answer) for ``seconds``: single rows, every ``SERVE_BLOCK_EVERY``-th
    request a ``SERVE_BLOCK_ROWS``-row block. Every answer must be
    byte-equal to ``want`` of its rows. Returns (requests, rows, wall
    seconds, client latencies in ms)."""
    import threading
    n = X.shape[0]
    stop = time.perf_counter() + seconds
    lat, counts, bad = [], [0, 0], []
    lock = threading.Lock()

    def client(t):
        rng = np.random.RandomState(100 + t)
        k = 0
        while time.perf_counter() < stop:
            k += 1
            m = SERVE_BLOCK_ROWS if k % SERVE_BLOCK_EVERY == 0 else 1
            lo = int(rng.randint(0, n - m))
            t0 = time.perf_counter()
            got = srv.submit(X[lo] if m == 1 else X[lo:lo + m]).result(
                timeout=120)
            dt = (time.perf_counter() - t0) * 1e3
            ok = np.array_equal(np.atleast_1d(got), want[lo:lo + m])
            with lock:
                lat.append(dt)
                counts[0] += 1
                counts[1] += m
                if not ok:
                    bad.append((lo, m))

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=seconds + 120)
        check(not th.is_alive(), "phase 21: a client thread hung")
    wall = time.perf_counter() - t0
    check(not bad, "phase 21: %d answers differ from the stacked predict "
          "(first rows %s)" % (len(bad), bad[:3]))
    return counts[0], counts[1], wall, lat


def outcome(fut, timeout=120):
    try:
        return "ok", fut.result(timeout=timeout)
    except Exception as e:  # noqa: BLE001 — the type is the outcome
        return type(e).__name__, None


def phase_serving(lgb):
    """Phase 21: phase 12's model (binary, 255 leaves, 40 rounds, 28
    features) behind ``PredictServer`` (max_batch 256, max_wait_ms 2) on
    the card, with 1 and then 2 replicas (two dispatch workers on the one
    card, each on its own CUDA stream): closed-loop traffic from 16
    client threads for ``SERVE_WINDOW_S`` each, every answer byte-equal
    to ``StackedForest.predict`` of its rows, fewer dispatches than
    requests; p50 / p99 latency and rows/s per replica count, and the
    OpenMetrics text with ``replica="0"`` and ``replica="1"`` series.
    Then an overload burst against ``max_queue_rows=1024`` (shed typed,
    no Future left pending), injected ``serve_dispatch`` faults opening
    the breaker and a clean half-open probe closing it, a canary
    (``canary_batches=4``) rolled back by an injected fault while the old
    version serves byte-equal, and ``stop(drain_timeout_s=0.05)`` over a
    waiting queue resolving or failing every Future."""
    import threading
    from lightgbm_tpu_torch.obs import faults
    from lightgbm_tpu_torch.obs.export import render_openmetrics
    from lightgbm_tpu_torch.obs.registry import registry
    from lightgbm_tpu_torch.serve import (ModelRegistry, PredictServer,
                                          StackedForest)
    bst = lgb.Booster(model_str=PHASE12["model_full"],
                      params={"device_type": "cuda"})
    forest = StackedForest.from_gbdt(bst)
    X, _ = make_higgs_like(1 << 16, seed=21)
    want = forest.place("cuda").predict(X)
    summary = {}
    for replicas in (1, 2):
        name = "phase21_replicas_%d" % replicas
        srv = PredictServer(forest, name=name, max_batch=256, max_wait_ms=2,
                            replicas=replicas, devices=["cuda"])
        check(srv.replicas == replicas
              and all(d.type == "cuda" for d in srv._devices),
              "phase 21: %d replicas on %s" % (srv.replicas, srv._devices))
        srv.warm(X[:256])
        srv.warm(X[:1])
        d0 = dict(srv.stats)
        n_req, n_rows, wall, lat = serve_window(srv, X, want,
                                                SERVE_WINDOW_S)
        stats = {k: srv.stats[k] - d0[k] for k in srv.stats}
        reps = srv.replica_stats()
        text = render_openmetrics(registry)
        srv.stop()
        check(stats["requests"] == n_req and stats["rows"] == n_rows,
              "phase 21: the server counted %d requests / %d rows, the "
              "clients %d / %d" % (stats["requests"], stats["rows"], n_req,
                                   n_rows))
        check(0 < stats["dispatches"] < n_req,
              "phase 21: %d dispatches for %d requests (no coalescing)"
              % (stats["dispatches"], n_req))
        if replicas == 2:
            for k in (0, 1):
                check('replica="%d"' % k in text and reps[k]["dispatches"]
                      > 0, "phase 21: no replica=%d series (dispatches %s)"
                      % (k, {r: v["dispatches"] for r, v in reps.items()}))
        p50, p99 = np.percentile(lat, [50, 99])
        summary[replicas] = n_rows / wall
        log("phase 21 serving, %d replica(s) on one card, %d clients, "
            "%.1f s: %d requests (%d rows; every %d-th a %d-row block) in "
            "%d dispatches, all byte-equal to StackedForest.predict; "
            "client latency p50 %.3f ms p99 %.3f ms; %.0f rows/s, %.0f "
            "requests/s; per replica %s"
            % (replicas, SERVE_CLIENTS, wall, n_req, n_rows,
               SERVE_BLOCK_EVERY, SERVE_BLOCK_ROWS, stats["dispatches"],
               p50, p99, n_rows / wall, n_req / wall,
               json.dumps({k: {"dispatches": v["dispatches"],
                               "rows": v["rows"],
                               "p50_ms": round(v["p50_ms"], 3),
                               "p99_ms": round(v["p99_ms"], 3)}
                           for k, v in reps.items()})))
    log("phase 21: 2 replicas on one card against 1: %.3f x the rows/s"
        % (summary[2] / summary[1]))

    # overload: a burst of 4096 rows from 4 threads against
    # max_queue_rows 1024, the workers started after it (so the queue's
    # bound, not the dispatch rate, decides: 1024 admitted, 3072 shed)
    srv = PredictServer(forest, name="phase21_overload", max_batch=256,
                        max_wait_ms=20, max_queue_rows=1024,
                        devices=["cuda"], autostart=False)
    srv.warm(X[:256])
    futs = [[] for _ in range(4)]

    def burst(t):
        for i in range(1024):
            futs[t].append((i, srv.submit(X[(t * 1024 + i) % len(X)])))

    threads = [threading.Thread(target=burst, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    srv.start()
    kinds = {}
    for t in range(4):
        for i, f in futs[t]:
            kind, val = outcome(f)
            kinds[kind] = kinds.get(kind, 0) + 1
            if kind == "ok":
                check(val == want[(t * 1024 + i) % len(X)],
                      "phase 21 overload: a served answer differs")
    srv.stop()
    check(kinds == {"ok": 1024, "Overloaded": 3072},
          "phase 21 overload: outcomes %s" % kinds)
    log("phase 21 overload burst (4 x 1024 single rows, max_queue_rows "
        "1024): %s; every Future resolved" % json.dumps(kinds))

    # the breaker: injected dispatch faults open it, a probe closes it
    srv = PredictServer(forest, name="phase21_breaker", max_batch=256,
                        max_wait_ms=1, breaker_threshold=2,
                        breaker_cooldown_ms=200, devices=["cuda"])
    faults.configure("serve_dispatch:always")
    try:
        trail = [(outcome(srv.submit(X[i]))[0], srv.breaker.state)
                 for i in range(3)]
        time.sleep(0.25)
    finally:
        faults.reset()
    probe = outcome(srv.submit(X[3]))
    trail.append((probe[0], srv.breaker.state))
    srv.stop()
    check(trail == [("InjectedFault", "closed"), ("InjectedFault", "open"),
                    ("BreakerOpen", "open"), ("ok", "closed")]
          and probe[1] == want[3], "phase 21 breaker: %s" % trail)
    log("phase 21 breaker: %s" % trail)

    # a canary rolled back by an injected fault; v1 keeps serving
    reg = ModelRegistry()
    v1 = reg.load("phase21_canary", booster=bst, num_iteration=20)
    want1 = StackedForest.from_gbdt(bst, 0, 20).place("cuda").predict(
        X[:512])
    srv = PredictServer(reg, name="phase21_canary", max_batch=256,
                        max_wait_ms=1, devices=["cuda"])
    first = srv.predict(X[:256], timeout=120)
    v2 = reg.load("phase21_canary", booster=bst, canary_batches=4)
    faults.configure("serve_dispatch:nth:1")
    try:
        caught = srv.predict(X[256:512], timeout=120)
    finally:
        faults.reset()
    after = srv.predict(X[:512], timeout=120)
    state = (reg.get("phase21_canary")[0], reg.canary_active("phase21_canary"))
    srv.stop()
    check(state == (v1, False) and v2 == v1 + 1
          and np.array_equal(first, want1[:256])
          and np.array_equal(caught, want1[256:])
          and np.array_equal(after, want1),
          "phase 21 canary: state %s, answers equal to v1 %s"
          % (state, [np.array_equal(first, want1[:256]),
                     np.array_equal(caught, want1[256:]),
                     np.array_equal(after, want1)]))
    log("phase 21 canary v%d (canary_batches 4) rolled back by an injected "
        "serve_dispatch fault; v%d kept serving, byte-equal" % (v2, v1))

    # the drain: stop() over a waiting queue
    srv = PredictServer(forest, name="phase21_drain", max_batch=256,
                        max_wait_ms=1, autostart=False, devices=["cuda"])
    futs = [srv.submit(X[i]) for i in range(512)]
    futs.append(srv.submit(X[:1000]))
    srv.start()
    srv.stop(drain_timeout_s=0.05)
    kinds = {}
    for i, f in enumerate(futs):
        check(f.done(), "phase 21 drain: a Future was left pending")
        kind, val = outcome(f, 0)
        kinds[kind] = kinds.get(kind, 0) + 1
        if kind == "ok":
            check(np.array_equal(np.atleast_1d(val),
                                 want[i:i + 1] if i < 512 else want[:1000]),
                  "phase 21 drain: a served answer differs")
    check(set(kinds) <= {"ok", "ShuttingDown"},
          "phase 21 drain: outcomes %s" % kinds)
    log("phase 21 drain (stop with 513 requests queued, 0.05 s): %s; no "
        "Future left pending" % json.dumps(kinds))


# ---------------------------------------------------------------------------
# phase 22: out-of-core shards
# ---------------------------------------------------------------------------
#: rows per spilled shard of phase 22 (8 shards of the 2,097,152 rows)
SHARD_ROWS = 1 << 18


def in_memory_twin(ds):
    """An in-memory BinnedDataset of a spill's own bins (the same rows,
    binned once: the spill's bins are ``from_matrix``'s, held in
    ``tests/test_torch_shards.py``)."""
    from lightgbm_tpu_torch.io.dataset import BinnedDataset
    mem = BinnedDataset()
    for k in ("bin_mappers", "used_feature_map", "num_total_features",
              "feature_names", "metadata", "max_num_bin",
              "num_bin_per_feature", "monotone_constraints"):
        setattr(mem, k, getattr(ds, k))
    mem.bins = ds.assemble_bins()
    return mem


def first_split_gap(trees_a, trees_b, names=("sharded", "in-memory")
                    ) -> str:
    """Where two lists of trees grown in the same order first part: the
    tree, the split (in growth order) and each one's (feature, bin,
    gain) there, with the gains' relative gap (a near-tie when it is of
    the order of the f32 rounding of the sums)."""
    for t, (a, b) in enumerate(zip(trees_a, trees_b)):
        for j in range(min(a.num_internal, b.num_internal)):
            pa = (int(a.split_feature_inner[j]), int(a.threshold_in_bin[j]))
            pb = (int(b.split_feature_inner[j]), int(b.threshold_in_bin[j]))
            if pa != pb:
                ga, gb = float(a.split_gain[j]), float(b.split_gain[j])
                return ("first difference in tree %d at split %d: %s "
                        "(feature %d, bin %d, gain %.6f), %s "
                        "(feature %d, bin %d, gain %.6f), relative gap "
                        "%.3g" % (t, j, names[0], pa[0], pa[1], ga,
                                  names[1], pb[0], pb[1], gb,
                                  abs(ga - gb) / max(abs(ga), abs(gb),
                                                     1e-30)))
    return "no differing split (the difference is in values)"


def sharded_run(lgb, hist_mod, train_set, params, rounds, kernel, what,
                **kw):
    """``lgb.train`` with the launch counts set to 0 just before and read
    just after; returns (booster, seconds per iteration, device launches
    of ``kernel``, registry counter deltas)."""
    import torch
    from lightgbm_tpu_torch.obs.registry import registry
    before = {k: registry.count(k) for k in ("io/prefetch_stall_ms",
                                             "io/shards_staged")}
    hist_mod.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = lgb.train(params, train_set, num_boost_round=rounds, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    dev = hist_mod.device_launch_counts()
    others = {k: v for k, v in dev.items() if v and k != kernel}
    check(not others, "%s: launched other instances %s" % (what, others))
    delta = {k: registry.count(k) - v for k, v in before.items()}
    return bst, secs / max(rounds, 1), dev[kernel], delta


def phase_out_of_core(lgb, hist_mod, data):
    """Phase 22: the first 2,097,152 of phase 4's training rows spilled
    through ``StreamingDataset(spill_dir=...)`` into 8 shards of 262,144
    rows, trained at 255 leaves for 3 rounds in f32 and 2 in 8-bit by the
    shard-sweep learner (``tpu_frontier_splits`` 8), each beside the
    in-memory learner on the same bins: 8-bit trees text-equal (integer
    sums), f32 at the level reached ((a) text, (b) splits and leaf
    counts, or (c) held-out AUC within 1e-3, which must hold), K1 and K2
    device launches == shards x histogram passes (the root's and one per
    speculated split of each sweep round); s per iteration, sweeps per
    tree, prefetch stall ms and its share of the tree time. Then the
    spill attached again, an 8-bit run cut after 1 round with a
    checkpoint, and resumed to 2: its trees text-equal to the
    uninterrupted run's, the resume's score check replaying the trees
    shard by shard. Returns the launches by kernel and path."""
    import shutil
    import tempfile
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.shards import ShardedBinnedDataset
    from lightgbm_tpu_torch.io.streaming import StreamingDataset
    from lightgbm_tpu_torch.obs import events
    X, y = HEAD["X"], HEAD["y"]
    n = X.shape[0]
    params = dict(SLICE_PARAMS, num_leaves=255, device_type="cuda")
    out = {"histogram_f32": {}, "histogram_i8": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke22-")
    try:
        t0 = time.perf_counter()
        sd = StreamingDataset(X.shape[1], params=params,
                              chunk_rows=SHARD_ROWS,
                              spill_dir=os.path.join(tmp, "spill"))
        for lo in range(0, n, SHARD_ROWS):
            sd.push_rows(X[lo:lo + SHARD_ROWS], label=y[lo:lo + SHARD_ROWS])
        ds = sd.finalize(shard_rows=SHARD_ROWS)
        t_spill = time.perf_counter() - t0
        check(isinstance(ds, ShardedBinnedDataset)
              and ds.shard_sizes == [SHARD_ROWS] * (n // SHARD_ROWS),
              "phase 22: spilled %s" % getattr(ds, "shard_sizes", ds))
        shards = ds.num_shards
        mem = in_memory_twin(ds)
        log("phase 22 spill: %d rows x %d into %d shards of %d rows in "
            "%.1f s (%d MB of bins on disk)"
            % (n, X.shape[1], shards, SHARD_ROWS, t_spill,
               sum(os.path.getsize(os.path.join(tmp, "spill", f))
                   for f in os.listdir(os.path.join(tmp, "spill"))
                   if f.endswith(".bins.npy")) >> 20))
        runs = {}
        for tag, extra, rounds, kernel in (
                ("f32", {}, 3, "histogram_f32"),
                ("8bit", {"use_quantized_grad": True}, 2, "histogram_i8")):
            p = dict(params, **extra)
            sh, sh_s, sh_n, delta = sharded_run(
                lgb, hist_mod, lgb.Dataset(ds), p, rounds, kernel,
                "phase 22 sharded " + tag)
            st = sh.inner.learner.grow_stats
            check(sh_n == shards * st["hist_passes"] and sh_n > 0,
                  "phase 22 sharded %s: %d launches of %s, shards %d x "
                  "histogram passes %d" % (tag, sh_n, kernel, shards,
                                           st["hist_passes"]))
            im, im_s, im_n, _ = sharded_run(
                lgb, hist_mod, lgb.Dataset(mem), p, rounds, kernel,
                "phase 22 in-memory " + tag)
            ist = im.inner.learner.grow_stats
            check(im_n == ist["roots"] + ist["steps"],
                  "phase 22 in-memory %s: %d launches != roots + steps"
                  % (tag, im_n))
            out[kernel]["phase22_sharded_" + tag] = sh_n
            out[kernel]["phase22_in_memory_" + tag] = im_n
            runs[tag] = (sh, im)
            trees = max(st["roots"], 1)
            stall = delta["io/prefetch_stall_ms"]
            log("phase 22 %s, %d rounds: sharded %.3f s per iteration "
                "(%.1f sweeps, %.1f histogram passes, %.1f rounds, %.1f "
                "rejected speculations per tree; %d shard stagings), "
                "in-memory %.3f s; launches of %s %d == %d shards x %d "
                "passes (in-memory %d == roots + steps); prefetch stall "
                "%d ms, %.2f%% of the trees' time"
                % (tag, rounds, sh_s, st["sweeps"] / trees,
                   st["hist_passes"] / trees, st["rounds"] / trees,
                   st["rejected"] / trees, delta["io/shards_staged"], im_s,
                   kernel, sh_n, shards, st["hist_passes"], im_n, stall,
                   100.0 * stall / (1e3 * sh_s * rounds)))
        q_sh, q_im = runs["8bit"]
        check(q_sh.model_to_string() == q_im.model_to_string(),
              "phase 22 8-bit: sharded trees differ from the in-memory "
              "learner's")
        f_sh, f_im = runs["f32"]
        if f_sh.model_to_string() == f_im.model_to_string():
            level = "(a) text-equal"
        else:
            same = [tree_splits_of(a) == tree_splits_of(b)
                    and list(a.leaf_count[:a.num_leaves])
                    == list(b.leaf_count[:b.num_leaves])
                    for a, b in zip(f_sh.inner.models, f_im.inner.models)]
            level = ("(b) splits and leaf counts equal" if all(same) else
                     "(c): trees equal in splits %s; %s"
                     % (same, first_split_gap(f_sh.inner.models,
                                              f_im.inner.models)))
        Xh, yh = data[2], data[3]
        a_sh = auc(yh, f_sh.predict(Xh))
        a_im = auc(yh, f_im.predict(Xh))
        check(abs(a_sh - a_im) <= 1e-3,
              "phase 22 f32: held-out AUC sharded %.6f vs in-memory %.6f"
              % (a_sh, a_im))
        log("phase 22 8-bit: sharded trees text-equal to the in-memory "
            "learner's (level a); f32: level %s; held-out AUC (phase 4's "
            "%d rows) sharded %.6f, in-memory %.6f"
            % (level, len(yh), a_sh, a_im))
        del runs, f_sh, f_im, mem

        # attach the spill again; cut after 1 round, resume to 2
        cfg = Config.from_params(dict(params))
        q = dict(params, use_quantized_grad=True)
        ck = os.path.join(tmp, "ckpt")
        seen = []
        events.register_event_callback(seen.append)
        try:
            lgb.train(q, lgb.Dataset(ShardedBinnedDataset.attach(
                os.path.join(tmp, "spill"), cfg)), num_boost_round=1,
                checkpoint_dir=ck, checkpoint_freq=1)
            hist_mod.reset_launch_counts()
            res = lgb.train(q, lgb.Dataset(ShardedBinnedDataset.attach(
                os.path.join(tmp, "spill"), cfg)), num_boost_round=2,
                checkpoint_dir=ck, checkpoint_freq=1, resume=True)
        finally:
            events.register_event_callback(None)
        resumed = [e for e in seen if e["event"] == "checkpoint_resumed"]
        check(res.model_to_string() == q_sh.model_to_string()
              and [(e["iter"], e["score_replay"]) for e in resumed]
              == [(1, "ok")],
              "phase 22 resume: trees text-equal %s, resumes %s"
              % (res.model_to_string() == q_sh.model_to_string(),
                 [(e["iter"], e["score_replay"]) for e in resumed]))
        out["histogram_i8"]["phase22_resumed_8bit"] = \
            hist_mod.device_launch_counts()["histogram_i8"]
        log("phase 22 attach + resume: 8-bit cut after 1 round and resumed "
            "to 2 over the attached spill: trees text-equal to the "
            "uninterrupted run's; score check over the shards, max |diff| "
            "%.3g" % resumed[0]["score_replay_max_abs_diff"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 23: the mesh learners and multi-process training
# ---------------------------------------------------------------------------
#: logical shards of the one card in 23b and 23c, and ranks of 23d
MESH_SHARDS = 4
DTRAIN_RANKS = 2
#: the collective bound of 23d's rank whose peer never starts
LONE_RANK_TIMEOUT_S = 15


class learner_on:
    """``lgb.train``'s learner built by ``create_tree_learner(...,
    mesh=mesh)`` while the context is open (a mesh that names one card
    several times has no ``mesh_shape`` spelling)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        from lightgbm_tpu_torch.boosting.gbdt import GBDT
        from lightgbm_tpu_torch.treelearner import create_tree_learner
        self._orig = GBDT._make_learner
        mesh = self.mesh
        GBDT._make_learner = lambda gbdt, config, train_data: \
            create_tree_learner(config, train_data, gbdt.device, mesh=mesh)
        return self

    def __exit__(self, *exc):
        from lightgbm_tpu_torch.boosting.gbdt import GBDT
        GBDT._make_learner = self._orig


def chain_rows(tree, subtracts=True):
    """Per leaf, the rows whose f32 rounding its sums carry. A leaf's
    sums are a scan of its parent's histogram. A learner that subtracts
    builds the smaller child's histogram over its rows (the left one
    when its count is at most the right's) and takes the larger one as
    the parent's minus it, so a histogram carries the rounding of its
    ancestors up to the nearest one built over its own rows (the root
    at the latest): that ancestor's rows. A learner that builds both
    children (voting) carries the parent's rows."""
    n, ni = tree.num_leaves, tree.num_internal
    if ni == 0:
        return np.asarray(tree.leaf_count[:n], np.float64)
    up = {}
    for i in range(ni):
        for c in (tree.left_child[i], tree.right_child[i]):
            if c >= 0:
                up[int(c)] = i

    def count(c):
        return tree.internal_count[c] if c >= 0 else tree.leaf_count[~c]

    def built(node):
        p = up.get(node)
        if p is None:
            return True
        left, right = tree.left_child[p], tree.right_child[p]
        return (left == node) == (count(left) <= count(right))
    rows = []
    for leaf in range(n):
        node = int(tree.leaf_parent[leaf])
        while subtracts and not built(node):
            node = up[node]
        rows.append(float(tree.internal_count[node]))
    return np.asarray(rows)


def trees_level(trees_a, trees_b, names, lr=SLICE_PARAMS["learning_rate"],
                subtracts=(True, True)):
    """The parity level two lists of trees reach: (a) text-equal; (b)
    the same splits, default directions and leaf counts, and every leaf
    value within the f32 bound of its sums, ``REL_TOL x (lr x rows /
    sum_hess + |value|)``: the kernel's tolerance over the rows whose
    rounding each side's sums carry (:func:`chain_rows` of each tree,
    ``subtracts`` saying which learners take the larger child by
    subtraction; binary-objective gradients are at most 1 in
    magnitude); else (c), with where they first part. The largest
    relative leaf-value and gain differences are printed beside (gains
    are differences of large sums, so they move more), and the leaf
    nearest its bound."""
    if [t.to_string() for t in trees_a] == [t.to_string() for t in trees_b]:
        return "a", "(a) text-equal"
    structure = len(trees_a) == len(trees_b) and all(
        tree_splits_of(a) == tree_splits_of(b)
        and list(a.decision_type[:a.num_internal])
        == list(b.decision_type[:b.num_internal])
        and list(a.leaf_count[:a.num_leaves])
        == list(b.leaf_count[:b.num_leaves])
        for a, b in zip(trees_a, trees_b))
    if not structure:
        return "c", "(c): " + first_split_gap(trees_a, trees_b, names)

    def rel(x, y):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        return float((np.abs(x - y) / np.maximum(np.abs(y), 1e-30)).max())
    leaf = max(rel(a.leaf_value[:a.num_leaves], b.leaf_value[:b.num_leaves])
               for a, b in zip(trees_a, trees_b))
    gain = max(rel(a.split_gain[:a.num_internal],
                   b.split_gain[:b.num_internal])
               for a, b in zip(trees_a, trees_b))
    worst, at = 0.0, ""
    for t, (a, b) in enumerate(zip(trees_a, trees_b)):
        n = b.num_leaves
        va, vb = a.leaf_value[:n], b.leaf_value[:n]
        rows = chain_rows(a, subtracts[0]) + chain_rows(b, subtracts[1])
        bound = REL_TOL * (lr * rows / np.maximum(b.leaf_weight[:n], 1e-30)
                           + np.abs(vb))
        ratio = np.abs(va - vb) / bound
        k = int(np.argmax(ratio))
        if ratio[k] >= worst:
            worst = float(ratio[k])
            at = ("tree %d leaf %d: %d rows, %d + %d rows in its sums' "
                  "rounding, values %.9g / %.9g, bound %.3g"
                  % (t, k, b.leaf_count[k],
                     chain_rows(a, subtracts[0])[k],
                     chain_rows(b, subtracts[1])[k], va[k], vb[k], bound[k]))
    text = ("the same splits, default directions and leaf counts; leaf "
            "values within %.3g relative (%.3g of their f32 bound; nearest "
            "%s), gains within %.3g relative" % (leaf, worst, at, gain))
    return ("b" if worst <= 1.0 else "c"), \
        ("(b) " if worst <= 1.0 else "(c) ") + text


def phase23_one_device(lgb, hist_mod, data, looped):
    """23a: ``tree_learner=data`` through ``lgb.train`` on phase 4's
    Dataset (no second binning): the one card gives a 1-device mesh, the
    loop is the captured whole-tree step, K1's device counter == roots +
    steps, and the 2 trees are phase 4's first 2, text for text."""
    from lightgbm_tpu_torch.parallel import DataParallelTreeLearner
    ds, valid = data[0], data[1]
    run = train_path(lgb, hist_mod, ds, valid,
                     dict(SLICE_PARAMS, num_leaves=255, tree_learner="data"),
                     "histogram_f32", 2, tag="23a tree_learner=data")
    bst = run["booster"]
    learner = bst.inner.learner
    check(isinstance(learner, DataParallelTreeLearner)
          and learner.mesh.size == 1 and run["fused"]
          and learner.grow_stats["captures"] == 1,
          "23a: learner %s over %s, whole-tree %s, captures %d"
          % (type(learner).__name__, getattr(learner, "mesh", None),
             run["fused"], learner.grow_stats["captures"]))
    want = [t.to_string() for t in looped["f32"][0][:2]]
    check([t.to_string() for t in bst.inner.models] == want,
          "23a: the 1-device-mesh trees differ from phase 4's")
    log("23a tree_learner=data on %r: the captured whole-tree loop, host "
        "syncs per tree %s, ms per split %.3f (phase 4 %.3f); both trees "
        "text-equal to phase 4's first 2"
        % (learner.mesh, run["tree_syncs"], SPLIT_MS["23a tree_learner=data"],
           SPLIT_MS[PHASE4_TAG]))
    return {"histogram_f32": {
        "phase23a_data_1device": run["launches"]["histogram_f32"]}}


def phase23_shards(lgb, hist_mod, data, looped):
    """23b: ``Mesh([cuda:0] * 4)`` through ``create_tree_learner(...,
    mesh=)`` on phase 4's Dataset, 2 rounds f32 and 2 rounds 8-bit: K1 /
    K2 launches == 4 x (roots + steps), the step still one captured
    graph; 8-bit trees text-equal to phase 7's; f32 at level (b) against
    phase 4's, else the first split where they part with both gains, and
    the held-out AUC within 1e-3 of phase 4's; ms per split beside phase
    4's."""
    import torch
    from lightgbm_tpu_torch.parallel import Mesh
    ds, valid = data[0], data[1]
    mesh = Mesh([torch.device("cuda", 0)] * MESH_SHARDS)
    out = {"histogram_f32": {}, "histogram_i8": {}}
    runs = {}
    with learner_on(mesh):
        for tag, extra, kernel in (
                ("f32", {}, "histogram_f32"),
                ("8bit", {"use_quantized_grad": True, "quant_grad_bits": 8},
                 "histogram_i8")):
            name = "23b data, %d shards on one card, %s" % (MESH_SHARDS, tag)
            run = train_path(lgb, hist_mod, ds, valid,
                             dict(SLICE_PARAMS, num_leaves=255,
                                  tree_learner="data", **extra),
                             kernel, 2, tag=name, per_root=MESH_SHARDS,
                             per_step=MESH_SHARDS)
            learner = run["booster"].inner.learner
            check(learner.mesh.size == MESH_SHARDS and run["fused"]
                  and learner.grow_stats["captures"] == 1,
                  "23b %s: mesh %r, whole-tree %s, captures %d"
                  % (tag, learner.mesh, run["fused"],
                     learner.grow_stats["captures"]))
            out[kernel]["phase23b_data_%dshards_%s" % (MESH_SHARDS, tag)] = \
                run["launches"][kernel]
            runs[tag] = (run, name)
    q_trees = runs["8bit"][0]["booster"].inner.models
    check([t.to_string() for t in q_trees]
          == [t.to_string() for t in looped["8bit"][0][:2]],
          "23b 8-bit: the 4-shard trees differ from phase 7's")
    f_run, f_name = runs["f32"]
    level, text = trees_level(f_run["booster"].inner.models,
                              looped["f32"][0][:2],
                              ("4 shards", "phase 4"))
    if level == "c":
        a4 = looped["f32"][1][1]
        a = f_run["evals"]["auc"][-1]
        check(abs(a - a4) <= 1e-3, "23b f32: held-out AUC %.6f against "
              "phase 4's %.6f after 2 rounds" % (a, a4))
        text += "; held-out AUC %.6f (phase 4 %.6f)" % (a, a4)
        # where the two learners part on tree 0's own gradients
        import torch
        params = dict(SLICE_PARAMS, num_leaves=255)
        g, h = tree0_gradients(lgb, ds, params)
        ones = torch.ones_like(g)
        gh = torch.stack([g, h, ones, ones], dim=1)
        shards = f_run["booster"].inner.learner
        serial = lgb.Booster(params, ds).inner.learner
        near = efb_first_difference(
            shards, serial, gh, shards._grow_fused(gh)[0],
            serial._grow_fused(gh)[0], "tree 0's gradients",
            names=("4 shards", "serial"), label="23b",
            shape="higgs 10.5M, 255 leaves, f32")
        check(near is not False, "23b f32: the 4-shard and the serial "
              "learner part on tree 0's gradients past the f32 rounding "
              "of their histograms")
        del serial
    log("23b %d shards on one card: 8-bit trees text-equal to phase 7's; "
        "f32 against phase 4's: level %s; ms per split f32 %.3f, 8-bit "
        "%.3f (phase 4 %.3f, phase 7 %s); host syncs per tree %s"
        % (MESH_SHARDS, text, SPLIT_MS[f_name], SPLIT_MS[runs["8bit"][1]],
           SPLIT_MS[PHASE4_TAG], "%.3f" % SPLIT_MS[PHASE7_TAG]
           if PHASE7_TAG in SPLIT_MS else "not run",
           f_run["tree_syncs"]))
    return out


def rank_sample_template(lgb, X):
    """The Dataset whose mappers every rank of 23d builds: each rank's
    sample (``data_random_seed + rank``, ``bin_construct_sample_cnt /
    ranks`` of its rows, sorted), concatenated in rank order
    (``parallel/distributed.py::distributed_binned_dataset``)."""
    from lightgbm_tpu_torch.config import Config
    cfg = Config.from_params(dict(SLICE_PARAMS))
    per = max(1, cfg.bin_construct_sample_cnt // DTRAIN_RANKS)
    half = len(X) // DTRAIN_RANKS
    parts = []
    for r in range(DTRAIN_RANKS):
        local = X[r * half:(r + 1) * half].astype(np.float64)
        take = min(per, len(local))
        rng = np.random.RandomState(cfg.data_random_seed + r)
        idx = (np.sort(rng.choice(len(local), take, replace=False))
               if take < len(local) else np.arange(len(local)))
        parts.append(local[idx])
    sample = np.concatenate(parts)
    return lgb.Dataset(sample, params=dict(
        SLICE_PARAMS, bin_construct_sample_cnt=len(sample))).construct()


def phase23_feature_voting(lgb, hist_mod, data):
    """23c: the first 2,097,152 training rows (phase 15 / 16's), binned
    once with the mappers 23d's ranks build; the serial learner, then on
    ``Mesh([cuda:0] * 4)`` the feature-parallel learner (level (b)
    against serial, text-equality printed), voting with ``top_k`` 28
    (every feature voted; level (b)) and voting with ``top_k`` 2 (held-out
    AUC > 0.7), 2 rounds each. Returns (launches, the Dataset, its
    held-out set, the serial booster)."""
    import torch
    from lightgbm_tpu_torch.parallel import Mesh
    X, y = HEAD["X"], HEAD["y"]
    t0 = time.perf_counter()
    template = rank_sample_template(lgb, X)
    ds = lgb.Dataset(X, label=y, reference=template,
                     params=SLICE_PARAMS).construct()
    valid = lgb.Dataset(data[2], label=data[3], reference=ds).construct()
    log("23c: %d rows binned with the %d ranks' mappers in %.1f s"
        % (len(y), DTRAIN_RANKS, time.perf_counter() - t0))
    params = dict(SLICE_PARAMS, num_leaves=255)
    serial = train_path(lgb, hist_mod, ds, valid, params, "histogram_f32",
                        2, tag="23c serial")
    out = {"phase23c_serial": serial["launches"]["histogram_f32"]}
    base = serial["booster"].inner.models
    mesh = Mesh([torch.device("cuda", 0)] * MESH_SHARDS)
    with learner_on(mesh):
        feat = train_path(lgb, hist_mod, ds, valid,
                          dict(params, tree_learner="feature"),
                          "histogram_f32", 2, tag="23c feature",
                          per_root=MESH_SHARDS, per_step=MESH_SHARDS)
        level, ftext = trees_level(feat["booster"].inner.models, base,
                                   ("feature", "serial"))
        if level not in "ab":
            DEFERRED.append("23c feature-parallel against serial: %s"
                            % ftext)
        q16 = dict(params, use_quantized_grad=True, quant_grad_bits=16)
        shard16 = train_path(lgb, hist_mod, ds, valid,
                             dict(q16, tree_learner="data"),
                             "histogram_i16", 1, tag="23c data 16-bit",
                             per_root=MESH_SHARDS, per_step=MESH_SHARDS)
        votes = {}
        for k in (28, 2):
            votes[k] = train_path(
                lgb, hist_mod, ds, valid,
                dict(params, tree_learner="voting", top_k=k),
                "histogram_f32", 2, tag="23c voting top_k %d" % k,
                per_root=MESH_SHARDS, per_step=2 * MESH_SHARDS)
            out["phase23c_voting_top%d" % k] = \
                votes[k]["launches"]["histogram_f32"]
    out["phase23c_feature"] = feat["launches"]["histogram_f32"]
    serial16 = train_path(lgb, hist_mod, ds, valid, q16, "histogram_i16",
                          1, tag="23c serial 16-bit")
    check([t.to_string() for t in shard16["booster"].inner.models]
          == [t.to_string() for t in serial16["booster"].inner.models],
          "23c 16-bit: the 4-shard data learner's tree differs from the "
          "serial learner's")
    i16 = {"phase23c_data_16bit_%dshards" % MESH_SHARDS:
           shard16["launches"]["histogram_i16"],
           "phase23c_serial_16bit": serial16["launches"]["histogram_i16"]}
    vlevel, vtext = trees_level(votes[28]["booster"].inner.models, base,
                                ("voting", "serial"),
                                subtracts=(False, True))
    if vlevel not in "ab":
        DEFERRED.append("23c voting, every feature voted, against serial: "
                        "%s" % vtext)
    a2 = votes[2]["evals"]["auc"][-1]
    check(a2 > 0.7, "23c voting top_k 2: held-out AUC %.6f" % a2)
    log("23c %d shards on one card, %d rows: feature-parallel against "
        "serial %s; voting (top_k 28, every feature) %s; voting top_k 2 "
        "held-out AUC %.6f (serial %.6f); the 16-bit data learner's tree "
        "text-equal to serial's; ms per split serial %.3f, feature %.3f, "
        "voting %.3f / %.3f, 16-bit data %.3f (serial %.3f)"
        % (MESH_SHARDS, len(y), ftext, vtext, a2,
           serial["evals"]["auc"][-1], SPLIT_MS["23c serial"],
           SPLIT_MS["23c feature"], SPLIT_MS["23c voting top_k 28"],
           SPLIT_MS["23c voting top_k 2"], SPLIT_MS["23c data 16-bit"],
           SPLIT_MS["23c serial 16-bit"]))
    return {"histogram_f32": out, "histogram_i16": i16}, ds, valid


def _rank_cmd(rank, directory):
    return [sys.executable, os.path.abspath(__file__), "--dtrain-rank",
            str(rank), "--dtrain-dir", directory]


def phase23_dtrain(lgb, hist_mod, ds, valid):
    """23d: ``dtrain.train`` in 2 subprocesses over gloo on CUDA tensors
    of the one card (NCCL refuses two ranks on one card), 23c's rows
    split 1,048,576 each, 2 rounds f32 at 255 leaves: both ranks' model
    text identical and equal to 23c's rows through an in-process
    2-shard data learner on the same mappers; each rank's K1 counter ==
    its roots + steps, the eager loop (no capture); the all-reduce ms
    per split and the syncs per tree printed. A third rank of another
    2-rank group, whose peer never starts, must exit non-zero within its
    collective timeout (``LIGHTGBM_TPU_DTRAIN_TIMEOUT_S`` =
    ``LONE_RANK_TIMEOUT_S``). The NCCL path (one card per rank) needs two
    cards and is not run."""
    import shutil
    import tempfile
    import torch
    from lightgbm_tpu_torch.parallel import Mesh
    X, y = HEAD["X"], HEAD["y"]
    half = len(y) // DTRAIN_RANKS
    tmp = tempfile.mkdtemp(prefix="chip_smoke23-")
    procs = []
    try:
        for r in range(DTRAIN_RANKS):
            np.save(os.path.join(tmp, "x%d.npy" % r),
                    X[r * half:(r + 1) * half])
            np.save(os.path.join(tmp, "y%d.npy" % r),
                    y[r * half:(r + 1) * half])
        lone_dir = os.path.join(tmp, "lone")
        os.makedirs(lone_dir)
        for f in ("x0.npy", "y0.npy"):
            os.link(os.path.join(tmp, f), os.path.join(lone_dir, f))
        env = dict(os.environ)
        env["LIGHTGBM_TPU_DTRAIN_TIMEOUT_S"] = str(LONE_RANK_TIMEOUT_S)
        t_lone = time.perf_counter()
        lone = subprocess.Popen(_rank_cmd(0, lone_dir), env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs.append(lone)
        env = dict(os.environ)
        env["LIGHTGBM_TPU_DTRAIN_TIMEOUT_S"] = "300"
        ranks = [subprocess.Popen(_rank_cmd(r, tmp), env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(DTRAIN_RANKS)]
        procs += ranks
        lone_out, _ = lone.communicate(timeout=LONE_RANK_TIMEOUT_S + 120)
        t_lone = time.perf_counter() - t_lone
        logs = [p.communicate(timeout=600)[0] for p in ranks]
        for r, (p, text) in enumerate(zip(ranks, logs)):
            check(p.returncode == 0, "23d rank %d exited %s:\n%s"
                  % (r, p.returncode, text[-4000:]))
        check(lone.returncode not in (0, None)
              and t_lone < LONE_RANK_TIMEOUT_S + 120,
              "23d: a rank whose peer never started exited %s after "
              "%.1f s:\n%s" % (lone.returncode, t_lone, lone_out[-2000:]))
        res = []
        for r in range(DTRAIN_RANKS):
            with open(os.path.join(tmp, "rank%d.json" % r)) as fh:
                res.append(json.load(fh))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    check(res[0]["text"] == res[1]["text"],
          "23d: the two ranks' model texts differ")
    out = {}
    for r, rr in enumerate(res):
        check(rr["launches"]["histogram_f32"] == rr["roots"] + rr["steps"]
              and sum(rr["launches"].values())
              == rr["launches"]["histogram_f32"] and rr["captures"] == 0,
              "23d rank %d: K1 launches %s, roots %d + steps %d, captures "
              "%d" % (r, rr["launches"], rr["roots"], rr["steps"],
                      rr["captures"]))
        out["phase23d_dtrain_rank%d" % r] = rr["launches"]["histogram_f32"]
    with learner_on(Mesh([torch.device("cuda", 0)] * DTRAIN_RANKS)):
        inproc = train_path(lgb, hist_mod, ds, valid,
                            dict(SLICE_PARAMS, num_leaves=255,
                                 tree_learner="data"),
                            "histogram_f32", 2, tag="23d in-process",
                            per_root=DTRAIN_RANKS, per_step=DTRAIN_RANKS)
    out["phase23d_in_process_2shards"] = \
        inproc["launches"]["histogram_f32"]
    mine = inproc["booster"].model_to_string().split("end of trees")[0]
    theirs = res[0]["text"].split("end of trees")[0]
    check(mine == theirs, "23d: the ranks' trees differ from the "
          "in-process 2-shard learner's")
    r0 = res[0]
    trees = max(r0["roots"], 1)
    log("23d %d ranks over gloo on one card, %d rows each: model text "
        "identical on both ranks and equal to the in-process %d-shard "
        "learner's; the eager loop: %.1f host reads (step counter and "
        "records) and %.1f all-reduces (each a stream sync) per tree; "
        "all-reduce %.3f ms each, %.3f ms per split (%d all-reduces, %d "
        "splits); %.2f s for 2 rounds on rank 0 (in-process %.3f ms per "
        "split); a rank whose peer never started exited %d after %.1f s "
        "(timeout %d s)"
        % (DTRAIN_RANKS, half, DTRAIN_RANKS,
           (r0["flag_reads"] + r0["record_reads"]) / trees,
           r0["allreduces"] / trees,
           r0["allreduce_ms"] / max(r0["allreduces"], 1),
           r0["allreduce_ms"] / max(r0["splits"], 1), r0["allreduces"],
           r0["splits"], r0["seconds"], SPLIT_MS["23d in-process"],
           lone.returncode, t_lone, LONE_RANK_TIMEOUT_S))
    return {"histogram_f32": out}


def dtrain_rank(rank: int, directory: str) -> int:
    """One rank of 23d (``--dtrain-rank``): its rows from ``directory``,
    the group from a ``file://`` store there, ``dtrain.train`` on the
    card, its model text and counts to ``rank<r>.json``."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as hist_mod
    from lightgbm_tpu_torch.parallel import distributed, dtrain
    X = np.load(os.path.join(directory, "x%d.npy" % rank))
    y = np.load(os.path.join(directory, "y%d.npy" % rank))
    distributed.initialize("file://" + os.path.join(directory, "rendezvous"),
                           DTRAIN_RANKS, rank, backend="gloo")
    made = []
    make = dtrain._DistributedGBDT._make_learner

    def keep(gbdt, config, train_data):
        made.append(make(gbdt, config, train_data))
        return made[-1]
    dtrain._DistributedGBDT._make_learner = keep
    hist_mod.reset_launch_counts()
    t0 = time.perf_counter()
    bst = dtrain.train(dict(SLICE_PARAMS, num_leaves=255), X, y,
                       num_boost_round=2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    st, cs = made[0].grow_stats, made[0].comm_stats
    with open(os.path.join(directory, "rank%d.json" % rank), "w") as fh:
        json.dump({"text": bst.model_to_string(),
                   "launches": hist_mod.device_launch_counts(),
                   "roots": st["roots"], "steps": st["steps"],
                   "captures": st["captures"],
                   "flag_reads": st["flag_reads"],
                   "record_reads": st["record_reads"],
                   "allreduces": cs["allreduces"],
                   "allreduce_ms": cs["allreduce_ms"],
                   "splits": sum(t.num_leaves - 1
                                 for t in bst.inner.models),
                   "seconds": seconds}, fh)
    torch.distributed.destroy_process_group()
    return 0


#: failed checks of phase 23 that let its later parts run first
DEFERRED = []


def phase_parallel(lgb, hist_mod, data, looped):
    """Phase 23: returns the launches of each run by kernel and path."""
    runs = {"histogram_f32": {}, "histogram_i8": {}}
    for part in (phase23_one_device(lgb, hist_mod, data, looped),
                 phase23_shards(lgb, hist_mod, data, looped)):
        for kernel, paths in part.items():
            runs[kernel].update(paths)
    part, ds, valid = phase23_feature_voting(lgb, hist_mod, data)
    runs["histogram_i16"] = {}
    for kernel, paths in part.items():
        runs[kernel].update(paths)
    runs["histogram_f32"].update(
        phase23_dtrain(lgb, hist_mod, ds, valid)["histogram_f32"])
    check(not DEFERRED, "; ".join(DEFERRED))
    return runs


# ---------------------------------------------------------------------------
# phase 24: the closed refresh loop on the card
# ---------------------------------------------------------------------------
#: rows of a 24a window (phase 22's spill shape: 8 shards of SHARD_ROWS)
LOOP_ROWS = 1 << 21
LOOP_CYCLES = 4
#: the serve p99 SLO of the refresh loop's watchdog rule in phase 24: the
#: JAX package's own refresh bench setting (bench.py:1050)
LOOP_SLO_ENV = "LIGHTGBM_TPU_WATCH_REFRESH_P99_MS"
LOOP_SLO_MS = "1000"
#: 24b, the JAX bench's drift settings (bench.py:1052-1072): 20k-row
#: windows, 31 leaves, pools of 64 blocks x 64 rows, drift windows of 1 s
#: with at least 4096 rows
DRIFT_ROWS = 20_000
DRIFT_PARAMS = {"objective": "binary", "num_leaves": 31, "max_bin": 255,
                "verbosity": -1, "min_data_in_leaf": 20,
                "bin_construct_sample_cnt": 20_000}
DRIFT_KW = dict(traffic_rows=64, traffic_pool=64, drift_min_window_rows=4096,
                drift_window_s=1.0, drift_max_windows=6, base_rounds=6,
                extra_rounds=2, traffic_threads=2)
DRIFT_SHIFT_ROWS = 2048
DRIFT_CONTROL_CYCLES = 3


class collect_learners:
    """Every learner ``GBDT`` builds while the context is open (each
    ``lgb.train`` call builds one), in order."""

    def __enter__(self):
        from lightgbm_tpu_torch.boosting.gbdt import GBDT
        self.learners = []
        self._orig = GBDT._make_learner
        orig, made = self._orig, self.learners

        def keep(gbdt, config, train_data):
            made.append(orig(gbdt, config, train_data))
            return made[-1]
        GBDT._make_learner = keep
        return self

    def __exit__(self, *exc):
        from lightgbm_tpu_torch.boosting.gbdt import GBDT
        GBDT._make_learner = self._orig


def published_texts(ctl):
    """Record each model text a RefreshController publishes (the
    bootstrap booster's, then each refresh's refit text)."""
    texts = []
    load = ctl.registry.load

    def recording(name="default", booster=None, model_str=None, **kw):
        texts.append(model_str if model_str is not None
                     else booster.model_to_string())
        return load(name, booster=booster, model_str=model_str, **kw)
    ctl.registry.load = recording
    return texts


def run_loop(hist_mod, ctl, cycles, what):
    """``ctl.run(cycles)`` with the launch counts set to 0 just before
    and read just after, and every learner, graph capture and refresh
    record kept. Checks K1's device counter == the sum over the loop's
    learners of shards x histogram passes, and no other instance.
    Returns (report, wall s, learners, capture ms by cycle, device
    launches of K1, peak bytes, serve p50 and p99 ms over the run)."""
    import torch
    from lightgbm_tpu_torch.obs import events
    from lightgbm_tpu_torch.obs.registry import registry
    seen = []
    lat0 = registry.observed("serve/latency_ms")
    hist_mod.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events.register_event_callback(seen.append)
    try:
        with collect_learners() as made:
            t0 = time.perf_counter()
            rep = ctl.run(cycles=cycles)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        events.register_event_callback(None)
    peak = torch.cuda.max_memory_allocated()
    dev = hist_mod.device_launch_counts()
    learners = made.learners
    want = sum(lr.dataset.num_shards * lr.grow_stats["hist_passes"]
               for lr in learners)
    check(all(hasattr(lr.dataset, "num_shards") for lr in learners)
          and dev["histogram_f32"] == want > 0
          and sum(dev.values()) == dev["histogram_f32"],
          "%s: K1 device launches %d, shards x passes over the %d "
          "learners %d; all launches %s" % (what, dev["histogram_f32"],
                                             len(learners), want, dev))
    capture_ms, cycle = {}, 0
    for e in seen:
        if e["event"] == "refresh_cycle":
            cycle = e["cycle"] + 1
        elif e["event"] == "graph_capture":
            capture_ms.setdefault(cycle, []).append(
                1e3 * e["capture_seconds"])
    lat = {q: registry.percentile("serve/latency_ms", q, since=lat0)
           for q in (50.0, 99.0)}
    return (rep, wall, learners, capture_ms, dev["histogram_f32"], peak,
            (lat[50.0], lat[99.0]))


def check_report(rep, what, outcomes):
    traffic = rep["traffic"]
    check(rep["ok"] and [c["outcome"] for c in rep["cycles"]] == outcomes
          and not traffic["untyped"] and rep["stranded_futures"] == 0,
          "%s: ok %s, outcomes %s (want %s), untyped %s, stranded %d, "
          "problems %s" % (what, rep["ok"],
                           [c["outcome"] for c in rep["cycles"]], outcomes,
                           traffic["untyped"], rep["stranded_futures"],
                           rep["problems"]))


def phase24_rotation(lgb, hist_mod, card):
    """24a: ``RefreshController`` over windows of LOOP_ROWS Higgs-shaped
    rows (``make_higgs_like``, seed 100 + cycle) spilled into 8 shards of
    SHARD_ROWS, binary, 255 leaves, max_bin 255, f32; 2 base rounds and 1
    per refresh, 4 cycles under ``refresh_schedule(4)`` (a poisoned
    canary, a retried train fault, a lost gateway push), the gateway on,
    2 pumps of 64-row blocks from a pool of 4. Checks the report, the
    outcomes, one rollback, every leg fired, no untyped failure or
    stranded future, K1 == shards x passes over the loop's learners, a
    captured round finish in every refresh; then, with no server
    running, the newest checkpoint's text equals one uninterrupted
    ``lgb.train`` of 5 rounds on the re-attached spill, its refit on
    window 3 the stable version's text, and the stable version's answers
    on 4096 rows ``StackedForest.predict`` of that text byte for byte.
    Returns the launches of K1 by path."""
    import shutil
    import tempfile
    import torch
    from lightgbm_tpu_torch.ft import checkpoint as ckpt_mod
    from lightgbm_tpu_torch.io.shards import ShardedBinnedDataset
    from lightgbm_tpu_torch.loop import RefreshController, refresh_schedule
    from lightgbm_tpu_torch.serve import PredictServer, StackedForest
    windows = {}

    def data_fn(cycle):
        if cycle not in windows:
            windows[cycle] = make_higgs_like(LOOP_ROWS, seed=100 + cycle)
        return windows[cycle]

    params = dict(SLICE_PARAMS, num_leaves=255)
    schedule = refresh_schedule(LOOP_CYCLES)
    rounds = 2 + (LOOP_CYCLES - 1)
    tmp = tempfile.mkdtemp(prefix="chip_smoke24-")
    try:
        ctl = RefreshController(params, data_fn, num_features=28,
                                work_dir=tmp, base_rounds=2, extra_rounds=1,
                                traffic_threads=2, traffic_rows=64,
                                traffic_pool=4, schedule=schedule,
                                use_gateway=True, shard_rows=SHARD_ROWS)
        texts = published_texts(ctl)
        rep, wall, learners, capture_ms, k1, peak, p50_99 = run_loop(
            hist_mod, ctl, LOOP_CYCLES, "24a")
        check_report(rep, "24a", ["bootstrap", "rolled_back", "promoted",
                                  "promoted"])
        check(rep["refresh_rollbacks"] == rep["expected_rollbacks"] == 1
              and all(c["injected"] >= 1 for c in rep["cycles"][1:]),
              "24a: rollbacks %d (expected %d), injected by cycle %s"
              % (rep["refresh_rollbacks"], rep["expected_rollbacks"],
                 [c["injected"] for c in rep["cycles"]]))
        check(len(learners) == LOOP_CYCLES
              and all(lr.grow_stats["captures"] >= 1 for lr in learners),
              "24a: %d learners, captures %s" % (
                  len(learners), [lr.grow_stats["captures"]
                                  for lr in learners]))
        stable, forest = ctl.registry.get(ctl.name)
        check(stable == rep["cycles"][-1]["stable_version"]
              == rep["cycles"][-1]["version"],
              "24a: the stable version %d is not the last refresh's" %
              stable)
        secs = [c["seconds"] for c in rep["cycles"]]
        log("24a closed loop, %d cycles over %d-row windows (%d shards of "
            "%d rows, 255 leaves, 2 + 1 rounds a cycle; %s=%s ms): "
            "outcomes %s, rollbacks %d, faults injected %d, stranded %d, "
            "untyped failures 0; s per cycle %s (refresh mean %.3f); "
            "capture ms by refresh %s; served %d rows in %d requests "
            "(%d shed, typed %s), %.0f rows/s over the loop's %.1f s; "
            "serve p50 %.3f ms, p99 %.3f ms (worst cycle p99 %.3f); peak "
            "device memory %.2f GB; K1 launches %d == shards x passes of "
            "%d learners; %s"
            % (LOOP_CYCLES, LOOP_ROWS, LOOP_ROWS // SHARD_ROWS, SHARD_ROWS,
               LOOP_SLO_ENV, os.environ.get(LOOP_SLO_ENV),
               [c["outcome"] for c in rep["cycles"]],
               rep["refresh_rollbacks"], rep["faults_injected"],
               rep["stranded_futures"], secs, rep["refresh_cycle_seconds"],
               {c: [round(v, 3) for v in ms]
                for c, ms in sorted(capture_ms.items())},
               rep["traffic"]["rows_ok"], rep["traffic"]["requests"],
               rep["traffic"]["shed"], rep["traffic"]["typed"],
               rep["traffic"]["rows_ok"] / wall, wall, *p50_99,
               rep["serve_p99_during_refresh_ms"], peak / 1e9, k1,
               len(learners), card))

        # capture under traffic: the same training with no server
        _, newest = ckpt_mod.list_checkpoints(os.path.join(tmp, "ckpt"))[0]
        with open(os.path.join(newest, "model.txt")) as fh:
            loop_text = fh.read()
        hist_mod.reset_launch_counts()
        t0 = time.perf_counter()
        alone = lgb.train(dict(params), lgb.Dataset(
            ShardedBinnedDataset.attach(os.path.join(tmp, "spill"))),
            num_boost_round=rounds)
        torch.cuda.synchronize()
        t_alone = time.perf_counter() - t0
        k1_alone = hist_mod.device_launch_counts()["histogram_f32"]
        check(loop_text == alone.model_to_string()
              and len(alone.inner.models) == rounds,
              "24a: the loop's newest checkpoint (%d trees) differs from "
              "the uninterrupted training on the attached spill"
              % loop_text.count("Tree="))
        X3, y3 = data_fn(LOOP_CYCLES - 1)
        refit = alone.refit(np.asarray(X3, dtype=np.float64),
                            np.asarray(y3, dtype=np.float64))
        check(refit.model_to_string() == texts[-1],
              "24a: the refit of the uninterrupted model on window %d "
              "differs from the stable version's text" % (LOOP_CYCLES - 1))
        block = np.ascontiguousarray(X3[:4096])
        want = StackedForest.from_gbdt(lgb.Booster(
            model_str=texts[-1])).place("cuda").predict(block)
        srv = PredictServer(ctl.registry, name=ctl.name, max_batch=256,
                            max_wait_ms=2, devices=["cuda"])
        try:
            got = srv.predict(block, timeout=120)
        finally:
            srv.stop()
        check(np.array_equal(np.asarray(got), np.asarray(want))
              and np.array_equal(np.asarray(forest.place("cuda").predict(
                  block)), np.asarray(want)),
              "24a: the stable version's answers differ from "
              "StackedForest.predict of its text")
        log("24a capture under traffic: the newest checkpoint (%d rounds, "
            "each refresh's learner captured while the server and 2 pumps "
            "used the card) text-equal to one uninterrupted lgb.train on "
            "the attached spill with no server (%.2f s, K1 %d); its refit "
            "on window %d text-equal to the stable v%d; v%d's answers on "
            "4096 rows byte-equal to StackedForest.predict of its text; %s"
            % (rounds, t_alone, k1_alone, LOOP_CYCLES - 1, stable, stable,
               card))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"phase24a_closed_loop": k1,
            "phase24a_uninterrupted_5_rounds": k1_alone}


def phase24_drift(lgb, hist_mod, card):
    """24b: the JAX bench's drift stage on the card: a no-shift control
    (3 cycles, cadence, windows sliced from one draw: PSI must stay below
    ``LIGHTGBM_TPU_WATCH_PSI`` and ``feature_drift`` must not fire), then
    4 cycles with ``refresh_trigger="drift"`` and the covariate shift
    after 2048 served rows under the default schedule (PSI at or above
    the threshold, ``feature_drift`` fired, at least one drift-triggered
    refresh). Returns the launches of K1 by path."""
    import shutil
    import tempfile
    from lightgbm_tpu_torch.loop import RefreshController
    from lightgbm_tpu_torch.obs.registry import registry
    thr = float(os.environ.get("LIGHTGBM_TPU_WATCH_PSI", "0.25"))
    Xc, yc = make_higgs_like(DRIFT_ROWS * DRIFT_CONTROL_CYCLES, seed=7)

    def control_fn(cycle):
        lo = cycle * DRIFT_ROWS
        return Xc[lo:lo + DRIFT_ROWS], yc[lo:lo + DRIFT_ROWS]

    def drift_fn(cycle):
        return make_higgs_like(DRIFT_ROWS, seed=7 + cycle)

    out, reps = {}, {}
    for tag, fn, cycles, kw in (
            ("control", control_fn, DRIFT_CONTROL_CYCLES,
             dict(schedule={})),
            ("drift", drift_fn, LOOP_CYCLES,
             dict(refresh_trigger="drift",
                  shift_after_rows=DRIFT_SHIFT_ROWS))):
        fired0 = registry.count("health/feature_drift")
        tmp = tempfile.mkdtemp(prefix="chip_smoke24b-")
        try:
            ctl = RefreshController(dict(DRIFT_PARAMS), fn, num_features=28,
                                    work_dir=tmp, **DRIFT_KW, **kw)
            rep, wall, learners, _, k1, _, _ = run_loop(
                hist_mod, ctl, cycles, "24b " + tag)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        fired = registry.count("health/feature_drift") - fired0
        reps[tag] = rep
        out["phase24b_" + tag] = k1
        check(rep["ok"], "24b %s: problems %s" % (tag, rep["problems"]))
        if tag == "control":
            check(rep["drift_psi_max"] < thr and fired == 0,
                  "24b control: PSI %.4f (threshold %.2f), feature_drift "
                  "fired %d times on an unshifted stream"
                  % (rep["drift_psi_max"], thr, fired))
        else:
            check(rep["drift_psi_max"] >= thr and fired >= 1
                  and rep["drift_triggered_refreshes"] >= 1,
                  "24b drift: PSI %.4f (threshold %.2f), feature_drift "
                  "fired %d, drift-triggered refreshes %d"
                  % (rep["drift_psi_max"], thr, fired,
                     rep["drift_triggered_refreshes"]))
        log("24b %s, %d cycles of %d rows (31 leaves): outcomes %s; "
            "drift PSI max %.4f (threshold %.2f) in %d windows, detected "
            "in window %s, %d drift-triggered refreshes, feature_drift "
            "fired %d; refresh %.3f s a cycle, serve p99 %.3f ms; %d rows "
            "served in %.1f s; K1 launches %d; %s"
            % (tag, cycles, DRIFT_ROWS,
               [c["outcome"] for c in rep["cycles"]], rep["drift_psi_max"],
               thr, rep["drift_windows"], rep["drift_detect_windows"],
               rep["drift_triggered_refreshes"], fired,
               rep["refresh_cycle_seconds"],
               rep["serve_p99_during_refresh_ms"],
               rep["traffic"]["rows_ok"], wall, k1, card))
    return out


def phase_refresh_loop(lgb, hist_mod, card):
    """Phase 24 under the refresh SLO of the JAX package's refresh bench
    (``LOOP_SLO_ENV`` set, then restored). Returns K1's launches by
    path."""
    old = os.environ.get(LOOP_SLO_ENV)
    os.environ[LOOP_SLO_ENV] = LOOP_SLO_MS
    log("phase 24: %s=%s (bench.py:1050)" % (LOOP_SLO_ENV, LOOP_SLO_MS))
    try:
        out = phase24_rotation(lgb, hist_mod, card)
        out.update(phase24_drift(lgb, hist_mod, card))
    finally:
        if old is None:
            os.environ.pop(LOOP_SLO_ENV, None)
        else:
            os.environ[LOOP_SLO_ENV] = old
    return out


# ---------------------------------------------------------------------------
# phase 25: the CLI and the C ABI on the card
# ---------------------------------------------------------------------------
CLI_ROWS = 1 << 20
CLI_TREES = 5
CAPI_ROWS = 1 << 18
CLI_RANK_ROWS = 1 << 18
CLI_RANK_ROUNDS = 2
CLI_EXAMPLES = (("binary_classification", "binary."),
                ("regression", "regression."),
                ("multiclass_classification", "multiclass."),
                ("lambdarank", "rank."))
#: rows of a block the TSV writer's processes format at once
TSV_BLOCK = 1 << 16


def _format_rows(block: np.ndarray) -> str:
    import io
    buf = io.StringIO()
    np.savetxt(buf, block, delimiter="\t", fmt="%.9g")
    return buf.getvalue()


def write_tsv(path: str, y: np.ndarray, X: np.ndarray) -> None:
    """The label in column 0, then the features, ``%.9g`` (f32 values
    round-trip), formatted by one process per core in blocks."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    data = np.column_stack([y.astype(np.float64), X.astype(np.float64)])
    blocks = [data[lo:lo + TSV_BLOCK]
              for lo in range(0, data.shape[0], TSV_BLOCK)]
    workers = max(min(8, os.cpu_count() or 1, len(blocks)), 1)
    with ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn")) as pool, \
            open(path, "w") as fh:
        for text in pool.map(_format_rows, blocks):
            fh.write(text)


def cli(args, what, env=None, timeout=900):
    """``python -m lightgbm_tpu_torch.application`` with ``args`` in a
    subprocess from the checkout's root; fails the run on a non-zero
    exit. Returns its wall seconds and output."""
    here = os.path.dirname(os.path.abspath(__file__))
    run_env = dict(os.environ if env is None else env)
    run_env["PYTHONPATH"] = here + os.pathsep + run_env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "lightgbm_tpu_torch.application"] + list(args),
                          cwd=here, env=run_env, capture_output=True,
                          text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, "%s: the CLI exited %d:\n%s\n%s"
          % (what, proc.returncode, proc.stdout[-3000:], proc.stderr[-3000:]))
    return secs, proc.stdout + proc.stderr


def cli_train_summary(path, what, trees):
    """The one ``cli_train_done`` event that a CLI ``task=train`` wrote
    to its event log ``path``: checks its tree count and that its own K1
    launches (counted from the task's start) == roots + steps. Returns
    the event."""
    with open(path) as fh:
        done = [json.loads(ln) for ln in fh if '"cli_train_done"' in ln]
    check(len(done) == 1, "%s: %d cli_train_done events in the CLI's "
          "event log" % (what, len(done)))
    d = done[0]
    k1 = d["launches"].get("histogram_f32", 0)
    check(d["trees"] == trees and k1 == d["roots"] + d["steps"] > 0,
          "%s: the CLI's own K1 launches %d, roots %d + steps %d, trees %d "
          "(want %d); launches %s" % (what, k1, d["roots"], d["steps"],
                                      d["trees"], trees, d["launches"]))
    return d


def _kv(params):
    return ["%s=%s" % kv for kv in params.items()]


def phase25_train_predict(lgb, hist_mod, tmp, card):
    """25a: a CLI_ROWS x 28 Higgs-shaped TSV, label in column 0; the CLI's
    ``task=train`` (255 leaves, CLI_TREES trees, on the card) gives the
    model text (trees and importances) of ``lgb.train`` run here on the
    card over the same parsed rows; the CLI's own K1 launches (its
    ``cli_train_done`` event) and the in-process run's each == roots +
    steps; the CLI's ``task=predict`` equals ``Booster.predict`` within
    1e-9. Returns (model path, parsed rows, K1 launches of the CLI, of
    the in-process run)."""
    import torch
    from lightgbm_tpu_torch.application import _load_tabular
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.native import parse_dense
    X, y = make_higgs_like(CLI_ROWS, seed=25)
    path = os.path.join(tmp, "higgs.tsv")
    t0 = time.perf_counter()
    write_tsv(path, y, X)
    t_write = time.perf_counter() - t0
    params = dict(SLICE_PARAMS, num_leaves=255)
    model = os.path.join(tmp, "higgs_model.txt")
    event_log = os.path.join(tmp, "higgs_train_events.jsonl")
    t_cli, _ = cli(["task=train", "data=" + path, "output_model=" + model,
                    "num_trees=%d" % CLI_TREES] + _kv(params), "25a train",
                   env=dict(os.environ, LIGHTGBM_TPU_EVENT_LOG=event_log))
    done = cli_train_summary(event_log, "25a train", CLI_TREES)
    k1_cli = done["launches"]["histogram_f32"]
    t0 = time.perf_counter()
    Xp, yp, _, _ = _load_tabular(path, Config.from_params({}))
    t_parse = time.perf_counter() - t0
    hist_mod.reset_launch_counts()
    t0 = time.perf_counter()
    bst = lgb.train(dict(params), lgb.Dataset(Xp, label=yp),
                    num_boost_round=CLI_TREES)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    dev = check_device_launches(hist_mod, bst, "histogram_f32",
                                "25a lgb.train on the parsed rows")
    with open(model) as fh:
        cli_text = fh.read()
    check(cli_text.split("parameters:")[0]
          == bst.model_to_string().split("parameters:")[0],
          "25a: the CLI's model differs from lgb.train's on the same rows")
    preds = os.path.join(tmp, "higgs_preds.tsv")
    t_pred, _ = cli(["task=predict", "data=" + path, "input_model=" + model,
                     "output_result=" + preds, "verbosity=-1"],
                    "25a predict")
    got = parse_dense(preds, "\t", 0)[:, 0]
    want = bst.predict(Xp)
    err = float(np.max(np.abs(got - want)))
    check(got.shape == want.shape and err <= 1e-9,
          "25a: the CLI's predictions differ from Booster.predict by %.3g"
          % err)
    log("25a CLI on the card, %d x 28 TSV (%d MB, written in %.1f s): "
        "task=train %.2f s in its process (its task: load %.2f s, train "
        "%.2f s of %d trees, its own K1 %d == roots %d + steps %d; outside "
        "its task, i.e. interpreter, imports, card context, save, exit: "
        "%.2f s) == "
        "lgb.train's text (here: parse %.2f s, train %.2f s, K1 %d); "
        "task=predict %.2f s in its process, max |diff| %.3g vs "
        "Booster.predict; %s"
        % (CLI_ROWS, os.path.getsize(path) >> 20, t_write, t_cli,
           done["load_seconds"], done["train_seconds"], CLI_TREES, k1_cli,
           done["roots"], done["steps"],
           t_cli - done["load_seconds"] - done["train_seconds"], t_parse,
           t_train,
           dev["histogram_f32"], t_pred, err, card))
    return model, Xp, k1_cli, dev["histogram_f32"]


def phase25_examples(lgb, hist_mod, tmp, card):
    """25b: the four ``examples/*/train.conf`` trained through the CLI on
    the card (four processes at once), each test-set prediction equal to
    ``lgb.train``'s on the same conf within 1e-9 (the JAX package's
    ``tests/test_consistency.py``); each CLI's own K1 launches (its
    ``cli_train_done`` event) == roots + steps, with the API run's trees,
    roots and steps. Returns K1's launches of the CLI runs and of the
    API runs."""
    from lightgbm_tpu_torch.application import (_load_tabular, _sidecar,
                                                parse_args)
    from lightgbm_tpu_torch.config import Config
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    runs = []
    t0 = time.perf_counter()
    for directory, prefix in CLI_EXAMPLES:
        d = os.path.join(here, "examples", directory)
        model = os.path.join(tmp, directory + ".txt")
        event_log = os.path.join(tmp, directory + "_events.jsonl")
        argv = ["config=" + os.path.join(d, "train.conf"),
                "data=" + os.path.join(d, prefix + "train"),
                "valid_data=" + os.path.join(d, prefix + "test"),
                "output_model=" + model, "verbosity=-1"]
        runs.append((directory, prefix, d, model, event_log, argv,
                     subprocess.Popen(
            [sys.executable, "-m", "lightgbm_tpu_torch.application"] + argv,
            cwd=here, env=dict(env, LIGHTGBM_TPU_EVENT_LOG=event_log),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    try:
        logs = [r[-1].communicate(timeout=600)[0] for r in runs]
    finally:
        for r in runs:
            if r[-1].poll() is None:
                r[-1].kill()
                r[-1].wait()
    t_cli = time.perf_counter() - t0
    launches, launches_cli, gaps = 0, 0, {}
    for (directory, prefix, d, model, event_log, argv, proc), text in zip(
            runs, logs):
        check(proc.returncode == 0, "25b %s: the CLI exited %d:\n%s"
              % (directory, proc.returncode, text[-3000:]))
        params = parse_args(argv)
        cfg = Config.from_params(params)
        api_params = {k: v for k, v in params.items()
                      if k not in ("config", "task", "data", "valid",
                                   "valid_data", "output_model",
                                   "num_trees", "num_iterations")}
        X, y, w, g = _load_tabular(os.path.join(d, prefix + "train"), cfg)
        g = g if g is not None else _sidecar(
            os.path.join(d, prefix + "train"), "query")
        hist_mod.reset_launch_counts()
        api = lgb.train(api_params, lgb.Dataset(X, label=y, weight=w,
                                                group=g,
                                                params=api_params),
                        num_boost_round=int(cfg.num_iterations))
        dev = hist_mod.device_launch_counts()
        st = api.inner.learner.grow_stats
        check(dev["histogram_f32"] == st["roots"] + st["steps"],
              "25b %s: K1 %d != roots + steps" % (directory,
                                                  dev["histogram_f32"]))
        launches += dev["histogram_f32"]
        done = cli_train_summary(event_log, "25b " + directory,
                                 len(api.inner.models))
        check((done["roots"], done["steps"]) == (st["roots"], st["steps"]),
              "25b %s: the CLI's roots %d, steps %d; the API's %d, %d"
              % (directory, done["roots"], done["steps"], st["roots"],
                 st["steps"]))
        launches_cli += done["launches"]["histogram_f32"]
        Xt, _, _, _ = _load_tabular(os.path.join(d, prefix + "test"), cfg)
        mine = lgb.Booster(model_file=model).predict(Xt)
        theirs = api.predict(Xt)
        gaps[directory] = float(np.max(np.abs(mine - theirs)
                                       / np.maximum(np.abs(theirs), 1e-3)))
        check(np.allclose(mine, theirs, rtol=1e-9, atol=1e-12),
              "25b %s: CLI and API test-set predictions differ (max "
              "relative %.3g)" % (directory, gaps[directory]))
    log("25b the four examples/*/train.conf through the CLI on the card "
        "(4 processes, %.1f s): test-set predictions == lgb.train's within "
        "1e-9 (max relative gaps %s); the CLIs' own K1 %d, the API runs' "
        "K1 %d, each == roots + steps; %s"
        % (t_cli, gaps, launches_cli, launches, card))
    return launches_cli, launches


def compile_c_example(out_path: str):
    """Start ``g++`` on ``examples/c_api/main.c`` with the port's
    ``capi.cpp`` (its include of ``capi.h`` pointed at the port's copy,
    the same file as the JAX package's); returns the process."""
    from lightgbm_tpu_torch import native
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "examples", "c_api", "main.c")) as fh:
        text = fh.read()
    include = '#include "../../lightgbm_tpu/native/capi.h"'
    check(include in text, "25c: main.c's capi.h include changed")
    src = out_path + ".c"
    with open(src, "w") as fh:
        fh.write(text.replace(include, '#include "capi.h"'))
    return subprocess.Popen(
        ["g++", "-O2", "-std=c++17", "-I",
         os.path.dirname(native.source_path("capi.h")), "-o", out_path, src,
         native.source_path("capi.cpp"), "-lm"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def phase25_capi(lgb, tmp, model, Xp, gxx, card):
    """25c: 25a's model in the port's ``_capi.so`` (built from
    ``lightgbm_tpu_torch/native/capi.cpp``):
    ``LGBM_BoosterPredictForMat`` on CAPI_ROWS rows == the port's host
    walk within rtol 1e-12; rows/s of both beside the stacked predict's
    on the card; then ``examples/c_api/main.c``, compiled with the port's
    ``capi.cpp`` (``gxx``, started at the phase's start), predicts 1000
    rows from a CSV equal to ``Booster.predict`` within 1e-10."""
    from lightgbm_tpu_torch.native.capi import NativeBooster
    X = np.ascontiguousarray(Xp[:CAPI_ROWS])
    nb = NativeBooster(model_file=model)
    bst = lgb.Booster(model_file=model)
    native, t_native = timed(lambda: nb.predict(X)[:, 0])
    host, t_host = timed(lambda: bst.predict(X, predict_on_device=False))
    bst.predict(X[:4096])
    stacked, t_stacked = timed(lambda: bst.predict(X))
    check(np.allclose(native, host, rtol=1e-12, atol=0),
          "25c: the C API's predictions differ from the host walk (max "
          "relative %.3g)" % float(np.max(np.abs(native - host)
                                          / np.abs(host))))
    check(np.array_equal(stacked, host),
          "25c: the stacked predict differs from the host walk")
    out, _ = gxx.communicate(timeout=600)
    check(gxx.returncode == 0, "25c: g++ failed on main.c:\n%s" % out)
    feats = os.path.join(tmp, "features.csv")
    np.savetxt(feats, X[:1000], delimiter=",", fmt="%.17g")
    run = subprocess.run([gxx.args[gxx.args.index("-o") + 1], model, feats],
                         capture_output=True, text=True, timeout=300)
    check(run.returncode == 0, "25c: main.c exited %d:\n%s"
          % (run.returncode, run.stderr[-2000:]))
    preds_c = np.array([float(v) for v in run.stdout.split()])
    check(np.allclose(preds_c, bst.predict(X[:1000]), rtol=1e-10, atol=0),
          "25c: main.c's predictions differ from Booster.predict")
    log("25c C ABI (the port's capi.cpp): LGBM_BoosterPredictForMat on "
        "%d rows == the host walk within rtol 1e-12 (max relative %.3g): "
        "%.0f rows/s; host walk %.0f rows/s; stacked predict on the card "
        "%.0f rows/s (byte-equal to the host walk); examples/c_api/main.c "
        "built with the port's capi.cpp: 1000 rows == Booster.predict "
        "within 1e-10 (%s); %s"
        % (CAPI_ROWS, float(np.max(np.abs(native - host) / np.abs(host))),
           CAPI_ROWS / t_native, CAPI_ROWS / t_host, CAPI_ROWS / t_stacked,
           run.stderr.strip().splitlines()[0] if run.stderr.strip()
           else "", card))


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase25_ranks(lgb, hist_mod, tmp, card):
    """25d: two CLI ranks (``num_machines=2``, a shared machine list,
    ``pre_partition=false``) on the one card over a CLI_RANK_ROWS-row
    TSV: the layout rule picks gloo (two ranks share one card); each
    rank's ``dtrain_done`` event (its event log) has K1 launches ==
    roots + steps and no capture; rank 0's model text (trees) equals the
    in-process 2-shard data learner of 23d (``learner_on``) over the same
    two rank-strided row sets, with every row sampled for the mappers.
    Returns K1's launches by path."""
    import torch
    from lightgbm_tpu_torch.application import _load_tabular
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.parallel import Mesh
    X, y = make_higgs_like(CLI_RANK_ROWS, seed=26)
    path = os.path.join(tmp, "ranks.tsv")
    write_tsv(path, y, X)
    ports = [_free_port(), _free_port()]
    mlist = os.path.join(tmp, "mlist.txt")
    with open(mlist, "w") as fh:
        fh.write("".join("127.0.0.1 %d\n" % p for p in ports))
    model = os.path.join(tmp, "ranks_model.txt")
    # verbosity 1: each rank logs its backend and why (the CLI keeps the
    # first value of a key, so SLICE_PARAMS' -1 stays out)
    params = {k: v for k, v in SLICE_PARAMS.items() if k != "verbosity"}
    params.update(num_leaves=255, bin_construct_sample_cnt=CLI_RANK_ROWS,
                  tree_learner="data")
    argv = _kv(params) + [
        "task=train", "data=" + path, "num_trees=%d" % CLI_RANK_ROUNDS,
        "num_machines=2", "machine_list_file=" + mlist,
        "pre_partition=false", "output_model=" + model, "verbosity=1"]
    here = os.path.dirname(os.path.abspath(__file__))
    procs, events = [], []
    t0 = time.perf_counter()
    try:
        for r, port in enumerate(ports):
            env = dict(os.environ)
            env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
            env["LIGHTGBM_TPU_DTRAIN_TIMEOUT_S"] = "300"
            env["LIGHTGBM_TPU_EVENT_LOG"] = os.path.join(
                tmp, "events%d.jsonl" % r)
            events.append(env["LIGHTGBM_TPU_EVENT_LOG"])
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "lightgbm_tpu_torch.application"]
                + argv + ["local_listen_port=%d" % port], cwd=here, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    t_ranks = time.perf_counter() - t0
    out = {}
    for r, (p, text) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, "25d rank %d exited %s:\n%s"
              % (r, p.returncode, text[-4000:]))
        check("rank %d of 2 over gloo (2 ranks on this host share" % r
              in text, "25d rank %d: no gloo layout line:\n%s"
              % (r, text[-2000:]))
        with open(events[r]) as fh:
            done = [json.loads(ln) for ln in fh if '"dtrain_done"' in ln]
        check(len(done) == 1, "25d rank %d: %d dtrain_done events"
              % (r, len(done)))
        d = done[0]
        k1 = d["launches"]["histogram_f32"]
        check(k1 == d["roots"] + d["steps"]
              and sum(d["launches"].values()) == k1 and d["captures"] == 0
              and d["roots"] == d["trees"] == CLI_RANK_ROUNDS,
              "25d rank %d: K1 %d, roots %d + steps %d, captures %d, "
              "launches %s" % (r, k1, d["roots"], d["steps"], d["captures"],
                               d["launches"]))
        out["phase25d_cli_rank%d" % r] = k1
    Xf, yf, _, _ = _load_tabular(path, Config.from_params({}))
    order = np.concatenate([np.arange(0, CLI_RANK_ROWS, 2),
                            np.arange(1, CLI_RANK_ROWS, 2)])
    ip = dict(SLICE_PARAMS, num_leaves=255,
              bin_construct_sample_cnt=CLI_RANK_ROWS)
    ds = lgb.Dataset(Xf[order], label=yf[order], params=ip).construct()
    valid = lgb.Dataset(Xf[:4096], label=yf[:4096], reference=ds).construct()
    with learner_on(Mesh([torch.device("cuda", 0)] * 2)):
        inproc = train_path(lgb, hist_mod, ds, valid,
                            dict(ip, tree_learner="data"), "histogram_f32",
                            CLI_RANK_ROUNDS, tag="25d in-process", per_root=2,
                            per_step=2)
    out["phase25d_in_process_2shards"] = inproc["launches"]["histogram_f32"]
    with open(model) as fh:
        theirs = fh.read().split("end of trees")[0]
    mine = inproc["booster"].model_to_string().split("end of trees")[0]
    check(mine == theirs, "25d: rank 0's trees differ from the in-process "
          "2-shard learner's")
    log("25d two CLI ranks (pre_partition=false, a shared machine list) "
        "over gloo on one card, %d rows: %.1f s for both processes "
        "(start, parse, binning, %d rounds); rank 0's trees == the "
        "in-process 2-shard learner's; each rank's K1 == roots + steps "
        "(%s), no capture; %s"
        % (CLI_RANK_ROWS, t_ranks, CLI_RANK_ROUNDS,
           {k: v for k, v in out.items() if "rank" in k}, card))
    return out


def phase_cli(lgb, hist_mod, card):
    """Phase 25: the native libraries built (``g++``; main.c with the
    port's capi.cpp started beside them), then 25a-d. Returns K1's
    launches by path."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from lightgbm_tpu_torch import native
    from lightgbm_tpu_torch.native import capi
    tmp = tempfile.mkdtemp(prefix="chip_smoke25-")
    gxx = None
    try:
        t0 = time.perf_counter()
        gxx = compile_c_example(os.path.join(tmp, "c_api_example"))
        with ThreadPoolExecutor(2) as pool:
            for f in [pool.submit(native.parser_lib),
                      pool.submit(capi.load_lib)]:
                f.result()
        log("phase 25: native parser and C API built with g++ in %.1f s"
            % (time.perf_counter() - t0))
        model, Xp, k1_cli, k1_api = phase25_train_predict(
            lgb, hist_mod, tmp, card)
        out = {"phase25a_cli": k1_cli,
               "phase25a_lgb_train_same_rows": k1_api}
        (out["phase25b_examples_cli"],
         out["phase25b_examples_api"]) = phase25_examples(lgb, hist_mod,
                                                          tmp, card)
        phase25_capi(lgb, tmp, model, Xp, gxx, card)
        del Xp
        out.update(phase25_ranks(lgb, hist_mod, tmp, card))
    finally:
        if gxx is not None and gxx.poll() is None:
            gxx.kill()
            gxx.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def time_widths(hist_mod, widths, rows_out):
    """Every instance at the new widths' root shapes (the real bins of
    phases 9 and 10) and at children of 10k, 100k and 1M rows (fewer
    than the root), each beside its bound, plain and library times;
    appended to each instance's row of the kernels line."""
    import torch
    for label, bins, B in widths:
        S = bins.shape[0]
        g = torch.Generator(device="cuda")
        g.manual_seed(12)
        gh = torch.stack([torch.randn(S, generator=g, device="cuda"),
                          torch.rand(S, generator=g, device="cuda"),
                          torch.ones(S, device="cuda"),
                          torch.ones(S, device="cuda")], dim=1).contiguous()
        gh8 = torch.randint(-127, 128, (S, 4), generator=g, device="cuda",
                            dtype=torch.int32).to(torch.int8)
        q16 = (2 ** 31 - 1) // S
        gh16 = torch.randint(-q16, q16 + 1, (S, 4), generator=g,
                             device="cuda", dtype=torch.int32).to(
            torch.int16)
        children = [sub_index(S, n, seed=n) for n in (10_000, 100_000,
                                                       1_000_000) if n < S]
        for row in rows_out:
            tag = row["name"].rsplit("_", 1)[1]
            if row["bins"] != str(bins.dtype):
                continue
            rows_gh = {"f32": gh, "f64": gh, "i8": gh8, "i16": gh16}[tag]
            f64 = tag == "f64"
            times = [dict(width=label, S=S, Fp=bins.shape[1], B=B,
                          **time_histogram(hist_mod, bins, rows_gh, B,
                                           row["name"], f64=f64))]
            for idx in children:
                times.append(dict(width=label, S=idx.shape[0],
                                  Fp=bins.shape[1], B=B, child=True,
                                  **time_histogram(hist_mod, bins, rows_gh,
                                                   B, row["name"], idx,
                                                   f64=f64)))
            row.setdefault("widths", []).extend(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,"
                            "18,19,20,21,22,23,24,25",
                    help="comma-separated subset of phases to run")
    ap.add_argument("--dtrain-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dtrain-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",") if p}
    if phases & {19, 23}:
        phases |= {4, 7}
    if 20 in phases:
        phases.add(4)
    if 21 in phases:
        phases.add(12)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "lightgbm_tpu_torch")):
        print("chip_smoke: lightgbm_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    if args.dtrain_rank is not None:
        # one rank of phase 23d, started by the phase itself
        return dtrain_rank(args.dtrain_rank, args.dtrain_dir)
    from lightgbm_tpu_torch import csrc
    from lightgbm_tpu_torch.ops import histogram as hist_mod

    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(label: str) -> None:
        now = time.perf_counter()
        log("%s seconds: %.1f" % (label, now - t_lap[0]))
        t_lap[0] = now
    card, name = phase_device_and_build(csrc)
    lap("phase 1")
    errs = dict.fromkeys(hist_mod.launch_counts, 0.0)
    if 2 in phases:
        errs = phase_kernels(hist_mod)
        phase_wide_kernels(hist_mod, errs)
        phase_device_count_entry(hist_mod)
        lap("phase 2")
    import lightgbm_tpu_torch as lgb
    # launches of each kernel on each path that runs it
    by_path = {k: {} for k in hist_mod.launch_counts}
    if 3 in phases:
        run = phase_small(lgb, hist_mod, {}, "histogram_f32", 1e-3)
        by_path["histogram_f32"]["phase3_small_binary"] = \
            run["histogram_f32"]
        lap("phase 3")
    data = (full_data(lgb, keep_head=bool(phases & {15, 16, 19, 22, 23}))
            if phases & {4, 7, 14, 15, 16, 17, 18, 19, 20, 22, 23}
            else None)
    bins_root, f32_auc = None, None
    # phase 4's and 7's trees, AUCs and seconds per iteration (phase 19)
    looped = {}
    if 4 in phases:
        bst, run, aucs, per_iter = phase_full(lgb, hist_mod, data)
        f32_auc = aucs[-1]
        looped["f32"] = (bst.inner.models, aucs, per_iter)
        by_path["histogram_f32"]["phase4_higgs_binary"] = \
            run["histogram_f32"]
        bins_root = bst.inner.learner.bins
        del bst
        lap("phase 4 (with the full-size binning)")
    rows = None
    if 5 in phases:
        if bins_root is None:
            g = torch.Generator(device="cuda")
            g.manual_seed(3)
            bins_root = torch.randint(0, 255, (FULL_ROWS, 32), generator=g,
                                      device="cuda", dtype=torch.int32
                                      ).to(torch.uint8)
        rows = phase_timing(hist_mod, bins_root, 256, errs)
        time_scan()
        lap("phase 5")
    del bins_root
    if 6 in phases:
        phase_quantize()
        lap("phase 6")
    if 7 in phases:
        run, trees, aucs, per_iter = phase_full_quantized(
            lgb, hist_mod, data, f32_auc)
        looped["8bit"] = (trees, aucs, per_iter)
        by_path["histogram_i8"]["phase7_higgs_binary_8bit"] = \
            run["histogram_i8"]
        lap("phase 7")
    # phase 16 bins phase 4's training rows again (phase 15 drops them)
    wdata = None
    if 16 in phases:
        paths, wdata = phase_wide(lgb, hist_mod, data, errs, rows)
        for kernel, counts in paths.items():
            by_path[kernel].update(counts)
        lap("phase 16 (with the max_bin 1023 binning)")
    if 17 in phases:
        for kernel, counts in phase_f64(lgb, hist_mod, data, wdata).items():
            by_path[kernel].update(counts)
        lap("phase 17 (higgs)")
    del wdata
    if 18 in phases:
        by_path["histogram_f32"].update(phase_boosting(lgb, hist_mod, data))
        lap("phase 18 (dart, rf)")
    if 14 in phases:
        for kernel, paths in phase_sampling(lgb, hist_mod, data).items():
            by_path[kernel].update(paths)
        lap("phase 14")
    if 15 in phases:
        for kernel, paths in phase_constraints(lgb, hist_mod, data).items():
            by_path[kernel].update(paths)
        lap("phase 15")
    if 19 in phases:
        for kernel, paths in phase_surface(lgb, hist_mod, data,
                                           looped).items():
            by_path[kernel].update(paths)
        lap("phase 19")
    if 20 in phases:
        for kernel, paths in phase_observability(lgb, hist_mod, data,
                                                 looped).items():
            by_path[kernel].update(paths)
        lap("phase 20")
    if 22 in phases:
        for kernel, paths in phase_out_of_core(lgb, hist_mod,
                                               data).items():
            by_path[kernel].update(paths)
        lap("phase 22")
    if 23 in phases:
        for kernel, paths in phase_parallel(lgb, hist_mod, data,
                                            looped).items():
            by_path[kernel].update(paths)
        lap("phase 23")
    HEAD.clear()
    del data, looped
    if 8 in phases:
        run = phase_small(lgb, hist_mod,
                          {"use_quantized_grad": True, "quant_grad_bits": 16,
                           "bagging_fraction": 0.8, "bagging_freq": 1},
                          "histogram_i16", None, rounds=1)
        by_path["histogram_i16"]["phase8_small_16bit_bagging"] = \
            run["histogram_i16"]
        lap("phase 8")
    widths = []
    if 9 in phases:
        run, (bins, bg) = phase_covertype(lgb, hist_mod)
        by_path["histogram_f32"]["phase9_covertype_bundled"] = \
            run["phase9_covertype_bundled"]
        by_path["histogram_i8"]["phase9_covertype_bundled_8bit"] = \
            run["phase9_covertype_bundled_8bit"]
        widths.append(("covertype bundles Gp=%d Bg=%d" % (bins.shape[1],
                                                         bg), bins, bg))
        lap("phase 9")
    if 13 in phases:
        run, (bins, b) = phase_covertype_categorical(lgb, hist_mod)
        by_path["histogram_f32"].update(run)
        widths.append(("covertype categorical Fp=%d" % bins.shape[1], bins,
                       b))
        lap("phase 13")
    if 10 in phases:
        n, bins = phase_mslr(lgb, hist_mod)
        by_path["histogram_f32"]["phase10_mslr_lambdarank_xendcg"] = n
        widths.append(("mslr Fp=136", bins, 256))
        lap("phase 10")
    if rows is not None and widths:
        time_widths(hist_mod, widths, rows)
        lap("kernel timing at the widths of phases 9, 10 and 13")
    del widths
    if 11 in phases:
        by_path["histogram_f32"]["phase11_other_objectives"] = \
            phase_other_objectives(lgb, hist_mod)
        lap("phase 11")
    if 12 in phases:
        by_path["histogram_f32"].update(phase_predict(lgb, hist_mod))
        lap("phase 12")
    if 21 in phases:
        phase_serving(lgb)
        lap("phase 21")
    if 17 in phases:
        by_path["histogram_f64"].update(phase_f64_covertype(lgb, hist_mod))
        lap("phase 17 (covertype)")
    if 18 in phases:
        phase_refit(lgb)
        lap("phase 18 (refit)")
    if 24 in phases:
        by_path["histogram_f32"].update(phase_refresh_loop(lgb, hist_mod,
                                                           card))
        lap("phase 24")
    if 25 in phases:
        by_path["histogram_f32"].update(phase_cli(lgb, hist_mod, card))
        lap("phase 25")
    if rows is not None:
        for row in rows:
            row["launches_by_path"] = by_path[row["name"]]
            row["launches"] = sum(by_path[row["name"]].values())
        if phases >= {2, 4, 5, 16, 17}:
            check(len(rows) == len(hist_mod.launch_counts)
                  and all(row["launches"] > 0 for row in rows),
                  "an instance is not timed or was launched by no path: %s"
                  % {row["name"]: row["launches"] for row in rows})
        log(json.dumps({"kernels": rows}))
    log("chip_smoke seconds: %.1f" % (time.perf_counter() - t_start))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
