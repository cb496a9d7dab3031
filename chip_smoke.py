#!/usr/bin/env python3
"""Drive the PyTorch port (``tf2_gnn_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py            # the check, on card 0
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of
                                     # each path's train step

Phases, each of which fails the run by raising:

1. Build the hand-written CUDA kernels from ``tf2_gnn_tpu_torch/csrc``
   (one nvcc per source, started together) and the C++ host engine
   (``tf2_gnn_tpu_torch/native/graphpack.cc``, g++; the phase fails if it
   does not build), and print the card.
2. PPI_RGCN on the per-type-plan PPI batch:
   a. kernel checks at the real plan shapes: the joint SpMM (K2, over the
      forward plan's compact form) and the stream SpMM (K1, over the
      backward plan's, all-zero types) against their plain PyTorch versions
      (over the plan arrays) on the card, bf16 tables, f32 outputs; two
      launches of each bit-equal;
   b. the shipped PPI_RGCN model at full width (4 layers, hidden 320, bf16
      edge stream, input dropout 0.1, Adam at lr 1e-3), random weights
      from a seed: one eval forward held against the same model run
      through the plain versions; then its main path, a few train steps
      with the launch counts set to 0 just before and read just after
      (K1 and K2 must each launch once per layer per step; PPI's plan
      reads 0.977 of its tables' rows, so the tables stay whole: every row
      computed and no node sum launched, ``PPI_NODE_SUMS``);
   c. timings (CUDA events): each kernel, its plain version and one
      PyTorch library call computing the same function
      (``torch.sparse.mm``, CSR built from the plan outside the timed
      window), the train step and the eval forward; for the row owners
      (K1, K2, B3-B12, B14, B15, P1, P2), P3 and the library calls also the
      device time (torch.profiler over 20 launches, at the end of the run,
      after every path's step time; ``--profile`` traces each path's steps
      as it goes).
3. PPI_RGAT on the merged-plan PPI batch, the same three steps:
   a. the expd kernel (B8, over the plan's forward compact form, by entry,
      against the plain version at the form's slots), one head's
      merged-plan SpMM (B3, over the same form, reading B8's output by
      entry as the main path does and, in its other form, a scale by
      slot) and the fused attention backward (B9, over the backward plan's
      two compact forms; also at K = 4, H = 576 and 1024, its tiled form)
      against their plain versions at the real plan shapes, each launch
      bit-equal to a second, with the compact forms' sizes;
   b. the shipped PPI_RGAT model at full width (3 layers, hidden 320, 4
      heads, tanh, bf16 edge stream, input dropout 0.1, Adam at lr 1e-3):
      the eval forward against the plain versions, then its main path
      (per step B8 and B9 launch once per layer, B3 once per head and
      layer); then one layer of it at hidden 576 (4 heads of 144, wider
      than B9's register row) on the same batch, which has no scatter
      plans: its eval forward against the plain versions, and one train
      step through B8, B10 and B9, once each;
   c. timings as in 2c (B3's library call is ``torch.sparse.mm`` of the
      expd-scaled CSR; B8 and B9 have no single PyTorch call; B3's by-slot
      form is logged).
4. The reference-default GNN_Edge_MLP (target-state input, one hidden
   edge-MLP layer, GRU global exchange after layer 2) on the merged-target
   PPI batch, the same three steps:
   a. the relu-pair kernels B4 (training forward, R and the mask sum M)
      and B6 (eval forward, R), one row owner over the forward plan's
      compact form, B5 (dA, a row owner by A's row over the backward plan's
      compact form) and B7 (dB = M times g, the forward row owner's third
      mode over B4's form, on no call path) against their plain versions
      at the real plan shapes, each launch bit-equal to a second: bf16 A
      and B, f32 cotangent, unit scales;
   b. ``workloads.edge_mlp_default_params()`` at full width (4 layers,
      hidden 320, bf16 edge stream, Adam at lr 1e-3): the eval forward
      against the plain versions (B6 once per layer, B4 and B5 never),
      then its main path (per step B4 and B5 once per layer, B6 and B7
      never);
   c. timings as in 2c (none of the four has a single PyTorch call).
5. The scatter-plan PPI batch (``bench.py``'s ``"sorted"`` path), two
   models on one batch, the same three steps:
   a. the sorted-scatter kernels against their plain versions at the real
      plan shapes, in all their call forms: B13 in forward (f32 [245760,
      320] into the 8064 target rows) and backward layout (f32 [311296,
      320] into the 24192 source rows); B12 over the plan's compact forms,
      each form bit-equal across two launches: the stream form (a bf16
      [311296, 324] stream, R = 128), the gathered form (``plan_gather_src``'s
      gradient: a bf16 [245760, 324] cotangent read through
      ``bwd_to_fwd_idx``) and the typed form (an f32 [245760, 4] stream,
      R = 384); B14 and B15 over the forward compact form (B14: f32 expd
      and a strided f32 message view; B15: f32 logits, exactly), each two
      launches bit-equal;
   b. ``workloads.rgcn_sorted_params()`` (PPI_RGCN as the bench's sorted
      path runs it: 4 layers, hidden 320, f32 edge stream) and the shipped
      PPI_RGAT on its sorted fallback: each model's eval forward against
      the plain versions (RGCN: B13 once per layer; RGAT: B15 and B14 once
      per layer, B12 never), then 5 train steps (per step RGCN's B13 twice
      per layer; RGAT's B15 and B14 once per layer, B12 twice per layer);
      no kernel of phases 2-4 launches;
   c. timings as in 2c; the library calls are ``torch.sparse.mm`` of the
      plan's [rows, slots] CSR (B12's stream and typed forms, B13), of the
      [rows, forward slots] CSR (B12's gathered form) and one
      ``scatter_reduce_`` (B15); B14 has none. Every form (B12's three,
      B13's two, B14 and B15) also gets its device time.
6. RGAT on the per-type-plan PPI batch of phase 2 (one launch of each
   attention kernel per edge type), the same three steps:
   a. the max kernel (B11) over the forward compact form against its
      plain version, exactly, on the largest type's plan (bf16 [8064, 8]
      scores; also starting from an ``init``, as the per-type forward
      chains its launches) and on the merged plan of phase 3 (bf16
      [24192, 8]), two launches bit-equal; the hk-major aggregation
      kernel (B10) over the plan's forward compact form in its two call
      forms (K = 8, H = 64 and K = 4, H = 512; bf16 table, B8's f32
      expd by entry, as the main path reads it), two launches bit-equal;
      B8 on the same plan at both models' head counts (K = 4 and 8, by
      entry, two launches bit-equal); B9 on the same plan at the two
      models' shapes (K = 4, H = 320 and K = 8, H = 64), two launches
      bit-equal;
   b. the shipped PPI_RGAT with the ``"exact"`` stabiliser (per step
      B11, B8 and B9 once per type and layer, B3 once per head, type and
      layer) and ``workloads.rgat_eight_heads_params()`` (GAT's 8 heads of
      8 features: B8, B10 and B9 once per type and layer): each model's
      eval forward against the plain versions, then 5 train steps; no
      kernel of phases 2-5 launches;
   c. timings as in 2c; B11's library call is one ``scatter_reduce_`` of
      the per-slot logits; B10 has none (it would take K sparse products);
      B11 and B10 also get their device times; B9 and B8 at the two
      shapes of 6a, B11's merged form and B10's second form are logged.
7. The shipped QM9_RGCN on the QM9-shaped batch (``bench.py::measure_qm9``'s:
   909 molecules, 5 edge types on per-type pair plans, V = 16384):
   a. K2 and K1 against their plain versions at the QM9 plan's shapes
      (bf16 [81920, 128] tables, a [16384, 128] cotangent), two launches
      of each bit-equal; then the three launches over the forms of a
      table of only the rows the plan reads (``check_read_rows_kernels``:
      K2 over ``ReadRows.fwd_rows``, K1 over ``read_bwd_rows`` with a bf16
      cotangent, the node sum over ``ReadRows.node_rows`` of an f32 table)
      against their plain twin over the form, two launches of each
      bit-equal, each timed;
   b. ``workloads.qm9_shipped_params()`` at full width (8 layers, hidden
      128, bf16 edge stream, RMSProp, clipping by value at 1.0), whose
      plan reads fewer than half its tables' rows (0.467), so the tables
      hold only those rows (``GNN_Edge_MLP.compact_rows``; K2 and K1 over
      those rows' forms, the plain twin over the form as their plain
      version): the eval forward against the plain versions (K2 once per
      layer, nothing else), then 5 train steps (per step K2, K1 and the
      node sum of the products' input gradient once per layer, no other
      kernel, and ``table_rows_share`` below 0.5);
   c. timings as in 2c at this shape (logged; K1 and K2 keep their phase
      2 entries), the train step, the eval forward and molecules/s.
8. The design probes at their own shapes: P1 (8 chunks a group) and P2
   (one) through B3's kernel on the probe's plans of the PPI edges merged
   over 3 types (bf16 [24192, 384] table), against B3's plain version and
   the probe's own ``np.add.at`` check, two launches bit-equal; P3 in f32
   and bf16 at 8192 x 128 x 64 shifts (its shared form, the form logged)
   against its plain version, bit for bit, and two launches bit-equal. Their
   run is the phase's main path: each launch count set to 0 just before
   each probe and read just after. Timings as in 2c; the library calls are ``torch.sparse.mm`` of
   the plan's CSR (P1, P2) and one ``torch.gather`` over all the shifted
   index sets, then a sum (P3); P1, P2 and P3 (both dtypes) also get
   their device times.
9. Four more shipped PPI configurations on the per-type-plan PPI batch of
   phase 2 (built once more, with its per-type in-degrees):
   a. K1 in the per-type op's two call forms (``StreamTypedPlan``: the
      forward, f32 [24192, 256] tables into the stacked [24192] outputs
      with global output blocks; the backward, an f32 [24192, 256]
      cotangent whose types' groups read their own slabs, into the
      [24192] table rows), each over its compact form, against the plain
      version, two launches bit-equal, with the forms' sizes;
   b. PPI_GGNN (3 layers, hidden 320, GRU update, bf16, the joint op: K2
      and K1 once per layer and step), PPI_RGIN (5 layers, hidden 256, one
      hidden edge-MLP layer, 1/deg, LayerNorm, bf16, the joint op),
      PPI_GNN_Edge_MLP (target-state input with 0 hidden layers, 5 layers,
      hidden 256, gelu, f32) and PPI_GNN_FiLM (target-state input with 0
      hidden layers, 4 layers, hidden 256, f32), the last two through the
      per-type op (K1 twice per layer and step), each from
      ``workloads.shipped_params`` with Adam at lr 1e-3: the eval forward
      against the plain versions (K2 or K1 once per layer, nothing else),
      then 5 train steps with the launch counts read (no other kernel);
   c. timings: K1's two per-type forms as in 2c (their library call
      ``torch.sparse.mm`` of the form's f32 CSR, with device times; logged,
      K1 keeps its phase 2 entry), each model's train step and eval
      forward.

10. The edge-MLP family on the other plan kinds, and the shipped
    GraphRegression_GNN_Edge_MLP (``ROUTE_MODELS``), on the batches of
    phases 3, 4, 5 and 7 (built once more):
   a. B3 over the merged plan's two directions in the new call forms of
      ``pair_typed_gather_scatter`` (phase 3's plan: bf16 [24192, 320]
      tables into the [8064] targets with the 1/deg scales, and a bf16
      [8064, 320] cotangent into the [24192] table rows; phase 4's
      merged-target plan: f32 [24192, 256] both ways, unit scales) and
      B12's three forms over the scatter plan at the routes' widths (the
      stream form bf16 [245760, 320] and f32 [245760, 256]; the gathered
      form, the same two; the typed form bf16 320, f32 256 and f32 512),
      each over its compact form against its plain version, two launches
      bit-equal;
   b. seven routes, each from its shipped or benchmark configuration at
      full width with random weights from the seed: PPI_RGCN on the
      merged plan (``pair_typed_gather_scatter``: B3 twice per layer and
      step), PPI_GNN_Edge_MLP and PPI_GNN_FiLM on the merged-target plan
      (the factorised forms: B3 twice per layer and step), the
      reference-default GNN_Edge_MLP (``edge_mlp_default_params()``,
      one hidden layer, bf16: B12 five times per layer and step, three
      type-masked stream sums forward), PPI_GNN_Edge_MLP (B12 three
      times) and the source-only PPI_GNN_FiLM (B12 three times) on the
      scatter plan, and GraphRegression_GNN_Edge_MLP on the QM9 batch
      (12 layers, hidden 64: K1 twice per layer and step): the eval
      forward against the plain versions with its launch counts, then 5
      train steps with the launch counts read (no other kernel), the
      train step, eval forward and peak memory;
   c. timings of 10a's forms as in 2c (their library call
      ``torch.sparse.mm`` of the form's CSR, with device times; logged,
      B3 and B12 keep their entries), and the phase's wall time.

11. The unfused per-edge path (``UNFUSED_MODELS``) on the batches without
    plans, the JAX package's default route, at full width with random
    weights from the seed:
   a. PPI_RGCN as ``bench.py``'s ``"xla"`` path (the shipped
      PPI_RGCN.json on ``build_batch(0, use_pallas=False,
      use_pairs=False)``'s arrays), 3 train steps;
   b. the shipped GraphRegression_GNN_Edge_MLP on the QM9 batch without
      plans, its dataset default, 3 train steps;
   c. PPI_RGAT, PPI_GGNN, PPI_RGIN, PPI_GNN_Edge_MLP and PPI_GNN_FiLM on
      the PPI batch without plans, 2 train steps each;
   d. the options without a fused route, 2 train steps each: PPI_RGIN
      with the mean, max and sqrt_n aggregations, PPI_RGCN with the
      activation before the aggregation, the reference-default
      GNN_Edge_MLP with 2 hidden edge-MLP layers.
   Every hand-written kernel's launch count reads 0 over the steps, and
   the losses fall; the eval forward is held against the same weights
   on the batch's per-type-plan form (a-c, a fused route with kernels) or
   against the same model on the CPU (d), over the real rows; each
   model's train step and eval forward are timed beside the fused
   route's, with the peak memory, and the phase's wall time.
12. Training and testing from the command line: PPI files in the DGL
    format (train 6, valid 3, test 3 graphs of 2400 nodes and 34,000
    forward links, 50 features, 121 labels) and QM9 files in JSONL (1776,
    888 and 888 molecules of 18 nodes, 11 bonds of each of 4 raw types,
    32 features, one target), written from the seed
    (``workloads.write_ppi_files`` / ``write_qm9_files``) under
    ``build/phase12``; then, through the train entry's own
    ``cli/train.py::run`` in this process (``CLI_RUNS``):
   a. ``RGCN PPI`` on the shipped PPI_RGCN.json (4 layers, hidden 320,
      bf16 edge stream, per-type plans at V = 8064, 64 overflow slots a
      type), 2 epochs;
   b. ``RGCN QM9`` on QM9_RGCN.json (8 layers, hidden 128, RMSProp,
      V = 16000), 2 epochs;
   c. ``GGNN PPI --gnn_use_remat True --gnn_dense_dtype bfloat16``, 1
      epoch;
   d. the test entry's ``cli/test.py::run`` on (a)'s and (b)'s best
      checkpoints, whose TEST metric must equal the saved weights' in
      memory;
   e. for each run, its dataset's ``num_batches(fold)`` against the
      batches the fold's epoch yields: their count on VALIDATION and
      TEST, and on TRAIN the count of the epoch drawn from the ``rng``
      state ``num_batches`` started from, which it must leave where that
      epoch leaves it.
   Each train epoch's launch counts (set to 0 just before it, read just
   after) must be K1 one a layer and step and K2 one (two under remat),
   every other kernel 0; losses finite; on the first TRAIN batch of (a)
   and (b) the eval forward is held against the plain versions at phase
   2's and phase 7's tolerances. Batches are packed and planned by the
   C++ engine (``native``); every batch of the first epoch is finalised
   once more on the numpy forms (``native.numpy_forms()``) and must be
   array-identical, plans included; a batch planned without the binding
   fails the phase. Logged per run: the host ms a batch of packing and
   planning (and the first epoch's both ways), the planners that planned
   each batch (the binding, or the numpy planner where a plan spilled),
   the first TRAIN batch's ``.to(device)``, joint plan and its compact
   forms, the edges each batch spilled into its overflow slots, each
   epoch's graphs/s and step spans, the peak memory and the wall time.
13. The TF reference's own recorded runs on the card
    (``tests/fixtures/reference_dumps``, through
    ``harness/reference_parity.py``; f32 products without TF32, asserted):
   a-c. for each of the eight dumps (``reference_parity.CASES``), twice:
      on the batch without plans (the unfused route) and on the plan kind
      of the flavour's fused route (per-type pair plans: K2 and K1 for
      RGCN, GGNN and RGIN, K1 both ways for GNN-FiLM and the 12-layer
      target-state GNN_Edge_MLP; RGAT's merged pair plan: B8, B3 and B9).
      The dump's data through the port's loaders with its
      ``dataset_params`` and an f32 edge stream, the first VALIDATION
      batch checked against the dump's; the dump's weights imported
      (``import_reference_weights``, nothing left unmatched); one eval
      forward and one backward with the launch counts set to 0 just
      before and read just after (``REFERENCE_LAUNCHES`` a layer on the
      fused route, none without plans); each layer's representation, the
      final representations, the task output, the loss and every gradient
      held to the dump at the parity test's tolerances (rtol 2e-4 + atol
      1e-4; loss rtol 5e-4; gradients 5e-3 of each tensor's largest
      entry). One line a run: the route, the launches and each largest
      error as a share of its limit;
   d. the public API at full width: a ``GNNInput`` of phase 12's 3
      VALIDATION PPI graphs through ``batch_from_gnn_input`` and ``GNN``
      at PPI_RGCN's width (f32 stream), one forward and one backward on
      the unfused route (no kernel), held over the real rows against the
      same encoder on the dataset's batch of those graphs (K2, K1), its
      relu keeping that run's signs; a relu input the two runs put on
      opposite sides of 0 must lie within the states' tolerance of it;
   e. the input-feature hook at full width: a subclass of PPI_RGCN whose
      ``compute_initial_node_features`` scales the features by
      ``HOOK_FACTOR``, 5 train steps on phase 2's batch (K1 and K2 once a
      layer and step, the joint plan built once for the batch), its eval
      logits bit-equal to the base model's with the same weights on the
      batch transformed beforehand; its train step timed beside phase
      2's, with the card's name and power limit.
14. Scale-out on the card (``tf2_gnn_tpu_torch/parallel``): ranks are
    processes started with ``spawn`` (``parallel.launch.run_ranks``, a
    ``TIMEOUT`` of 600 s; a rank that raises fails the phase) over gloo on this
    one card, CUDA tensors staged through the host by the collectives
    (logged); every case held against one process on the same card (the
    unpartitioned graph, or the same batches combined as the parallel
    step combines them), input dropout 0, random weights from the seed:
   a. DP, PPI_RGCN at full width on two ranks, each on its own bench
      batch (seeds 0 and 1), 3 steps: loss and every parameter after
      each step against the single process's graph-weighted gradient;
   b. SPMD of the scaling workload (``workloads.scaling_partition``:
      RGIN, hidden 256, 4 layers, bf16, merged pair plans; 4096 nodes
      and 131,072 edges a shard) on two ranks, 3 steps, on the dense and
      the forced ring halo (B3 both ways over the ext rows);
   c. SPMD of the PPI batch at PPI_RGCN's width on per-type plans with
      RCM reordering (K1/K2), 2 steps, the eval forward restored to the
      node order (``restore_node_order``);
   d. PPI_RGAT on a merged plan (B8, B3, B9), the reference-default
      GNN_Edge_MLP on a merged-target plan (B4-B6), and RGCN on scatter
      plans with ``halo=False`` (the all_gather; B13), each at its
      shipped width with 2 layers, 2 steps;
   e. hybrid 2 x 2 on four ranks: PPI_RGCN at hidden 320, 2 layers, 2
      steps, on two replicas of a graph of ``HYBRID_NODES`` nodes with
      uniform random edges, so that half the messages cross the halo
      (per-type plans, ring halo, no reorder); then again with every
      ring slab zeroed on arrival (a planted fault), which the check
      must refuse;
   f. one rank over NCCL in this process: one DP step of PPI_RGCN.
   Cases (a)-(d) run on one cluster of two ranks, (e) on one of four.
   Losses, step-1 gradients and eval logits within each case's own
   ``limits`` (a and f: ``DP_LOSS_RTOL``, ``DP_PARAM_ATOL``), set from
   its readings on the card with room on both sides; every rank's parameters
   equal rank 0's; each fused case launches its kernels on every rank
   (``SCALEOUT_KERNELS``). One line a case: the route and halo form, the
   launches per rank, the collectives' calls and bytes a step, the step
   ms of each rank and each largest error against its limit. Also
   ``gather_scatter_sorted`` (B12 both ways over a dual plan) once
   against its plain version.

Each phase logs its wall time, and a line before those below the
script's. The line before the last two is the JSON ``kernels`` line (all
eighteen kernels); then the card's name and power limit (nvidia-smi); the
last line is the JSON result. Exits non-zero, printing no result, without
a card or without the repository beside this script.
"""
import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

TRAIN_STEPS = 5          # main-path train steps (launch counts read after)
TIMED_STEPS = 20         # train steps in the step-time window
KERNEL_REPS = 20         # launches per kernel timing
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 peak outside the tensor cores
# Kernel vs plain version: both sum f32 products, in different orders
# (the atomics of B13 reorder run to run; the row owners K1, K2, B3-B7,
# B9, B10, B12 and B14 keep one order); B8/B9 take expf of the same f32
# arguments as torch.exp. The maxes B11 and B15 match exactly.
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-4
# Whole model, kernels vs plain versions: besides the f32 reorder, a sum
# that lands on the other side of a bf16 rounding boundary re-rounds one
# stream entry by a bf16 ulp in the next layer.
MODEL_ATOL = 2e-2
# The GNN_Edge_MLP model at random weights sums unit-scaled relu messages,
# so its logits reach about a hundred; a re-rounded bf16 entry (2**-8
# relative) then moves a logit by a share of its size, not by a fixed
# amount: the bound grows by 2e-2 (5 bf16 ulps) of the largest |logit|
# (observed up to 1.3 ulps on an H100).
EDGE_MLP_LOGIT_RTOL = 2e-2
LOSS_RTOL = 1e-3
# Phase 6's RGAT models (and phase 3b's wide layer) at random weights give
# logits below 0.1, where a
# fixed 2e-2 would pass a mis-scaled attention sum: their check allows 1e-4
# plus one bf16 ulp (2**-8) of the largest |logit|, and 1e-5 of the loss
# (observed on an H100: 2e-5 of logits up to 8.8e-2, 1.8e-7 of the loss).
TYPED_RGAT_ATOL, TYPED_RGAT_LOGIT_RTOL = 1e-4, 2.0 ** -8
TYPED_RGAT_LOSS_RTOL = 1e-5
# Phase 7's QM9_RGCN: 8 bf16-stream layers with LayerNorm, where an f32
# sum in another order re-rounds a stream entry by a bf16 ulp, which the
# later layers carry on and LayerNorm amplifies. On the CPU at 120
# molecules (tests/test_torch_chip_smoke.py), K2's slots summed in a
# random order move the outputs by 2.8e-3 of the largest |output| (4.0e-2
# of 14.5) and the loss by 1.5e-4, and one edge type's scales doubled by
# 0.74 of it; on an H100 the kernel's outputs were 4.9e-2 (of 14.2) from
# the plain version's. So outputs within 1e-4 plus 2**-5 of the largest
# |output|, the loss within 3e-3.
QM9_ATOL, QM9_LOGIT_RTOL, QM9_LOSS_RTOL = 1e-4, 2.0 ** -5, 3e-3
# Phase 9's models, kernels vs plain versions: (atol, share of the largest
# |logit|, loss rtol). On the CPU, at the PPI batch cut to 3 graphs of 600
# nodes and 8500 forward edges (V = 1920, the same mean in-degree) and at
# 150 / 1500 (tests/test_torch_chip_smoke.py), stand-ins for K1 and K2
# that sum the same slots in a random order move the logits of the
# f32-stream models (PPI_GNN_Edge_MLP, PPI_GNN_FiLM) by at most 1.6e-5 of
# the largest |logit| (8.9e-5 of 5.6) and their loss not at all: they
# differ only by the order of f32 sums, so 1e-4 plus 2**-12 of the largest
# |logit|, and 1e-5 of the loss. The bf16-stream models re-round a stream
# entry that a sum in another order puts across a bf16 rounding boundary,
# and later layers carry it: PPI_GGNN (3 layers, unnormalised sums) by up
# to 1.6e-3 of the largest |logit| (5.4e-3 of 3.4), PPI_RGIN (5 layers,
# LayerNorm, as QM9) by up to 2.2e-3 (9.0e-3 of 4.1), the loss by 2.5e-6:
# 1e-4 plus 2**-7 (GGNN) and 2**-6 (RGIN) of the largest |logit|, and 1e-4
# of the loss. One edge type's scales doubled moves each model's logits by
# 0.78-1.1 of the largest and its loss by 2e-3 to 4e-2, which each check
# catches.
F32_STREAM_TOLS = (1e-4, 2.0 ** -12, 1e-5)
GGNN_TOLS = (1e-4, 2.0 ** -7, 1e-4)
RGIN_TOLS = (1e-4, 2.0 ** -6, 1e-4)
# Phase 8: the probe's shapes (dyngather_probe.py: R, C, shifts; the
# pair probe's feature width) and its own check's limit on the
# rel-max error (f32 sums in another order).
DYNGATHER_SHAPE = (8192, 128, 64)
PROBE_H = 384
PROBE_CHECK_RTOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def require_card():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card.", file=sys.stderr)
        raise SystemExit(2)
    return torch.device("cuda", 0)


def _self_device_us(event) -> float:
    # The attribute's name changed across torch versions.
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0))


def device_ms(fn, reps: int = KERNEL_REPS):
    """The device time of one call of ``fn``: the time torch.profiler
    records for the CUDA kernels (and copies) of ``reps`` calls, divided by
    ``reps``; None where the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(_self_device_us(e) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False))
    return us / reps / 1e3 if us > 0 else None


def add_device_times(entries, tries: int = 3) -> None:
    """The device times of the entries that ``time_kernel`` marked
    (``device_ms``, ``library_device_ms``), measured after every path's step
    time: the profiler's tracing, once started, may slow the host's later
    launches. A kernel's window that reads below its bound has lost
    records (seen on an H100: 0.0003 ms against a bound of 0.0062) and is
    measured again, up to ``tries`` windows in all."""
    for entry in entries:
        if "_device_calls" not in entry:
            continue
        label, source_fn, lib_fn = entry.pop("_device_calls")
        for i in range(tries):
            entry["device_ms"] = device_ms(source_fn)
            if entry["device_ms"] is None \
                    or entry["device_ms"] >= entry["bound_ms"]:
                break
            log(f"device time: {label}: window {i + 1} read "
                f"{entry['device_ms']} ms, below the bound; measured again")
        entry["library_device_ms"] = (None if lib_fn is None
                                      else device_ms(lib_fn))
        log(f"device time: {label}: kernel {entry['device_ms']} ms, library "
            f"call {entry['library_device_ms']} ms")


def plain_version(plain):
    """``plain`` under its wrapper's signature: the plan's compact forms,
    which only the kernel reads, are dropped, and with them the by-entry
    layout (``by_entry``): B8's plain version writes its expd by slot, and
    B3's and B10's read it so."""
    def call(*args, compact=None, ts_rows=None, by_entry=False, **kwargs):
        return plain(*args, **kwargs)
    return call


def rows_plain_version(tables, scale, compact, out_rows):
    """The plain twin of K1 and K2 over a form alone (a joint plan's read
    rows' forms, ``pair_spmm_stream_rows`` / ``_joint_rows``) under their
    wrappers' signature."""
    from tf2_gnn_tpu_torch.ops import pair_spmm as ps

    return ps.slot_rows_plain(tables, scale, compact)


def joint_patches():
    """K2 and K1 on the pair-joint route, each wrapper with its plain
    version: the plan-array wrappers, and the wrappers over the forms of
    tables that hold only the rows the plan reads."""
    from tf2_gnn_tpu_torch.ops import pair_spmm as ps

    plain = plain_version(ps.pair_spmm_stream_plain)
    return [(ps, "pair_spmm_stream_joint", plain),
            (ps, "pair_spmm_stream", plain),
            (ps, "pair_spmm_stream_joint_rows", rows_plain_version),
            (ps, "pair_spmm_stream_rows", rows_plain_version)]


def table_rows_share(name: str, whole: bool) -> float:
    """The pair-joint route's table rows computed over those of whole
    tables since the last ``tracing.reset()`` (the counters
    ``pair_tables.*``), held to what the path's batch should take: 1.0
    where ``whole`` (a plan that reads nearly all its tables' rows, as
    PPI's 0.977), else below 0.5 (QM9's, 0.467)."""
    from tf2_gnn_tpu_torch.utils import tracing

    rows = tracing.counters("pair_tables")
    share = rows["rows_computed"] / rows["rows_full"]
    if (share != 1.0) if whole else not share < 0.5:
        raise AssertionError(
            f"{name}: the tables computed {share:.4f} of their rows; "
            f"expected {'all' if whole else 'fewer than half'}")
    return share


def check_repeatable(name: str, fn, first) -> None:
    """A second launch of ``fn`` gives ``first`` (a tensor or a tuple of
    them) bit for bit (a kernel whose sums keep one order on every run)."""
    import torch

    second = fn()
    torch.cuda.synchronize()
    pairs = (zip(first, second) if isinstance(first, tuple)
             else ((first, second),))
    for i, (x, y) in enumerate(pairs):
        if not torch.equal(x, y):
            raise AssertionError(
                f"{name}: two launches differ in output {i} (max abs diff "
                f"{float((x - y).abs().max())})")


def time_ms(fn, reps: int = KERNEL_REPS, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
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


def stream_args(plan, direction: str):
    """The plan arrays one kernel reads, per direction of the joint op."""
    if direction == "fwd":
        return (plan.scale_fwd, plan.rel_src_f, plan.rel_tgt_f,
                plan.src_blk_f, plan.grp_tgt_fl, plan.grp_type_f)
    return (plan.scale_bwd, plan.rel_src_b, plan.rel_tgt_b, plan.src_blk_b,
            plan.grp_tgt_b, plan.type_b_zeros)


def slot_matrix(srcabs, tgtabs, valid, scale, out_rows: int, in_rows: int):
    """CSR [out_rows, in_rows] of a plan's valid slots (duplicates summed)
    in f32 and in bf16, the operands of the library yardstick; also the
    distinct input rows and the valid slot count."""
    import torch

    idx = torch.stack([tgtabs[valid], srcabs[valid]])
    coo = torch.sparse_coo_tensor(idx, scale.reshape(-1)[valid],
                                  (out_rows, in_rows)).coalesce()
    csr = coo.to_sparse_csr()
    csr_bf16 = torch.sparse_coo_tensor(
        coo.indices(), coo.values().to(torch.bfloat16),
        (out_rows, in_rows)).coalesce().to_sparse_csr()
    return (csr, csr_bf16, int(torch.unique(srcabs[valid]).numel()),
            int(valid.sum()))


def bound_ms(nbytes: float, flops: float):
    """(bound ms, what bounds it): the larger of the bytes over HBM
    bandwidth and the f32 operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_bound_ms(rows_read: int, h: int, itemsize: int,
                    valid_slots: int, out_rows: int):
    """The SpMM's bound (K1, K2, B3, P1, P2), counting what the function
    needs, whatever implements it: bytes = the distinct table rows read,
    8 B a valid slot (its source index and scale), 4 B an output row
    pointer and the f32 output written once; operations = a multiply and
    an add per valid slot and column."""
    nbytes = (rows_read * h * itemsize + valid_slots * 8
              + (out_rows + 1) * 4 + out_rows * h * 4)
    return bound_ms(nbytes, 2.0 * valid_slots * h)


def check_outputs(name: str, fn, want) -> float:
    """A row owner (B4-B6, B9): ``fn()`` against the plain version's
    output or outputs ``want`` (a tensor or a tuple), and bit-equal across
    two launches. Returns the max abs error."""
    import torch

    got = fn()
    torch.cuda.synchronize()
    pairs = (zip(got, want) if isinstance(got, tuple)
             else ((got, want),))
    err = max(check_close(f"{name} output {i}", x, y, KERNEL_RTOL,
                          KERNEL_ATOL)
              for i, (x, y) in enumerate(pairs))
    check_repeatable(name, fn, got)
    return err


def check_close(name: str, got, want, rtol: float, atol: float) -> float:
    import torch

    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {err}, rtol {rtol}, atol {atol})")
    return err


def model_from_params(params, device, num_types: int, name: str):
    """The model of ``params`` on the card, random weights from the seed."""
    from tf2_gnn_tpu_torch.models.node_multiclass_task import (
        NodeMulticlassTask,
    )
    from tf2_gnn_tpu_torch.workloads import FEATURE_DIM, NUM_LABELS

    model = NodeMulticlassTask.from_params(
        params, input_dim=FEATURE_DIM, num_edge_types=num_types,
        device=device, seed=SEED, num_labels=NUM_LABELS)
    log(f"model {name}: {sum(p.numel() for p in model.parameters())} "
        f"parameters, {params['gnn_num_layers']} layers, hidden "
        f"{params['gnn_hidden_dim']}, edge stream {params['gnn_edge_dtype']}")
    return model


def check_eval_forward(model, batch, labels, patches,
                       logit_rtol: float = 0.0, atol: float = MODEL_ATOL,
                       loss_rtol: float = LOSS_RTOL, shape=None) -> None:
    """One eval forward with the kernels against the same model with every
    wrapper in ``patches`` ((module, name, plain version)) replaced by its
    plain version: logits (or a graph task's outputs, of ``shape``) within
    ``atol`` plus ``logit_rtol`` of the largest plain |logit|, losses within
    ``loss_rtol``."""
    import torch

    with torch.no_grad():
        out = model(batch, False)
        with _patched(patches):
            out_plain = model(batch, False)
    check_outputs_agree("kernels vs plain versions", model, batch, labels,
                        out, out_plain, logit_rtol, atol, loss_rtol, shape)


def check_outputs_agree(what: str, model, batch, labels, out, out_ref,
                        logit_rtol: float, atol: float, loss_rtol: float,
                        shape=None, ref_batch=None, ref_labels=None,
                        rows=None) -> None:
    """Two eval forwards' outputs (``out`` on ``batch``, ``out_ref`` on
    ``ref_batch``, by default the same) within ``atol`` plus
    ``logit_rtol`` of the largest reference |logit|, over the first
    ``rows`` rows (by default all), their losses within ``loss_rtol``;
    the outputs finite and of ``shape`` (by default [V, labels])."""
    import torch

    from tf2_gnn_tpu_torch.workloads import NUM_LABELS

    shape = shape or (batch.num_nodes_padded, NUM_LABELS)
    ref_batch = batch if ref_batch is None else ref_batch
    ref_labels = labels if ref_labels is None else ref_labels
    with torch.no_grad():
        loss = model.compute_task_metrics(batch, out, labels)["loss"]
        loss_ref = model.compute_task_metrics(ref_batch, out_ref,
                                              ref_labels)["loss"]
    logits = out[0] if isinstance(out, tuple) else out
    logits_ref = out_ref[0] if isinstance(out_ref, tuple) else out_ref
    if tuple(logits.shape) != tuple(shape):
        raise AssertionError(f"eval forward: outputs of shape "
                             f"{tuple(logits.shape)}, expected {tuple(shape)}")
    logits_ref = logits_ref.to(logits.device)[:rows]
    finite = bool(torch.isfinite(logits).all())
    logits = logits[:rows]
    model_err = float((logits - logits_ref).abs().max())
    largest = float(logits_ref.abs().max())
    limit = atol + logit_rtol * largest
    if not (finite and model_err <= limit
            and abs(float(loss) - float(loss_ref))
            <= loss_rtol * abs(float(loss_ref))):
        raise AssertionError(
            f"eval forward: {what} max abs logit err "
            f"{model_err} (limit {limit}: atol {atol} + {logit_rtol} of the "
            f"largest |logit| {largest}), loss {float(loss)} vs "
            f"{float(loss_ref)} (rtol {loss_rtol})")
    log(f"eval forward, {what}: max abs logit err {model_err:.3e} "
        f"(limit {limit:.3e}, largest |logit| {largest:.3e}), loss "
        f"{float(loss):.6f} vs {float(loss_ref):.6f}")


def _patched(patches):
    from contextlib import ExitStack

    stack = ExitStack()
    for module, name, plain in patches:
        stack.enter_context(mock.patch.object(module, name, plain))
    return stack


def train_and_count(model, params, batch, labels, expected,
                    steps: int = TRAIN_STEPS):
    """The path's main run: ``steps`` train steps with every launch count
    set to 0 just before and read just after; each kernel in ``expected``
    must have launched exactly that many times, and the loss must fall
    over more than one step. Returns (state, train_step, eval_step,
    launches)."""
    import torch

    from tf2_gnn_tpu_torch.harness.optimizers import make_optimizer
    from tf2_gnn_tpu_torch.harness.training import (
        create_train_state,
        make_eval_step,
        make_train_step,
    )
    from tf2_gnn_tpu_torch.utils import tracing

    optimizer = make_optimizer(params, model.parameters())
    state = create_train_state(model, optimizer, seed=SEED)
    train_step = make_train_step(model, optimizer)
    eval_step = make_eval_step(model)

    tracing.reset()
    losses = []
    for _ in range(steps):
        state, metrics = train_step(state, batch, labels)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    launches = tracing.counters("launch")
    losses = [float(x) for x in losses]
    log(f"train: {steps} steps, losses {losses}, launches {launches}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if steps > 1 and not losses[-1] < losses[0]:
        raise AssertionError(f"training did not lower the loss: {losses}")
    for name, count in expected.items():
        if launches[name] != count:
            raise AssertionError(
                f"{name} launched {launches[name]} times in {steps} steps; "
                f"expected {count}")
    final = eval_step(batch, labels)
    if not math.isfinite(float(final["loss"])):
        raise AssertionError("non-finite eval loss after training")
    log(f"eval after training: loss {float(final['loss']):.6f}"
        + (f", f1 {float(final['f1_score']):.4f}" if "f1_score" in final
           else ""))
    return state, train_step, eval_step, launches


# Node sums (``pair_spmm_node_rows``, launch count ``node_rows``) a layer
# and train step on the pair-joint route over the PPI batches of phases 2,
# 9, 12, 13d and 13e: none, since their plans read 0.977 of the tables'
# rows, above ``COMPACT_TABLES_BELOW``, and the tables stay whole. (QM9's
# batches, in phases 7 and 12, read 0.467: one, the products' input
# gradient summed by node.) A test that cuts the PPI batches to a few
# small graphs, whose plans read fewer of the rows, sets it to 1.
PPI_NODE_SUMS = 0

# Train step ms by path name (``time_path``), for later phases to compare.
STEP_MS = {}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def time_path(state, train_step, eval_step, batch, labels, real_edges,
              device, argv, name: str, steps: int = TIMED_STEPS):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = train_step(state, batch, labels)
    float(metrics["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    eval_ms = time_ms(lambda: eval_step(batch, labels), reps=10)
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    STEP_MS[name] = step_ms
    log(f"{name} train step: {step_ms:.3f} ms ({real_edges / step_ms * 1e3:.4g} "
        f"edges/s), eval forward: {eval_ms:.3f} ms, peak memory "
        f"{peak_gib:.2f} GiB")
    if "--profile" in argv:
        profile_step(train_step, state, batch, labels, step_ms)
    return step_ms, eval_ms


def rgcn_path(device, argv):
    """Phase 2: PPI_RGCN through K1 and K2. Returns their kernel entries."""
    import torch

    from tf2_gnn_tpu_torch.workloads import build_ppi_batch, shipped_params

    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    batch, labels, real_edges = build_ppi_batch(SEED, device=device)
    log(f"workload: {real_edges} edges, V={batch.num_nodes_padded}, "
        f"built in {time.perf_counter() - t0:.1f} s")
    plan = batch.pair_stream_joint
    checked = check_stream_kernels(plan, 320, device)

    params = shipped_params("PPI_RGCN.json", "rgcn")
    model = model_from_params(params, device, plan.num_types,
                              "PPI_RGCN.json")
    check_eval_forward(model, batch, labels, joint_patches())
    per_step = params["gnn_num_layers"] * TRAIN_STEPS
    state, train_step, eval_step, launches = train_and_count(
        model, params, batch, labels,
        {"pair_stream": per_step, "pair_stream_joint": per_step,
         "node_rows": per_step * PPI_NODE_SUMS,
         "pair_attention_max": 0, "pair_attention_agg": 0})
    table_rows_share("PPI_RGCN", whole=True)
    time_path(state, train_step, eval_step, batch, labels, real_edges,
              device, argv, "PPI_RGCN")

    return stream_kernel_entries(plan, checked, launches)


def check_stream_kernels(plan, h: int, device):
    """K2 (forward layout) and K1 (backward layout, all-zero types) on
    ``plan``'s streamed layout, each over its compact form, against their
    plain versions, with bf16 [L*V, h] tables and a bf16 [V, h] cotangent
    from the seed; each bit-equal across two launches. Returns (tables,
    cot, {name: (kernel, plain version)}, {name: max abs err})."""
    import torch

    from tf2_gnn_tpu_torch.ops import pair_spmm as ps

    v, num_types = plan.v_out, plan.num_types
    gen = torch.Generator(device=device).manual_seed(SEED)
    tables = torch.randn((num_types * v, h), generator=gen,
                         device=device).to(torch.bfloat16)
    cot = torch.randn((v, h), generator=gen, device=device).to(torch.bfloat16)
    fwd_args, bwd_args = stream_args(plan, "fwd"), stream_args(plan, "bwd")
    fns = {
        "pair_stream_joint": (
            lambda: ps.pair_spmm_stream_joint(tables, *fwd_args, v, v,
                                              compact=plan.fwd_rows),
            lambda: ps.pair_spmm_stream_plain(tables, *fwd_args, v, v)),
        "pair_stream": (
            lambda: ps.pair_spmm_stream(cot, *bwd_args, v, num_types * v,
                                        compact=plan.bwd_rows),
            lambda: ps.pair_spmm_stream_plain(cot, *bwd_args, v,
                                              num_types * v)),
    }
    errs = {}
    for name, (kernel_fn, plain_fn) in fns.items():
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        errs[name] = check_close(name, got, want, KERNEL_RTOL, KERNEL_ATOL)
        check_repeatable(name, kernel_fn, got)
        del got, want
    log(f"kernel check: pair_stream_joint max_abs_err "
        f"{errs['pair_stream_joint']:.3e}, pair_stream max_abs_err "
        f"{errs['pair_stream']:.3e} (rtol {KERNEL_RTOL}, atol "
        f"{KERNEL_ATOL}; each bit-equal across two launches); the compact "
        f"forms: {plan.fwd_rows.src_row.numel()} slots into {v} rows, "
        f"{plan.bwd_rows.src_row.numel()} into {num_types * v}")
    return tables, cot, fns, errs


def check_read_rows_kernels(name: str, plan, h: int, device,
                            timed: bool = False):
    """The three launches of the pair-joint route whose tables hold only
    the rows ``plan`` reads (``plan.read_rows``), each against its plain
    twin over its form (``slot_rows_plain``) at KERNEL_RTOL / KERNEL_ATOL
    and bit-equal across two launches: K2 over ``ReadRows.fwd_rows`` (a
    bf16 [n, h] table, the forward scales), K1 over ``plan.read_bwd_rows``
    (a bf16 [V, h] cotangent, the backward scales) and the node sum
    (``pair_spmm_node_rows``: K1 over ``ReadRows.node_rows``, an f32 [n,
    h] table, every entry at scale 1). With ``timed`` each launch is timed
    (CUDA events, ``KERNEL_REPS`` launches). Logged."""
    import torch

    from tf2_gnn_tpu_torch.ops import pair_spmm as ps

    read = plan.read_rows
    n, v = read.num_rows, plan.v_out
    gen = torch.Generator(device=device).manual_seed(SEED + 29)
    rows = torch.randn((n, h), generator=gen, device=device)
    rows16 = rows.to(torch.bfloat16)
    cot = torch.randn((v, h), generator=gen, device=device).to(torch.bfloat16)
    scale_fwd, scale_bwd = plan.scale_fwd, plan.scale_bwd
    fns = {
        "pair_stream_joint over the read rows": (
            lambda: ps.pair_spmm_stream_joint_rows(rows16, scale_fwd,
                                                   read.fwd_rows, v),
            lambda: ps.slot_rows_plain(rows16, scale_fwd, read.fwd_rows)),
        "pair_stream into the read rows": (
            lambda: ps.pair_spmm_stream_rows(cot, scale_bwd,
                                             plan.read_bwd_rows, n),
            lambda: ps.slot_rows_plain(cot, scale_bwd, plan.read_bwd_rows)),
        "node_rows": (
            lambda: ps.pair_spmm_node_rows(rows, read),
            lambda: ps.slot_rows_plain(rows, None, read.node_rows)),
    }
    notes = []
    for form, (kernel_fn, plain_fn) in fns.items():
        err = check_outputs(f"{name} {form}", kernel_fn, plain_fn())
        notes.append(f"{form} max_abs_err {err:.3e}"
                     + (f", {time_ms(kernel_fn):.4f} ms" if timed else ""))
    log(f"kernel check ({name}, {n} read rows of {plan.num_types * plan.v_src}"
        f", h {h}): " + "; ".join(notes) + f" (rtol {KERNEL_RTOL}, atol "
        f"{KERNEL_ATOL}; each bit-equal across two launches"
        + ("; CUDA events" if timed else "") + ")")


def stream_kernel_entries(plan, checked, launches):
    """Time K2 and K1 on ``plan``'s streamed layout (``checked``, what
    ``check_stream_kernels`` returned) beside their bounds and the library
    yardstick; returns their two entries."""
    import torch

    from tf2_gnn_tpu_torch.ops import pair_spmm as ps

    tables, cot, fns, errs = checked
    v, num_types, h = plan.v_out, plan.num_types, tables.shape[1]
    fwd_args, bwd_args = stream_args(plan, "fwd"), stream_args(plan, "bwd")
    # The library yardstick: torch.sparse.mm of the plan's CSR matrix with
    # the same bf16 table (bf16 output, f32-rounded scales rounded to bf16),
    # and, for reference, with f32 copies of both (the kernel's f32 output).
    a_fwd, a_fwd16, rows_fwd, valid_fwd = slot_matrix(
        *ps._stream_slot_abs_ids(*fwd_args[1:], v), fwd_args[0], v,
        num_types * v)
    a_bwd, a_bwd16, rows_bwd, valid_bwd = slot_matrix(
        *ps._stream_slot_abs_ids(*bwd_args[1:], v), bwd_args[0],
        num_types * v, v)
    tables_f32, cot_f32 = tables.float(), cot.float()
    kernels = []
    for name, lib_fn, lib32_fn, args, tab, out_rows, rows, valid, \
            replaces in (
            ("pair_stream_joint",
             lambda: torch.sparse.mm(a_fwd16, tables),
             lambda: torch.sparse.mm(a_fwd, tables_f32), fwd_args, tables,
             v, rows_fwd, valid_fwd, "tf2_gnn_tpu/ops/pair_spmm.py:1057"),
            ("pair_stream",
             lambda: torch.sparse.mm(a_bwd16, cot),
             lambda: torch.sparse.mm(a_bwd, cot_f32), bwd_args, cot,
             num_types * v, rows_bwd, valid_bwd,
             "tf2_gnn_tpu/ops/pair_spmm.py:895")):
        bound, bound_by = kernel_bound_ms(rows, h, tab.element_size(),
                                          valid, out_rows)
        kernels.append(time_kernel(
            name, "tf2_gnn_tpu_torch/csrc/pair_stream.cu", replaces,
            launches[name], errs[name], *fns[name], lib_fn, lib32_fn,
            bound, bound_by,
            f"[{tab.shape[0]}, {h}] table, {valid} valid of "
            f"{args[1].numel()} slots, {rows} distinct rows read",
            device=True))
    return kernels


def time_kernel(name, source, replaces, launches, err, source_fn, plain_fn,
                lib_fn, lib32_fn, bound, bound_by, detail, device=False):
    """One entry of the kernels line: the kernel, its plain version and
    (where there is one) the library call, timed with CUDA events. With
    ``device`` the kernel's and the library call's device times
    (``device_ms``, ``library_device_ms``), which tell a host-bound wrapper
    from a slow kernel, are added at the end of the run
    (``add_device_times``) from the calls the entry keeps until then."""
    ms = time_ms(source_fn)
    plain_ms = time_ms(plain_fn)
    library_ms = None if lib_fn is None else time_ms(lib_fn)
    line = (f"{name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({bound_by}), {detail}")

    if lib_fn is not None and lib32_fn is None:
        line += f"; library call {library_ms:.4f} ms"
    elif lib_fn is not None:
        library32_ms = time_ms(lib32_fn)
        lib_err = float((lib32_fn() - source_fn()).abs().max())
        line += (f"; torch.sparse.mm bf16 {library_ms:.4f} ms, f32 "
                 f"{library32_ms:.4f} ms (max abs diff to the kernel "
                 f"{lib_err:.2e})")
    log(line)
    entry = {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": library_ms}
    if device:
        entry["_device_calls"] = (f"{name}, {detail}", source_fn, lib_fn)
    return entry


def rgat_path(device, argv):
    """Phase 3: PPI_RGAT through B8, B3 and B9, then one wide layer of it
    (3b) through B8, B10 and B9's tiled form. Returns the entries of B3, B8
    and B9, and B9's at the wide shapes and B3's by-slot form."""
    import torch

    from tf2_gnn_tpu_torch.ops import pair_attention as pa
    from tf2_gnn_tpu_torch.ops import pair_spmm as ps
    from tf2_gnn_tpu_torch.workloads import build_ppi_batch, shipped_params

    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    batch, labels, real_edges = build_ppi_batch(SEED, device=device,
                                                merged=True)
    plan = batch.pair_merged
    v, num_types = batch.num_nodes_padded, batch.num_edge_types
    log(f"workload (merged plans): {real_edges} edges, V={v}, "
        f"{plan.rel_src_f.shape[0]} forward / {plan.rel_src_b.shape[0]} "
        f"backward chunks, {plan.ovf_src.shape[0]} overflow slots, built "
        f"in {time.perf_counter() - t0:.1f} s")
    params = shipped_params("PPI_RGAT.json", "rgat")
    model = model_from_params(params, device, num_types, "PPI_RGAT.json")
    # The kernels' widths on the main path: [L*V, H] hk-major tables with
    # the heads padded to a divisor of 128 (none at 4 heads).
    k = model.gnn.mp_layer_0._padded_heads()
    head_dim = params["gnn_hidden_dim"] // params["gnn_num_heads"]
    h, rows = head_dim * k, num_types * v

    # Kernel inputs at the main path's shapes and dtypes.
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    table = torch.randn((rows, h), generator=gen,
                        device=device).to(torch.bfloat16)
    scores = (0.5 * torch.randn((rows, 2 * k), generator=gen,
                                device=device)).to(torch.bfloat16)
    m = pa._stabilise(pa._bound_stabiliser(scores, v, k), torch.bfloat16)
    dw = torch.randn((v, h), generator=gen, device=device).to(torch.bfloat16)
    d_denom = torch.randn((v, k), generator=gen, device=device)
    compact = plan.fwd_rows(v, rows)
    slot = compact.slot.long()
    expd_want = pa.pair_attention_expd_plain(scores, m, *plan.fwd, v, k)
    head0 = torch.cat([table.reshape(rows, head_dim, k)[:, :, 0],
                       table.new_ones((rows, 1))], dim=1).contiguous()
    # Head 0's scale by slot (the plain version's layout) and by entry of
    # the compact form (B8's, the main path's).
    scale0 = expd_want[0]
    scale0_e = expd_want[0, slot].contiguous()

    def b8():
        return pa.pair_attention_expd(scores, m, *plan.fwd, v, k,
                                      compact=compact)

    def b8_plain():
        return pa.pair_attention_expd_plain(scores, m, *plan.fwd, v,
                                            k)[:, slot]

    def b3():
        return ps.pair_spmm(head0, scale0_e, *plan.fwd, v, compact=compact,
                            by_entry=True)

    def b3_slot():
        return ps.pair_spmm(head0, scale0, *plan.fwd, v, compact=compact)

    def b3_plain():
        return ps.pair_spmm_plain(head0, scale0, *plan.fwd, v)

    bwd_args = (table, dw, d_denom, scores, m, *plan.bwd, v, k)
    bwd_rows, ts_rows = plan.bwd_rows(rows, v), plan.bwd_ts_rows(rows, v, v)

    def b9():
        return pa.pair_attention_bwd_fused(*bwd_args, compact=bwd_rows,
                                           ts_rows=ts_rows)

    def b9_plain():
        return pa.pair_attention_bwd_fused_plain(*bwd_args)

    err8 = check_outputs("pair_attention_expd", b8, b8_plain())
    want3 = b3_plain()
    err3 = check_outputs("pair_spmm", b3, want3)
    err3_slot = check_outputs("pair_spmm by slot", b3_slot, want3)
    del want3
    err9 = check_outputs("pair_attention_bwd_fused", b9, b9_plain())
    # B9 past its register row (its tiled form) on the same plan: K = 4 at
    # H = 576 and 1024, bf16.
    b9_wide = {}
    for hh in (576, 1024):
        table9, dw9 = (torch.randn((rows if i == 0 else v, hh), generator=gen,
                                   device=device).to(torch.bfloat16)
                       for i in range(2))
        args9 = (table9, dw9, d_denom, scores, m, *plan.bwd, v, k)

        def b9w(args9=args9):
            return pa.pair_attention_bwd_fused(*args9, compact=bwd_rows,
                                               ts_rows=ts_rows)

        def b9w_plain(args9=args9):
            return pa.pair_attention_bwd_fused_plain(*args9)

        name9 = f"pair_attention_bwd_fused K = {k}, H = {hh}"
        b9_wide[hh] = (name9, b9w, b9w_plain,
                       check_outputs(name9, b9w, b9w_plain()))
    log(f"kernel check: pair_attention_expd max_abs_err {err8:.3e} (by "
        f"entry, against the plain version at the form's slots), pair_spmm "
        f"max_abs_err {err3:.3e} by entry, {err3_slot:.3e} by slot (compact "
        f"form {compact.src_row.numel()} entries into {v} rows), "
        f"pair_attention_bwd_fused max_abs_err {err9:.3e} (rtol "
        f"{KERNEL_RTOL}, atol {KERNEL_ATOL}; bit-equal across two "
        f"launches; compact forms "
        f"{bwd_rows.src_row.numel()} entries into {rows} source rows from "
        f"{v} dw rows, d_ts {ts_rows.sums.src_row.numel()} entries into "
        f"{rows} rows); " + ", ".join(
            f"{name9} (tiled) max_abs_err {err:.3e}"
            for name9, _, _, err in b9_wide.values()))

    check_eval_forward(model, batch, labels, [
        (ps, "pair_spmm", plain_version(ps.pair_spmm_plain)),
        (pa, "pair_spmm", plain_version(ps.pair_spmm_plain)),
        (pa, "pair_attention_expd",
         plain_version(pa.pair_attention_expd_plain)),
        (pa, "pair_attention_bwd_fused",
         plain_version(pa.pair_attention_bwd_fused_plain))])
    per_step = params["gnn_num_layers"] * TRAIN_STEPS
    state, train_step, eval_step, launches = train_and_count(
        model, params, batch, labels,
        {"pair_attention_expd": per_step, "pair_spmm": k * per_step,
         "pair_attention_bwd_fused": per_step, "pair_stream": 0,
         "pair_stream_joint": 0, "pair_attention_max": 0,
         "pair_attention_agg": 0})
    time_path(state, train_step, eval_step, batch, labels, real_edges,
              device, argv, "PPI_RGAT")
    del model, state, train_step, eval_step
    torch.cuda.empty_cache()
    wide_launches = wide_rgat_step(device, batch, labels)

    # Bounds from this run's plan: the bytes each kernel must move (each
    # input read once, each output written once) and its f32 operations.
    srcabs, tgtabs, valid = ps.slot_abs_ids(*plan.fwd)
    fwd_slots, fwd_chunks = plan.rel_src_f.numel(), plan.src_blk_f.numel()
    fwd_groups = plan.grp_tgt_f.numel()
    fwd_valid = int(valid.sum())
    plan_bytes = fwd_slots * 8 + fwd_chunks * 4 + fwd_groups * 4
    # B8's first port's count, logged beside the recount: the plan, the
    # whole score table and stabiliser, K f32 values a plan slot written.
    b8_old = bound_ms(
        plan_bytes + scores.numel() * 2 + m.numel() * 4 + k * fwd_slots * 4,
        6.0 * fwd_valid * k)[0]
    b8_bound = expd_rows_bound_ms(compact, k, 2, v)
    a_s, a_s16, rows_read, _ = slot_matrix(srcabs, tgtabs, valid, scale0, v,
                                           rows)
    b3_bound = kernel_bound_ms(rows_read, head0.shape[1], 2, fwd_valid, v)
    b_src, b_tgt, b_valid = ps.slot_abs_ids(*plan.bwd)
    bwd_valid = int(b_valid.sum())
    # B9's bound as its first port counted it (12 B a plan slot, the
    # whole score table and stabiliser), logged beside the recount.
    bwd_bytes = (plan.rel_src_b.numel() * 8 + plan.src_blk_b.numel() * 4
                 + plan.grp_tgt_b.numel() * 4
                 + int(torch.unique(b_tgt[b_valid]).numel()) * h * 2
                 + int(torch.unique(b_src[b_valid]).numel()) * h * 2
                 + scores.numel() * 2 + (m.numel() + d_denom.numel()) * 4
                 + rows * (h + 2 * k) * 4)
    b9_old = bound_ms(bwd_bytes, 4.0 * bwd_valid * h)[0]
    b9_bound = b9_bound_ms(bwd_rows, ts_rows, h, k, 2)
    b9_detail = (f"{bwd_valid} valid of {plan.rel_src_b.numel()} slots, "
                 f"[{rows}, {h}] bf16 table, K = {k}")
    head0_f32 = head0.float()
    b3_detail = (f"one head's launch, [{rows}, {head0.shape[1]}] bf16 table, "
                 f"{fwd_valid} valid of {fwd_slots} slots")
    wide_forms = [time_kernel(
        name9, "tf2_gnn_tpu_torch/csrc/pair_attention.cu",
        "tf2_gnn_tpu/ops/pair_attention.py:860",
        wide_launches["pair_attention_bwd_fused"] if hh == 576 else 0, err,
        b9w, b9w_plain, None, None,
        *b9_bound_ms(bwd_rows, ts_rows, hh, k, 2),
        f"K = {k}, bf16 table [{rows}, {hh}], the merged plan, tiled form",
        device=True)
        for hh, (name9, b9w, b9w_plain, err) in b9_wide.items()]
    # B3's other form, a scale by slot (K1's, K2's and the probes' reads
    # through the slot map), is logged.
    wide_forms.append(time_kernel(
        "pair_spmm by slot", "tf2_gnn_tpu_torch/csrc/pair_stream.cu",
        "tf2_gnn_tpu/ops/pair_spmm.py:678", 0, err3_slot, b3_slot,
        b3_plain, None, None, *b3_bound, b3_detail + ", scale by slot",
        device=True))
    return [
        time_kernel("pair_spmm", "tf2_gnn_tpu_torch/csrc/pair_stream.cu",
                    "tf2_gnn_tpu/ops/pair_spmm.py:678", launches["pair_spmm"],
                    err3, b3, b3_plain,
                    lambda: torch.sparse.mm(a_s16, head0),
                    lambda: torch.sparse.mm(a_s, head0_f32), *b3_bound,
                    b3_detail + ", B8's scale by entry", device=True),
        time_kernel("pair_attention_expd",
                    "tf2_gnn_tpu_torch/csrc/pair_stream.cu",
                    "tf2_gnn_tpu/ops/pair_attention.py:427",
                    launches["pair_attention_expd"], err8, b8, b8_plain,
                    None, None, *b8_bound,
                    f"bf16 scores [{rows}, {2 * k}] -> f32 [{k}, "
                    f"{compact.src_row.numel()}] by entry; padded-slot "
                    f"bound count {b8_old:.4f} ms", device=True),
        time_kernel("pair_attention_bwd_fused",
                    "tf2_gnn_tpu_torch/csrc/pair_attention.cu",
                    "tf2_gnn_tpu/ops/pair_attention.py:860",
                    launches["pair_attention_bwd_fused"], err9, b9, b9_plain,
                    None, None, *b9_bound,
                    f"{b9_detail}; padded-slot bound count "
                    f"{b9_old:.4f} ms", device=True),
    ], wide_forms


def wide_rgat_step(device, batch, labels):
    """Phase 3b: one layer of the shipped PPI_RGAT at hidden 576 (4 heads
    of 144, wider than B9's register row) on the merged-plan batch, which
    carries no scatter plans: the reference's gate takes the pair path
    there, with B10 for the sums (a head is wider than a 128-column tile)
    and B9's tiled form. Its eval forward against the plain versions, then
    one train step in which B8, B10 and B9 launch once each. Returns the
    step's launches."""
    import torch

    from tf2_gnn_tpu_torch.ops import pair_attention as pa
    from tf2_gnn_tpu_torch.ops import pair_spmm as ps
    from tf2_gnn_tpu_torch.utils import tracing
    from tf2_gnn_tpu_torch.workloads import shipped_params

    if batch.scatter_merged is not None:
        raise AssertionError("phase 3b needs a batch without scatter plans")
    params = dict(shipped_params("PPI_RGAT.json", "rgat"), gnn_num_layers=1,
                  gnn_hidden_dim=576)
    model = model_from_params(params, device, batch.num_edge_types,
                              "PPI_RGAT.json at hidden 576, one layer")
    patches = [(ps, "pair_spmm", plain_version(ps.pair_spmm_plain)),
               (pa, "pair_spmm", plain_version(ps.pair_spmm_plain))]
    patches += [(pa, name, plain_version(getattr(pa, f"{name}_plain")))
                for name in pa.LAUNCHES]
    check_eval_forward(model, batch, labels, patches, TYPED_RGAT_LOGIT_RTOL,
                       TYPED_RGAT_ATOL, TYPED_RGAT_LOSS_RTOL)
    _, _, _, launches = train_and_count(
        model, params, batch, labels,
        dict(dict.fromkeys(tracing.counters("launch"), 0),
             pair_attention_expd=1, pair_attention_agg=1,
             pair_attention_bwd_fused=1), steps=1)
    del model
    torch.cuda.empty_cache()
    return launches


def b9_bound_ms(compact, ts_rows, h: int, k: int, itemsize: int):
    """B9's bound, counting what the function needs, whatever implements
    it: bytes = the distinct table rows with their source-score halves,
    the distinct dw rows with their f32 stabiliser and d_denom rows, the
    distinct target-score halves, 4 B an entry, 4 B a row pointer of each
    of the two CSRs, and d_ss, d_ts and d_table in f32 written once;
    operations = 4 a valid slot and column (the head sum's and d_table's
    multiply-adds)."""
    import torch

    n, rows = compact.src_row.numel(), compact.out_rows
    u_rows = int((torch.diff(compact.row_ptr) > 0).sum())
    t_rows = int(compact.src_row.unique().numel())
    ts_read = int(ts_rows.score_row.unique().numel())
    nbytes = (u_rows * (h + k) * itemsize + t_rows * (h * itemsize + 8 * k)
              + ts_read * k * itemsize + n * 4 + 2 * (rows + 1) * 4
              + rows * (h + 2 * k) * 4)
    return bound_ms(nbytes, 4.0 * n * h)


def head_rows_bound_ms(compact, h: int, itemsize: int, k: int,
                       entry_bytes: int):
    """B10's and B14's bound, counting what the function needs, whatever
    implements it: bytes = the distinct table (or stream) rows the entries
    read, ``entry_bytes`` an entry (its row and slot, 8 B; 4 B for B14,
    whose row is its slot, and for B10 reading B8's expd by entry) and its
    K f32 expd values, 4 B an output row
    pointer, and the f32 outputs (the weighted sums and the denominators)
    written once; operations = a multiply-add a valid slot and column and
    an add a valid slot and head."""
    n, out_rows = compact.src_row.numel(), compact.out_rows
    rows_read = int(compact.src_row.unique().numel())
    nbytes = (rows_read * h * itemsize + n * (entry_bytes + 4 * k)
              + (out_rows + 1) * 4 + out_rows * (h + k) * 4)
    return bound_ms(nbytes, n * (2.0 * h + k))


def max_rows_bound_ms(compact, k: int, read_bytes: int,
                      ops_per_value: float, init: bool = False):
    """B11's and B15's bound, counting what the function needs, whatever
    implements it: bytes = ``read_bytes`` (the distinct score halves, or
    value rows, the entries read), 4 B an entry (its row), 4 B an output
    row pointer and the f32 output written once (and the f32 ``init`` read
    once); operations = ``ops_per_value`` an entry and column."""
    n, out_rows = compact.src_row.numel(), compact.out_rows
    nbytes = (read_bytes + n * 4 + (out_rows + 1) * 4
              + out_rows * k * 4 * (2 if init else 1))
    return bound_ms(nbytes, ops_per_value * n * k)


def expd_rows_bound_ms(compact, k: int, itemsize: int, vs: int):
    """B8's bound, counting what the function needs, whatever implements
    it: bytes = the distinct source-score halves and target-score halves
    the compact form's entries read (rows u and (u // vs) * vs + t), the
    f32 stabiliser rows of the output rows with an entry, 4 B an entry
    (its row), 4 B an output row pointer and K f32 values an entry written
    once; operations = 6 an entry and head (add, leaky's compare, multiply
    and select, subtract, exp)."""
    import torch

    n, out_rows = compact.src_row.numel(), compact.out_rows
    counts = torch.diff(compact.row_ptr.long())
    u = compact.src_row.long()
    t = torch.repeat_interleave(
        torch.arange(out_rows, device=counts.device), counts)
    halves = (int(u.unique().numel())
              + int(((u // vs) * vs + t).unique().numel()))
    owned = int((counts > 0).sum())
    nbytes = (halves * k * itemsize + owned * k * 4 + n * 4
              + (out_rows + 1) * 4 + n * k * 4)
    return bound_ms(nbytes, 6.0 * n * k)


def relu_rows_bound_ms(compact, h: int, itemsize: int, outputs: int,
                       ops_per_entry: float, cot_itemsize: int = 0,
                       owned_cot_itemsize: int = 0):
    """A relu-pair row owner's bound (B4-B7), counting what the function
    needs, whatever implements it: bytes = the distinct rows of the table
    its entries gather (A for B4, B6 and B7; B, and the f32 cotangent of
    ``cot_itemsize`` bytes an element, for B5), one row of the table
    indexed by the output (B; A for B5) per output row with an entry, and
    for B7 one f32 cotangent row of ``owned_cot_itemsize`` bytes an
    element per such row, 8 B an entry (its row and scale), 4 B an output
    row pointer and the ``outputs`` f32 outputs written once; operations =
    ``ops_per_entry`` a valid slot and column."""
    import torch

    n, out_rows = compact.src_row.numel(), compact.out_rows
    gathered = int(compact.src_row.unique().numel())
    owned = int((torch.diff(compact.row_ptr) > 0).sum())
    nbytes = (gathered * h * (itemsize + cot_itemsize)
              + owned * h * (itemsize + owned_cot_itemsize)
              + n * 8 + (out_rows + 1) * 4 + outputs * out_rows * h * 4)
    return bound_ms(nbytes, ops_per_entry * n * h)


def relu_pair_bound_ms(plan_args, table_rows_read, cot_rows_read, h: int,
                       outputs: int, out_rows: int, ops_per_slot: float):
    """A relu-pair kernel's bound: bytes = the distinct bf16 rows of A and
    B it reads, the distinct f32 cotangent rows (B5, B7), the plan (12 B a
    slot, 4 B a chunk and a group) and its f32 outputs written once;
    operations = ``ops_per_slot`` per valid slot and column."""
    from tf2_gnn_tpu_torch.ops import pair_spmm as ps

    rel_src, _, src_blk, grp_tgt = plan_args
    valid = int(ps.slot_abs_ids(*plan_args)[2].sum())
    nbytes = (table_rows_read * h * 2 + cot_rows_read * h * 4
              + rel_src.numel() * 12 + src_blk.numel() * 4
              + grp_tgt.numel() * 4 + outputs * out_rows * h * 4)
    return bound_ms(nbytes, ops_per_slot * valid * h), valid


def edge_mlp_path(device, argv):
    """Phase 4: the reference-default GNN_Edge_MLP through B4, B5 and B6
    (B7, the forward row owner's third mode, checked and timed beside
    them). Returns the four entries and no other call form."""
    import torch

    from tf2_gnn_tpu_torch.models.node_multiclass_task import (
        NodeMulticlassTask,
    )
    from tf2_gnn_tpu_torch.ops import pair_edge_mlp as pem
    from tf2_gnn_tpu_torch.ops import pair_spmm as ps
    from tf2_gnn_tpu_torch.utils import tracing
    from tf2_gnn_tpu_torch.workloads import (
        FEATURE_DIM,
        NUM_LABELS,
        build_ppi_batch,
        edge_mlp_default_params,
    )

    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    batch, labels, real_edges = build_ppi_batch(SEED, device=device,
                                                merged=True,
                                                merge_targets=True)
    plan = batch.pair_merged
    rows = plan.out_rows
    log(f"workload (merged-target plans): {real_edges} edges, "
        f"V={batch.num_nodes_padded}, {rows} output rows, "
        f"{plan.rel_src_f.shape[0]} forward / {plan.rel_src_b.shape[0]} "
        f"backward chunks, {plan.ovf_src.shape[0]} overflow slots, built "
        f"in {time.perf_counter() - t0:.1f} s")
    params = edge_mlp_default_params()
    model = NodeMulticlassTask.from_params(
        params, input_dim=FEATURE_DIM, num_edge_types=batch.num_edge_types,
        device=device, seed=SEED, num_labels=NUM_LABELS)
    h = params["gnn_hidden_dim"]
    log(f"model edge_mlp_default_params(): "
        f"{sum(p.numel() for p in model.parameters())} parameters, "
        f"{params['gnn_num_layers']} layers, hidden {h}, edge stream "
        f"{params['gnn_edge_dtype']}, global exchange "
        f"{params['gnn_global_exchange_mode']} after layers "
        f"{list(model.gnn.exchange_layers)}")

    # Kernel inputs at the main path's shapes and dtypes: A and B are the
    # [L*V, H] bf16 halves (A's rows are L*V here too), g the f32
    # cotangent of R, and the unit scales of the unnormalised model.
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    a = torch.randn((rows, h), generator=gen, device=device).to(torch.bfloat16)
    b = torch.randn((rows, h), generator=gen, device=device).to(torch.bfloat16)
    g = torch.randn((rows, h), generator=gen, device=device)
    sf, sb, _ = ps.pair_unit_scales(plan, rows)
    fwd_args = (a, b, sf, *plan.fwd, rows)
    da_args = (a, b, g, sb, *plan.bwd, rows)
    db_args = (a, b, g, sf, *plan.fwd, rows)
    fwd_rows = plan.fwd_rows(rows, rows)
    bwd_rows = plan.bwd_rows(rows, rows)

    fns = {
        "relu_pair_fwd_m": (
            lambda: pem.relu_pair_fwd_m(*fwd_args, compact=fwd_rows),
            lambda: pem.relu_pair_fwd_m_plain(*fwd_args)),
        "relu_pair_da": (
            lambda: pem.relu_pair_da(*da_args, compact=bwd_rows),
            lambda: pem.relu_pair_da_plain(*da_args)),
        "relu_pair_fwd": (
            lambda: pem.relu_pair_fwd(*fwd_args, compact=fwd_rows),
            lambda: pem.relu_pair_fwd_plain(*fwd_args)),
        "relu_pair_db": (
            lambda: pem.relu_pair_db(*db_args, compact=fwd_rows),
            lambda: pem.relu_pair_db_plain(*db_args)),
    }
    errs = {name: check_outputs(name, kernel_fn, plain_fn())
            for name, (kernel_fn, plain_fn) in fns.items()}
    log("kernel check: " + ", ".join(f"{name} max_abs_err {err:.3e}"
                                     for name, err in errs.items())
        + f" (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}); B4-B7 "
        f"bit-equal across two launches, the forward compact form "
        f"{fwd_rows.src_row.numel()} entries into {rows} rows, the backward "
        f"one {bwd_rows.src_row.numel()} into {rows}")

    layers = params["gnn_num_layers"]
    tracing.reset()
    check_eval_forward(model, batch, labels, [
        (pem, name, plain_version(getattr(pem, f"{name}_plain")))
        for name in fns], logit_rtol=EDGE_MLP_LOGIT_RTOL)
    torch.cuda.synchronize()
    eval_launches = dict(pem.LAUNCHES)
    log(f"eval forward launches {eval_launches}")
    if eval_launches != {"relu_pair_fwd_m": 0, "relu_pair_da": 0,
                         "relu_pair_fwd": layers, "relu_pair_db": 0}:
        raise AssertionError(f"eval forward launched {eval_launches}; "
                             f"expected relu_pair_fwd {layers} times only")
    per_step = layers * TRAIN_STEPS
    state, train_step, eval_step, launches = train_and_count(
        model, params, batch, labels,
        {"relu_pair_fwd_m": per_step, "relu_pair_da": per_step,
         "relu_pair_fwd": 0, "relu_pair_db": 0, "pair_stream": 0,
         "pair_stream_joint": 0, "pair_spmm": 0, "pair_attention_expd": 0,
         "pair_attention_bwd_fused": 0, "pair_attention_max": 0,
         "pair_attention_agg": 0})
    launches["relu_pair_fwd"] = eval_launches["relu_pair_fwd"]
    time_path(state, train_step, eval_step, batch, labels, real_edges,
              device, argv, "GNN_Edge_MLP")

    # Bounds from this run's plan. The row owners count what the function
    # needs (``relu_rows_bound_ms``), operations a valid slot and column:
    # z = a + b, relu, scale and add (B6), also compare, select and add for
    # M (B4); add, compare, select, scale and add (B5); add, compare,
    # select and add, and g's multiply counted a slot (B7, which also reads
    # the f32 g row of each output row with an entry). Each logs its first
    # port's count beside it (``relu_pair_bound_ms``: the distinct rows, 12
    # B a plan slot, padded ones included).
    f_src, f_tgt, f_valid = ps.slot_abs_ids(*plan.fwd)
    a_rows = int(torch.unique(f_src[f_valid]).numel())
    t_rows = int(torch.unique(f_tgt[f_valid]).numel())
    b_tgt, b_src, b_valid = ps.slot_abs_ids(*plan.bwd)
    da_a_rows = int(torch.unique(b_src[b_valid]).numel())
    da_t_rows = int(torch.unique(b_tgt[b_valid]).numel())
    bounds = {
        "relu_pair_fwd_m": (relu_rows_bound_ms(fwd_rows, h, 2, 2, 7.0),
                            fwd_rows.src_row.numel()),
        "relu_pair_da": (relu_rows_bound_ms(bwd_rows, h, 2, 1, 5.0, 4),
                         bwd_rows.src_row.numel()),
        "relu_pair_fwd": (relu_rows_bound_ms(fwd_rows, h, 2, 1, 4.0),
                          fwd_rows.src_row.numel()),
        "relu_pair_db": (relu_rows_bound_ms(fwd_rows, h, 2, 1, 4.0,
                                            owned_cot_itemsize=4),
                         fwd_rows.src_row.numel()),
    }
    first_counts = {
        "relu_pair_fwd_m": relu_pair_bound_ms(plan.fwd, a_rows + t_rows, 0,
                                              h, 2, rows, 7.0),
        "relu_pair_da": relu_pair_bound_ms(plan.bwd, da_a_rows + da_t_rows,
                                           da_t_rows, h, 1, rows, 5.0),
        "relu_pair_fwd": relu_pair_bound_ms(plan.fwd, a_rows + t_rows, 0, h,
                                            1, rows, 4.0),
        "relu_pair_db": relu_pair_bound_ms(plan.fwd, a_rows + t_rows,
                                           t_rows, h, 1, rows, 4.0),
    }
    replaces = {"relu_pair_fwd_m": "tf2_gnn_tpu/ops/pair_edge_mlp.py:289",
                "relu_pair_da": "tf2_gnn_tpu/ops/pair_edge_mlp.py:523",
                "relu_pair_fwd": "tf2_gnn_tpu/ops/pair_edge_mlp.py:171",
                "relu_pair_db": "tf2_gnn_tpu/ops/pair_edge_mlp.py:402"}
    kernels = []
    for name, (kernel_fn, plain_fn) in fns.items():
        (bound, bound_by), valid = bounds[name]
        detail = (f"[{rows}, {h}] bf16 A and B, {valid} valid slots; "
                  f"padded-slot bound count {first_counts[name][0][0]:.4f} "
                  f"ms")
        kernels.append(time_kernel(
            name, "tf2_gnn_tpu_torch/csrc/pair_edge_mlp.cu", replaces[name],
            launches[name], errs[name], kernel_fn, plain_fn, None, None,
            bound, bound_by, detail, device=True))
    return kernels, []


def sorted_bound_ms(valid: int, slots: int, chunks: int, h: int,
                    itemsize: int, aux_per_slot: int, out_rows: int,
                    out_cols: int, ops_per_value: float):
    """A sorted-scatter kernel's bound: bytes = the valid slots' stream
    rows (sentinel rows are never read) and their per-slot f32 operand
    (``aux_per_slot`` values: B13's scale, B14's expd), the plan (4 B a
    slot, 4 B a chunk) and the f32 output written once; operations =
    ``ops_per_value`` per valid slot and column."""
    nbytes = (valid * (h * itemsize + aux_per_slot * 4) + slots * 4
              + chunks * 4 + out_rows * out_cols * 4)
    return bound_ms(nbytes, ops_per_value * valid * h)


def b12_bound_ms(compact, row_bytes: int, cols: int):
    """B12's bound, counting what the function needs, whatever implements
    it: bytes = the distinct stream rows its entries read, 4 B an entry (its
    stream row), 4 B an output row pointer and the f32 output written once;
    operations = an add per entry and column."""
    n = compact.src_row.numel()
    rows_read = int(compact.src_row.unique().numel())
    nbytes = (rows_read * row_bytes + n * 4 + (compact.out_rows + 1) * 4
              + compact.out_rows * cols * 4)
    return bound_ms(nbytes, 1.0 * n * cols)


def sorted_path(device, argv):
    """Phase 5: the scatter-plan PPI batch; PPI_RGCN (the bench's sorted
    path) through B13, the shipped PPI_RGAT's sorted fallback through B12,
    B14 and B15. Returns the four entries and the other call forms' (B12's
    two, B13's backward)."""
    import torch

    from tf2_gnn_tpu_torch.layers.message_passing import rgat as rgat_layer
    from tf2_gnn_tpu_torch.models.node_multiclass_task import (
        NodeMulticlassTask,
    )
    from tf2_gnn_tpu_torch.ops import sorted_spmm as ss
    from tf2_gnn_tpu_torch.utils import tracing
    from tf2_gnn_tpu_torch.workloads import (
        FEATURE_DIM,
        NUM_LABELS,
        build_ppi_batch,
        rgcn_sorted_params,
        shipped_params,
    )

    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    batch, labels, real_edges = build_ppi_batch(SEED, device=device,
                                                scatter=True)
    plan = batch.scatter_merged
    v, num_types = batch.num_nodes_padded, batch.num_edge_types
    rows = num_types * v
    n_fwd, n_bwd = plan.rel_tgt.numel(), plan.rel_src.numel()
    c_fwd, c_bwd = plan.tgt_blocks.numel(), plan.src_blocks.numel()
    valid_f = int((~plan.fwd_sentinel).sum())
    valid_b = int((~plan.bwd_sentinel).sum())
    log(f"workload (scatter plans): {real_edges} edges, V={v}, {c_fwd} "
        f"forward chunks ({n_fwd} slots, {valid_f} valid) / {c_bwd} backward "
        f"chunks ({n_bwd} slots, {valid_b} valid), built in "
        f"{time.perf_counter() - t0:.1f} s")

    # Kernel inputs at the main path's shapes and dtypes: RGCN's f32
    # [slots, 320] streams in both slot orders with the 1/deg scales;
    # RGAT's bf16 [slots, 324] bundle cotangent in backward slot order, its
    # f32 [slots, 4] target-score cotangent over the type-minor rows, f32
    # expd and a strided f32 view of the gathered bundle, f32 logits; the
    # bf16 bundle cotangent in forward slot order, as plan_gather_src's
    # backward receives it.
    h, k = 320, 4
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    tables = torch.randn((rows, h), generator=gen, device=device)
    stream_f = tables.index_select(0, plan.src_idx)
    g_nodes = torch.randn((v, h), generator=gen, device=device)
    stream_b = g_nodes.index_select(0, plan.tgt_by_src_idx)
    bundle_cot = torch.randn((n_bwd, h + k), generator=gen,
                             device=device).to(torch.bfloat16)
    score_cot = torch.randn((n_fwd, k), generator=gen, device=device)
    bundle = torch.randn((n_fwd, h + k), generator=gen, device=device)
    msgs = bundle[:, :h]
    expd = torch.rand((n_fwd, k), generator=gen, device=device)
    expd.masked_fill_(plan.fwd_sentinel[:, None], 0.0)
    logits = torch.randn((n_fwd, k), generator=gen, device=device)
    g_fwd = torch.randn((n_fwd, h + k), generator=gen,
                        device=device).to(torch.bfloat16)
    r_typed = ss.BLOCK_NODES * num_types
    fwd = (plan.rel_tgt, plan.tgt_blocks, v)
    # form: (wrapper, arguments, keyword arguments, the compact form of a
    # row owner, B12, B14 or B15).
    forms = {
        "sorted_segment_sum_scaled": (
            "sorted_segment_sum_scaled", (stream_f, plan.inv_fwd) + fwd, {},
            None),
        "sorted_segment_sum_scaled backward": (
            "sorted_segment_sum_scaled",
            (stream_b, plan.inv_bwd, plan.rel_src, plan.src_blocks, rows),
            {}, None),
        "sorted_segment_sum": (
            "sorted_segment_sum",
            (bundle_cot, plan.rel_src, plan.src_blocks, rows), {},
            plan.sum_rows("bwd", rows)),
        "sorted_segment_sum gathered": (
            "sorted_segment_sum_gathered",
            (g_fwd, plan.bwd_to_fwd_idx, plan.bwd_sentinel, plan.rel_src,
             plan.src_blocks, rows), {}, plan.sum_rows("bwd_fused", rows)),
        "sorted_segment_sum typed": (
            "sorted_segment_sum",
            (score_cot, plan.rel_typed, plan.tgt_blocks, rows),
            {"block_rows": r_typed}, plan.sum_rows("fwd_typed", rows)),
        "attention_scatter_sums": (
            "attention_scatter_sums", (expd, msgs) + fwd, {},
            plan.sum_rows("fwd", v)),
        "sorted_segment_max": ("sorted_segment_max", (logits,) + fwd, {},
                               plan.sum_rows("fwd", v)),
    }

    def fns(form):
        wrapper, args, kwargs, compact = forms[form]
        launch_kwargs = kwargs if compact is None else dict(kwargs,
                                                            compact=compact)
        return (lambda: getattr(ss, wrapper)(*args, **launch_kwargs),
                lambda: getattr(ss, f"{wrapper}_plain")(*args, **kwargs))

    errs = {}
    for form in forms:
        kernel_fn, plain_fn = fns(form)
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        if forms[form][3] is not None:  # row owners: one sum order a run
            check_repeatable(form, kernel_fn, got)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if form == "sorted_segment_max":
            if not torch.equal(got[0], want[0]):
                raise AssertionError("sorted_segment_max: kernel differs from "
                                     "its plain version (must match exactly)")
            errs[form] = float((got[0] - want[0]).abs().max())
        else:
            errs[form] = max(check_close(f"{form} output {i}", x, y,
                                         KERNEL_RTOL, KERNEL_ATOL)
                             for i, (x, y) in enumerate(zip(got, want)))
        del got, want
    log("kernel check: " + ", ".join(f"{form} max_abs_err {err:.3e}"
                                     for form, err in errs.items())
        + f" (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}; the max exactly; "
        "B12's three forms, B14 and B15 bit-equal across two launches); "
        "their compact forms: " + ", ".join(
            f"{form} {forms[form][3].src_row.numel()} entries "
            f"into {forms[form][3].out_rows} rows"
            for form in forms if forms[form][3] is not None))

    zero = dict.fromkeys(tracing.counters("launch"), 0)
    patches = [(ss, name, plain_version(getattr(ss, f"{name}_plain")))
               for name in (*ss.LAUNCHES, "sorted_segment_sum_gathered")]
    patches.append((rgat_layer, "sorted_segment_max",
                    plain_version(ss.sorted_segment_max_plain)))

    def eval_launches(model):
        tracing.reset()
        check_eval_forward(model, batch, labels, patches)
        torch.cuda.synchronize()
        counts = dict(ss.LAUNCHES)
        log(f"eval forward launches {counts}")
        return counts

    # PPI_RGCN as the bench's sorted path runs it.
    params = rgcn_sorted_params()
    model = NodeMulticlassTask.from_params(
        params, input_dim=FEATURE_DIM, num_edge_types=num_types,
        device=device, seed=SEED, num_labels=NUM_LABELS)
    layers = params["gnn_num_layers"]
    log(f"model rgcn_sorted_params(): "
        f"{sum(p.numel() for p in model.parameters())} parameters, {layers} "
        f"layers, hidden {params['gnn_hidden_dim']}, edge stream "
        f"{params['gnn_edge_dtype']}")
    rgcn_eval = eval_launches(model)
    if rgcn_eval != {"sorted_segment_sum": 0, "sorted_segment_sum_scaled":
                     layers, "sorted_segment_max": 0,
                     "attention_scatter_sums": 0}:
        raise AssertionError(f"RGCN eval forward launched {rgcn_eval}; "
                             f"expected sorted_segment_sum_scaled {layers} "
                             "times only")
    state, train_step, eval_step, rgcn_launches = train_and_count(
        model, params, batch, labels, dict(
            zero, sorted_segment_sum=0,
            sorted_segment_sum_scaled=2 * layers * TRAIN_STEPS,
            sorted_segment_max=0, attention_scatter_sums=0))
    time_path(state, train_step, eval_step, batch, labels, real_edges,
              device, argv, "PPI_RGCN (scatter plans)")
    del model, state, train_step, eval_step
    torch.cuda.empty_cache()

    # The shipped PPI_RGAT on its sorted fallback.
    torch.cuda.reset_peak_memory_stats(device)
    params = shipped_params("PPI_RGAT.json", "rgat")
    model = model_from_params(params, device, num_types, "PPI_RGAT.json")
    layers = params["gnn_num_layers"]
    rgat_eval = eval_launches(model)
    if rgat_eval != {"sorted_segment_sum": 0, "sorted_segment_sum_scaled": 0,
                     "sorted_segment_max": layers,
                     "attention_scatter_sums": layers}:
        raise AssertionError(f"RGAT eval forward launched {rgat_eval}; "
                             f"expected sorted_segment_max and "
                             f"attention_scatter_sums {layers} times each")
    per_step = layers * TRAIN_STEPS
    state, train_step, eval_step, rgat_launches = train_and_count(
        model, params, batch, labels, dict(
            zero, sorted_segment_sum=2 * per_step,
            sorted_segment_sum_scaled=0, sorted_segment_max=per_step,
            attention_scatter_sums=per_step))
    time_path(state, train_step, eval_step, batch, labels, real_edges,
              device, argv, "PPI_RGAT (scatter plans)")
    del model, state, train_step, eval_step
    torch.cuda.empty_cache()

    # Bounds from this run's plan and the library yardsticks: the plan's
    # [rows, slots] CSR (1/deg scales or ones) times the same stream, the
    # [rows, forward slots] CSR of the backward slots' forward slots times
    # the forward-ordered cotangent, and one scatter_reduce_ for the max.
    def csr(rel, blocks, scale, out_rows, block_rows=ss.BLOCK_NODES,
            dtype=torch.float32, cols=None, in_rows=None):
        seg = ss._segment_ids(rel, blocks, out_rows, block_rows)
        valid = seg < out_rows
        cols = torch.arange(seg.numel(), device=device) if cols is None \
            else cols.reshape(-1)
        idx = torch.stack([seg[valid], cols[valid]])
        return torch.sparse_coo_tensor(
            idx, scale.reshape(-1)[valid].to(dtype),
            (out_rows, in_rows or seg.numel())).coalesce().to_sparse_csr()

    ones_b = torch.ones((n_bwd,), device=device)
    ones_f = torch.ones((n_fwd,), device=device)
    a_fwd = csr(plan.rel_tgt, plan.tgt_blocks, plan.inv_fwd, v)
    a_bwd = csr(plan.rel_src, plan.src_blocks, plan.inv_bwd, rows)
    a_src16 = csr(plan.rel_src, plan.src_blocks, ones_b, rows,
                  dtype=torch.bfloat16)
    a_src32 = csr(plan.rel_src, plan.src_blocks, ones_b, rows)
    a_gath16, a_gath32 = (
        csr(plan.rel_src, plan.src_blocks, ones_b, rows, dtype=dtype,
            cols=plan.bwd_to_fwd_idx, in_rows=n_fwd)
        for dtype in (torch.bfloat16, torch.float32))
    a_typed = csr(plan.rel_typed, plan.tgt_blocks, ones_f, rows,
                  block_rows=r_typed)
    bundle_cot32, g_fwd32 = bundle_cot.float(), g_fwd.float()
    seg_max = ss._segment_ids(plan.rel_tgt, plan.tgt_blocks, v,
                              ss.BLOCK_NODES)[:, None].expand(
                                  logits.shape).contiguous()
    max_out = torch.zeros((v + 1, k), device=device)
    library = {
        "sorted_segment_sum_scaled": (
            lambda: torch.sparse.mm(a_fwd, stream_f), None),
        "sorted_segment_sum_scaled backward": (
            lambda: torch.sparse.mm(a_bwd, stream_b), None),
        "sorted_segment_sum": (
            lambda: torch.sparse.mm(a_src16, bundle_cot),
            lambda: torch.sparse.mm(a_src32, bundle_cot32)),
        "sorted_segment_sum gathered": (
            lambda: torch.sparse.mm(a_gath16, g_fwd),
            lambda: torch.sparse.mm(a_gath32, g_fwd32)),
        "sorted_segment_sum typed": (
            lambda: torch.sparse.mm(a_typed, score_cot), None),
        "sorted_segment_max": (
            lambda: max_out.scatter_reduce_(0, seg_max, logits, "amax",
                                            include_self=False), None),
    }
    bounds = {
        "sorted_segment_sum_scaled": sorted_bound_ms(
            valid_f, n_fwd, c_fwd, h, 4, 1, v, h, 2.0),
        "sorted_segment_sum_scaled backward": sorted_bound_ms(
            valid_b, n_bwd, c_bwd, h, 4, 1, rows, h, 2.0),
        "sorted_segment_sum": b12_bound_ms(forms["sorted_segment_sum"][3],
                                           (h + k) * 2, h + k),
        "sorted_segment_sum gathered": b12_bound_ms(
            forms["sorted_segment_sum gathered"][3], (h + k) * 2, h + k),
        "sorted_segment_sum typed": b12_bound_ms(
            forms["sorted_segment_sum typed"][3], k * 4, k),
        "attention_scatter_sums": head_rows_bound_ms(
            forms["attention_scatter_sums"][3], h, 4, k, 4),
        "sorted_segment_max": max_rows_bound_ms(
            forms["sorted_segment_max"][3], k,
            forms["sorted_segment_max"][3].src_row.numel() * k * 4, 1.0),
    }
    launches = dict(rgat_launches)
    launches["sorted_segment_sum_scaled"] = \
        rgcn_launches["sorted_segment_sum_scaled"]
    replaces = {
        "sorted_segment_sum": "tf2_gnn_tpu/ops/spmm_pallas.py:442",
        "sorted_segment_sum_scaled": "tf2_gnn_tpu/ops/spmm_pallas.py:494",
        "attention_scatter_sums": "tf2_gnn_tpu/ops/spmm_pallas.py:835",
        "sorted_segment_max": "tf2_gnn_tpu/ops/spmm_pallas.py:705",
    }
    # The row owners' bounds as the sorted-scatter kernels count theirs
    # (the valid slots' rows and per-slot operand, 4 B a slot and a chunk,
    # the outputs; B14: a multiply-add per column and an add per head),
    # logged beside them.
    per_slot = {
        "sorted_segment_sum": sorted_bound_ms(
            valid_b, n_bwd, c_bwd, h + k, 2, 0, rows, h + k, 1.0)[0],
        "sorted_segment_sum typed": sorted_bound_ms(
            valid_f, n_fwd, c_fwd, k, 4, 0, rows, k, 1.0)[0],
        "attention_scatter_sums": sorted_bound_ms(
            valid_f, n_fwd, c_fwd, h, 4, k, v, h + k, 2.0 + k / h)[0],
        "sorted_segment_max": sorted_bound_ms(
            valid_f, n_fwd, c_fwd, k, 4, 0, v, k, 1.0)[0],
    }
    details = {
        "sorted_segment_sum_scaled": f"RGCN forward, f32 [{n_fwd}, {h}] "
                                     f"-> [{v}, {h}]",
        "sorted_segment_sum_scaled backward": f"RGCN backward, f32 "
                                              f"[{n_bwd}, {h}] -> [{rows}, "
                                              f"{h}]",
        "sorted_segment_sum": f"RGAT bundle gradient, bf16 [{n_bwd}, "
                              f"{h + k}] -> f32 [{rows}, {h + k}]",
        "sorted_segment_sum gathered": f"RGAT bundle gradient in one pass, "
                                       f"bf16 [{n_fwd}, {h + k}] through "
                                       f"bwd_to_fwd_idx -> f32 [{rows}, "
                                       f"{h + k}]",
        "sorted_segment_sum typed": f"RGAT target-score gradient, f32 "
                                    f"[{n_fwd}, {k}] -> [{rows}, {k}], R = "
                                    f"{r_typed}",
        "attention_scatter_sums": f"f32 expd [{n_fwd}, {k}] and a strided "
                                  f"f32 [{n_fwd}, {h}] view",
        "sorted_segment_max": f"f32 [{n_fwd}, {k}] -> [{v}, {k}]",
    }
    kernels, other_forms = [], []
    for form in forms:
        kernel_fn, plain_fn = fns(form)
        lib_fn, lib32_fn = library.get(form, (None, None))
        name = form.split()[0]
        row_owner = forms[form][3] is not None
        detail = details[form]
        if form in per_slot:
            detail += f"; per-slot bound count {per_slot[form]:.4f} ms"
        entry = time_kernel(
            form, "tf2_gnn_tpu_torch/csrc/" + (
                "pair_stream.cu" if row_owner else "sorted_scatter.cu"),
            replaces[name], launches[name], errs[form], kernel_fn, plain_fn,
            lib_fn, lib32_fn, *bounds[form], detail, device=True)
        # The main call form of each kernel is its entry on the kernels
        # line; the others are logged.
        (kernels if form == name else other_forms).append(entry)
    return kernels, other_forms


def typed_rgat_path(device, argv):
    """Phase 6: RGAT on the per-type-plan PPI batch; the shipped PPI_RGAT
    with the exact stabiliser through B11 (and B8, B3, B9), and GAT's
    8-head layout through B10 (and B8, B9). Returns the B11 and B10
    entries, and B9's and B8's at the two models' shapes."""
    import torch

    from tf2_gnn_tpu_torch.ops import pair_attention as pa
    from tf2_gnn_tpu_torch.ops import pair_spmm as ps
    from tf2_gnn_tpu_torch.utils import tracing
    from tf2_gnn_tpu_torch.workloads import (
        build_ppi_batch,
        rgat_eight_heads_params,
        shipped_params,
    )

    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    batch, labels, real_edges = build_ppi_batch(SEED, device=device)
    merged = build_ppi_batch(SEED, device=device, merged=True)[0].pair_merged
    v, num_types = batch.num_nodes_padded, batch.num_edge_types
    plans = batch.pair_typed
    valid_slots = [int(ps.slot_abs_ids(*p.fwd)[2].sum()) for p in plans]
    big_i = valid_slots.index(max(valid_slots))
    big = plans[big_i]
    log(f"workload (per-type plans): {real_edges} edges, V={v}, valid "
        f"slots per type {valid_slots}, forward / backward chunks per type "
        f"{[(p.rel_src_f.shape[0], p.rel_src_b.shape[0]) for p in plans]}, "
        f"overflow slots {[p.ovf_src.shape[0] for p in plans]}; the "
        f"merged plan of phase 3 for B11's merged form, built in "
        f"{time.perf_counter() - t0:.1f} s")

    # Kernel inputs at the main path's shapes and dtypes: bf16 scores of
    # the 4-head model, one type's [V, 8] slab and the merged [L*V, 8]
    # table, over their forward compact forms; for one type's plan also
    # from an init, the max of another type's slab, as the per-type
    # forward chains its launches; for B10 a bf16 [V, H] slab of each call
    # form with B8's f32 expd by entry on the largest type's plan, over its
    # forward compact form.
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    k = 4
    scores_t = (0.5 * torch.randn((v, 2 * k), generator=gen,
                                  device=device)).to(torch.bfloat16)
    scores_m = (0.5 * torch.randn((num_types * v, 2 * k), generator=gen,
                                  device=device)).to(torch.bfloat16)
    other = plans[(big_i + 1) % num_types]
    init = pa.pair_attention_max_plain(
        (0.5 * torch.randn((v, 2 * k), generator=gen,
                           device=device)).to(torch.bfloat16),
        *other.fwd, v, k)
    # form: (scores or table, the plan, heads, B10's expd, B11's init).
    forms = {
        "pair_attention_max": (scores_t, big, k, None, None),
        "pair_attention_max merged": (scores_m, merged, k, None, None),
        "pair_attention_max init": (scores_t, big, k, None, init),
    }
    agg_rows = big.fwd_rows(v, v)
    b8_inputs = {}  # heads -> (scores, stabiliser) of B10's two forms
    for agg_k, agg_h, form in ((8, 64, "pair_attention_agg"),
                               (4, 512, "pair_attention_agg heads512")):
        table = torch.randn((v, agg_h), generator=gen,
                            device=device).to(torch.bfloat16)
        sc = (0.5 * torch.randn((v, 2 * agg_k), generator=gen,
                                device=device)).to(torch.bfloat16)
        m = pa._stabilise(pa._bound_stabiliser(sc, v, agg_k), torch.bfloat16)
        expd = pa.pair_attention_expd(sc, m, *big.fwd, v, agg_k,
                                      compact=agg_rows)
        forms[form] = (table, big, agg_k, expd, None)
        b8_inputs[agg_k] = (sc, m)

    def fns(form):
        first, plan, kk, expd, init_m = forms[form]
        if expd is None:
            rows = plan.fwd_rows(v, first.shape[0])
            return (lambda: pa.pair_attention_max(
                        first, *plan.fwd, v, kk, compact=rows, init=init_m),
                    lambda: pa.pair_attention_max_plain(
                        first, *plan.fwd, v, kk, init=init_m))
        expd_slot = ps.by_slot(expd, agg_rows)
        return (lambda: pa.pair_attention_agg(first, expd, *plan.fwd, v, kk,
                                              compact=agg_rows,
                                              by_entry=True),
                lambda: pa.pair_attention_agg_plain(first, expd_slot,
                                                    *plan.fwd, v, kk))

    # All row owners: B11 exactly, B10 within the tolerance; both bit-equal
    # across two launches.
    errs = {}
    for form in forms:
        kernel_fn, plain_fn = fns(form)
        if forms[form][3] is None:
            got, want = kernel_fn(), plain_fn()
            torch.cuda.synchronize()
            check_repeatable(form, kernel_fn, got)
            if not torch.equal(got, want):
                raise AssertionError(f"{form}: kernel differs from its plain "
                                     "version (must match exactly)")
            errs[form] = float((got - want).abs().max())
            del got, want
        else:
            errs[form] = check_outputs(form, kernel_fn, plain_fn())
    log("kernel check: " + ", ".join(f"{form} max_abs_err {err:.3e}"
                                     for form, err in errs.items())
        + f" (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}; the max exactly; B11 "
        f"and B10 bit-equal across two launches; the compact form of the "
        f"largest type's plan {agg_rows.src_row.numel()} entries into {v} "
        f"rows, the merged plan's "
        f"{merged.fwd_rows(v, num_types * v).src_row.numel()})")

    # B8 on the largest type's plan at the two models' head counts (GAT's
    # K = 8, PPI_RGAT's K = 4), by entry against the plain version at the
    # form's slots, two launches bit-equal; phase 3 holds its entry on the
    # merged plan.
    b8_typed = {}
    for kk, (sc, m) in b8_inputs.items():
        def b8(sc=sc, m=m, kk=kk):
            return pa.pair_attention_expd(sc, m, *big.fwd, v, kk,
                                          compact=agg_rows)

        def b8_plain(sc=sc, m=m, kk=kk):
            return pa.pair_attention_expd_plain(
                sc, m, *big.fwd, v, kk)[:, agg_rows.slot.long()]

        name8 = f"pair_attention_expd K = {kk}, one type"
        b8_typed[kk] = (name8, b8, b8_plain,
                        check_outputs(name8, b8, b8_plain()))
    log("kernel check: " + ", ".join(
        f"{name8} max_abs_err {err:.3e}"
        for name8, _, _, err in b8_typed.values())
        + f" (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}; bit-equal across two "
        f"launches)")

    # B9 on the largest type's plan at the shapes of the two models' main
    # paths: PPI_RGAT's one-type slab (K = 4, H = 320) and GAT's head
    # layout (K = 8, H = 64), bf16; phase 3 holds its entry on the merged
    # plan.
    b9_rows, b9_ts = big.bwd_rows(v, v), big.bwd_ts_rows(v, v, v)
    b9_shapes = {}
    for kk, hh in ((4, 320), (8, 64)):
        table9, dw9 = (torch.randn((v, hh), generator=gen,
                                   device=device).to(torch.bfloat16)
                       for _ in range(2))
        d_denom9 = torch.randn((v, kk), generator=gen, device=device)
        scores9 = (0.5 * torch.randn((v, 2 * kk), generator=gen,
                                     device=device)).to(torch.bfloat16)
        m9 = pa._stabilise(pa._bound_stabiliser(scores9, v, kk),
                           torch.bfloat16)
        b9_args = (table9, dw9, d_denom9, scores9, m9, *big.bwd, v, kk)

        def b9(b9_args=b9_args):
            return pa.pair_attention_bwd_fused(*b9_args, compact=b9_rows,
                                               ts_rows=b9_ts)

        def b9_plain(b9_args=b9_args):
            return pa.pair_attention_bwd_fused_plain(*b9_args)

        name9 = f"pair_attention_bwd_fused K = {kk}, H = {hh}, one type"
        b9_shapes[(kk, hh)] = (name9, b9, b9_plain,
                               check_outputs(name9, b9, b9_plain()))
    log("kernel check: " + ", ".join(
        f"{name9} max_abs_err {err:.3e}"
        for name9, _, _, err in b9_shapes.values())
        + f" (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}; bit-equal across two "
        f"launches); its compact forms on the largest type's plan: "
        f"{b9_rows.src_row.numel()} entries into {v} source rows, d_ts "
        f"{b9_ts.sums.src_row.numel()} entries")

    zero = dict.fromkeys(tracing.counters("launch"), 0)
    patches = [(ps, "pair_spmm", plain_version(ps.pair_spmm_plain)),
               (pa, "pair_spmm", plain_version(ps.pair_spmm_plain))]
    patches += [(pa, name, plain_version(getattr(pa, f"{name}_plain")))
                for name in pa.LAUNCHES]

    def run_config(model, params, name, counts):
        check_eval_forward(model, batch, labels, patches,
                           TYPED_RGAT_LOGIT_RTOL, TYPED_RGAT_ATOL,
                           TYPED_RGAT_LOSS_RTOL)
        per_step = params["gnn_num_layers"] * TRAIN_STEPS * num_types
        state, train_step, eval_step, launches = train_and_count(
            model, params, batch, labels,
            dict(zero, **{kernel: per_step * mult
                          for kernel, mult in counts.items()}))
        time_path(state, train_step, eval_step, batch, labels, real_edges,
                  device, argv, name)
        torch.cuda.empty_cache()
        return launches

    # 1. The shipped PPI_RGAT with the exact stabiliser: per layer B11,
    # B8 and B9 once a type, B3 once a head and type.
    params = dict(shipped_params("PPI_RGAT.json", "rgat"),
                  gnn_attention_stabiliser="exact")
    model = model_from_params(params, device, num_types,
                              "PPI_RGAT.json, exact stabiliser")
    heads = model.gnn.mp_layer_0._padded_heads()
    exact_launches = run_config(
        model, params, "PPI_RGAT exact (per-type plans)",
        {"pair_attention_max": 1, "pair_attention_expd": 1,
         "pair_spmm": heads, "pair_attention_bwd_fused": 1})
    del model
    torch.cuda.reset_peak_memory_stats(device)
    # 2. GAT's 8-head layout: per layer B8, B10 and B9 once a type.
    params = rgat_eight_heads_params()
    model = model_from_params(params, device, num_types,
                              "rgat_eight_heads_params()")
    agg_launches = run_config(
        model, params, "RGAT 8 heads (per-type plans)",
        {"pair_attention_expd": 1, "pair_attention_agg": 1,
         "pair_attention_bwd_fused": 1})
    del model

    # Bounds from this run's plans: the bytes each kernel must move (each
    # input read once, each output written once) and its f32 operations.
    def plan_bytes(plan):
        return (plan[0].numel() * 8 + plan[2].numel() * 4
                + plan[3].numel() * 4)

    def max_first_count(scores, plan, kk):
        # B11's first port's count, logged: the source half of each
        # distinct source row, the target half of each distinct target
        # row, the plan, the output.
        src, tgt, valid = ps.slot_abs_ids(*plan)
        halves = (int(torch.unique(src[valid]).numel())
                  + int(torch.unique((src[valid] // v) * v
                                     + tgt[valid]).numel()))
        return bound_ms(halves * kk * scores.element_size()
                        + plan_bytes(plan) + v * kk * 4,
                        4.0 * int(valid.sum()) * kk)[0]

    def max_bound(scores, plan, kk, init_m):
        # The recount as the row owner counts it: the distinct score
        # halves the compact form's entries read (source rows u, target
        # rows (u // v) * v + t); per entry and head an add, the leaky
        # multiply and select, and the max.
        rows = plan.fwd_rows(v, scores.shape[0])
        u = rows.src_row.long()
        t = torch.repeat_interleave(torch.arange(v, device=device),
                                    torch.diff(rows.row_ptr.long()))
        halves = (int(torch.unique(u).numel())
                  + int(torch.unique((u // v) * v + t).numel()))
        return max_rows_bound_ms(rows, kk,
                                 halves * kk * scores.element_size(), 4.0,
                                 init=init_m is not None)

    def agg_first_count(table, plan, kk):
        # B10's first port's count, logged: the distinct table rows and
        # the f32 expd of the valid slots, the plan, both f32 outputs.
        src, _, valid = ps.slot_abs_ids(*plan)
        h = table.shape[1]
        rows_read = int(torch.unique(src[valid]).numel())
        return bound_ms(rows_read * h * table.element_size()
                        + kk * int(valid.sum()) * 4 + plan_bytes(plan)
                        + v * (h + kk) * 4, 2.0 * int(valid.sum()) * h)[0]

    # The library yardstick for B11: one scatter_reduce_ of the per-slot
    # logits, built outside the timed window (B10 has no single call).
    libraries = {}
    for form in ("pair_attention_max", "pair_attention_max merged"):
        scores, plan, kk, _, _ = forms[form]
        _, logit, tgt, _, valid = pa._slot_logits(scores, *plan.fwd, v,
                                                  swap=False)
        seg = torch.where(valid, tgt, torch.full_like(tgt, v))
        seg = seg[:, None].expand(logit.shape).contiguous()
        out = torch.zeros((v + 1, kk), device=device)
        libraries[form] = (lambda out=out, seg=seg, logit=logit:
                           out.scatter_reduce_(0, seg, logit, "amax",
                                               include_self=False))
    launches = {"pair_attention_max": exact_launches["pair_attention_max"],
                "pair_attention_agg": agg_launches["pair_attention_agg"]}
    replaces = {"pair_attention_max": "tf2_gnn_tpu/ops/pair_attention.py:262",
                "pair_attention_agg": "tf2_gnn_tpu/ops/pair_attention.py:596"}
    kernels, other_forms = [], []
    for form, (first, plan, kk, expd, init_m) in forms.items():
        name = form.split()[0]
        kernel_fn, plain_fn = fns(form)
        if expd is None:
            bound = max_bound(first, plan, kk, init_m)
            start = "" if init_m is None else ", from an init"
            detail = (f"bf16 scores [{first.shape[0]}, {2 * kk}] -> f32 "
                      f"[{v}, {kk}]{start}; padded-slot bound count "
                      f"{max_first_count(first, plan.fwd, kk):.4f} ms")
        else:
            bound = head_rows_bound_ms(agg_rows, first.shape[1], 2, kk, 4)
            detail = (f"K = {kk}, bf16 table [{v}, {first.shape[1]}], B8's "
                      f"f32 expd [{kk}, {agg_rows.src_row.numel()}] by "
                      f"entry; padded-slot bound count "
                      f"{agg_first_count(first, plan.fwd, kk):.4f} ms")
        entry = time_kernel(
            form, "tf2_gnn_tpu_torch/csrc/pair_stream.cu", replaces[name],
            launches[name], errs[form], kernel_fn, plain_fn,
            libraries.get(form), None, *bound, detail, device=True)
        # The main call form of each kernel is its entry; the others are
        # logged.
        (kernels if form == name else other_forms).append(entry)
    b9_launches = {(4, 320): exact_launches["pair_attention_bwd_fused"],
                   (8, 64): agg_launches["pair_attention_bwd_fused"]}
    other_forms += [time_kernel(
        name9, "tf2_gnn_tpu_torch/csrc/pair_attention.cu",
        "tf2_gnn_tpu/ops/pair_attention.py:860", b9_launches[(kk, hh)], err,
        b9, b9_plain, None, None, *b9_bound_ms(b9_rows, b9_ts, hh, kk, 2),
        f"K = {kk}, bf16 table [{v}, {hh}], one type's plan", device=True)
        for (kk, hh), (name9, b9, b9_plain, err) in b9_shapes.items()]
    b8_launches = {4: exact_launches["pair_attention_expd"],
                   8: agg_launches["pair_attention_expd"]}
    other_forms += [time_kernel(
        name8, "tf2_gnn_tpu_torch/csrc/pair_stream.cu",
        "tf2_gnn_tpu/ops/pair_attention.py:427", b8_launches[kk], err, b8,
        b8_plain, None, None, *expd_rows_bound_ms(agg_rows, kk, 2, v),
        f"bf16 scores [{v}, {2 * kk}] -> f32 [{kk}, "
        f"{agg_rows.src_row.numel()}] by entry, one type's plan",
        device=True)
        for kk, (name8, b8, b8_plain, err) in b8_typed.items()]
    return kernels, other_forms


def qm9_path(device, argv):
    """Phase 7: the shipped QM9_RGCN on the QM9-shaped batch through K2 and
    K1, at the QM9 plan's shapes. Returns their entries at this shape,
    which stay off the kernels line (K1 and K2 have theirs from phase 2)
    and are logged."""
    import torch

    from tf2_gnn_tpu_torch.models.qm9_regression_task import (
        QM9RegressionTask,
    )
    from tf2_gnn_tpu_torch.ops import pair_spmm as ps
    from tf2_gnn_tpu_torch.utils import tracing
    from tf2_gnn_tpu_torch.workloads import (
        QM9_FEATURE_DIM,
        build_qm9_batch,
        qm9_shipped_params,
    )

    zero = dict.fromkeys(tracing.counters("launch"), 0)

    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    batch, labels, molecules = build_qm9_batch(SEED, device=device)
    plan = batch.pair_stream_joint
    real_edges = int(batch.num_edges.sum())
    log(f"workload (QM9): {molecules} molecules, {real_edges} edges of "
        f"{plan.num_types} types, V={batch.num_nodes_padded}, "
        f"{batch.num_graphs_padded} graph slots, per-type forward / backward "
        f"chunks {[(p[0].shape[0], p[4].shape[0]) for p in batch.pair_plans_typed]}"
        f", forward group {ps.plan_group(plan.src_blk_f, plan.grp_tgt_fl)}, "
        f"backward group {ps.plan_group(plan.src_blk_b, plan.grp_tgt_b)}, "
        f"overflow slots {plan.ovf_src.shape[0]}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    params = qm9_shipped_params()
    checked = check_stream_kernels(plan, params["gnn_hidden_dim"], device)
    check_read_rows_kernels("QM9", plan, params["gnn_hidden_dim"], device,
                            timed=True)

    model = QM9RegressionTask.from_params(
        params, input_dim=QM9_FEATURE_DIM, num_edge_types=plan.num_types,
        device=device, seed=SEED)
    layers = params["gnn_num_layers"]
    log(f"model QM9_RGCN.json: {sum(p.numel() for p in model.parameters())} "
        f"parameters, {layers} layers, hidden {params['gnn_hidden_dim']}, "
        f"edge stream {params['gnn_edge_dtype']}, {params['optimizer']} "
        f"(lr {params['learning_rate']}, clip by value "
        f"{params['gradient_clip_value']}), global exchange after layers "
        f"{list(model.gnn.exchange_layers)}")
    tracing.reset()
    check_eval_forward(model, batch, labels, joint_patches(),
                       QM9_LOGIT_RTOL, QM9_ATOL, QM9_LOSS_RTOL,
                       shape=(batch.num_graphs_padded,))
    torch.cuda.synchronize()
    eval_launches = tracing.counters("launch")
    if eval_launches != dict(zero, pair_stream_joint=layers):
        raise AssertionError(f"QM9 eval forward launched {eval_launches}; "
                             f"expected pair_stream_joint {layers} times only")
    per_step = layers * TRAIN_STEPS
    state, train_step, eval_step, launches = train_and_count(
        model, params, batch, labels,
        dict(zero, pair_stream=per_step, pair_stream_joint=per_step,
             node_rows=per_step))
    log(f"QM9_RGCN: table_rows_share "
        f"{table_rows_share('QM9_RGCN', whole=False):.4f}")
    step_ms, eval_ms = time_path(state, train_step, eval_step, batch, labels,
                                 real_edges, device, argv, "QM9_RGCN")
    log(f"QM9_RGCN: {molecules / step_ms * 1e3:.1f} molecules/s training, "
        f"{molecules / eval_ms * 1e3:.1f} molecules/s evaluating")
    del model, state, train_step, eval_step
    torch.cuda.empty_cache()
    return stream_kernel_entries(plan, checked, launches)


# Phase 9's models: (name, shipped file, style, (K2, K1) launches a layer
# and train step, the eval check's tolerances, as above).
FLAVOUR_MODELS = (
    ("PPI_GGNN", "PPI_GGNN.json", "ggnn", (1, 1), GGNN_TOLS),
    ("PPI_RGIN", "PPI_RGIN.json", "rgin", (1, 1), RGIN_TOLS),
    ("PPI_GNN_Edge_MLP", "PPI_GNN_Edge_MLP.json", "gnn_edge_mlp", (0, 2),
     F32_STREAM_TOLS),
    ("PPI_GNN_FiLM", "PPI_GNN_FiLM.json", "gnn_film", (0, 2),
     F32_STREAM_TOLS),
)
FLAVOUR_H = 256  # the width of the per-type models' K1 calls


def check_typed_forms(plan, h: int, device):
    """K1 in the per-type op's two call forms on ``plan``
    (``StreamTypedPlan``): the forward (f32 [L*V, h] tables into the
    stacked [L*V] outputs, global output blocks) and the backward (an f32
    [L*V, h] cotangent, each type's groups reading its own slab, into the
    [L*V] table rows), each over its compact form, against the plain
    version; each bit-equal across two launches. Returns (tables, cot,
    {form: (kernel, plain version, args, compact)}, {form: max abs
    err})."""
    import torch

    from tf2_gnn_tpu_torch.ops import pair_spmm as ps

    rows = plan.out_rows
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    tables = torch.randn((plan.num_types * plan.v_src, h), generator=gen,
                         device=device)
    cot = torch.randn((rows, h), generator=gen, device=device)
    fwd = (tables, plan.scale_fwd, plan.rel_src_f, plan.rel_tgt_f,
           plan.src_blk_f, plan.grp_tgt_f, plan.grp_type_f, plan.v_src, rows)
    bwd = (cot, plan.scale_bwd, plan.rel_src_b, plan.rel_tgt_b,
           plan.src_blk_b, plan.grp_tgt_b, plan.grp_type_b, plan.v_out,
           plan.num_types * plan.v_src)
    fns = {}
    for form, args, compact in (("per-type forward", fwd, plan.fwd_rows),
                                ("per-type backward", bwd, plan.bwd_rows)):
        fns[form] = (
            lambda a=args, c=compact: ps.pair_spmm_stream(*a, compact=c),
            lambda a=args: ps.pair_spmm_stream_plain(*a), args, compact)
    errs = {}
    for form, (kernel_fn, plain_fn, _, _) in fns.items():
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        errs[form] = check_close(f"pair_stream {form}", got, want,
                                 KERNEL_RTOL, KERNEL_ATOL)
        check_repeatable(f"pair_stream {form}", kernel_fn, got)
        del got, want
    log("kernel check: " + ", ".join(
        f"pair_stream {form} max_abs_err {err:.3e}"
        for form, err in errs.items())
        + f" (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}; each bit-equal across "
        f"two launches); the compact forms: forward "
        f"{plan.fwd_rows.src_row.numel()} slots of "
        f"{plan.fwd_rows.num_slots} into {rows} rows, backward "
        f"{plan.bwd_rows.src_row.numel()} of {plan.bwd_rows.num_slots} into "
        f"{plan.num_types * plan.v_src}")
    return tables, cot, fns, errs


def typed_form_entries(checked, launches):
    """Time K1's two per-type call forms (``checked``, what
    ``check_typed_forms`` returned) beside their bounds and
    ``torch.sparse.mm`` of the forms' f32 CSR; returns their two entries,
    which stay off the kernels line (K1 has its entry from phase 2)."""
    import torch

    from tf2_gnn_tpu_torch.ops import pair_spmm as ps

    _, _, fns, errs = checked
    entries = []
    for form, (kernel_fn, plain_fn, args, compact) in fns.items():
        table, h = args[0], args[0].shape[1]
        a32, _, rows_read, valid = slot_matrix(
            *ps._stream_slot_abs_ids(*args[2:8]), args[1], args[8],
            table.shape[0])
        bound, bound_by = kernel_bound_ms(rows_read, h, table.element_size(),
                                          valid, args[8])
        entries.append(time_kernel(
            f"pair_stream {form}", "tf2_gnn_tpu_torch/csrc/pair_stream.cu",
            "tf2_gnn_tpu/ops/pair_spmm.py:895", launches[form], errs[form],
            kernel_fn, plain_fn, lambda a=a32, t=table: torch.sparse.mm(a, t),
            None, bound, bound_by,
            f"f32 [{table.shape[0]}, {h}] into {args[8]} rows, {valid} valid "
            f"of {args[2].numel()} slots, {rows_read} distinct rows read",
            device=True))
    return entries


def flavours_path(device, argv):
    """Phase 9: PPI_GGNN and PPI_RGIN through K2 and K1 (the joint op),
    PPI_GNN_Edge_MLP and PPI_GNN_FiLM through K1 in both directions (the
    per-type op), on the per-type-plan PPI batch. Returns no kernels-line
    entry (K1 and K2 have theirs from phase 2) and the entries of K1's two
    per-type call forms."""
    import torch

    from tf2_gnn_tpu_torch.utils import tracing
    from tf2_gnn_tpu_torch.workloads import build_ppi_batch, shipped_params

    zero = dict.fromkeys(tracing.counters("launch"), 0)

    t0 = time.perf_counter()
    batch, labels, real_edges = build_ppi_batch(SEED, device=device)
    plan = batch.pair_stream_typed
    log(f"workload (per-type plans, per-type aggregates): {real_edges} "
        f"edges, V={batch.num_nodes_padded}, {plan.out_rows} output rows, "
        f"{plan.rel_src_f.shape[0]} forward / {plan.rel_src_b.shape[0]} "
        f"backward chunks, {plan.ovf_src.shape[0]} overflow slots, "
        f"in-degrees {tuple(batch.in_degrees.shape)}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    checked = check_typed_forms(plan, FLAVOUR_H, device)

    patches = joint_patches()
    per_form = {"per-type forward": 0, "per-type backward": 0}
    for name, hypers, style, (k2, k1), tols in FLAVOUR_MODELS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        params = shipped_params(hypers, style)
        model = model_from_params(params, device, batch.num_edge_types,
                                  hypers)
        layers = params["gnn_num_layers"]
        atol, logit_rtol, loss_rtol = tols
        tracing.reset()
        check_eval_forward(model, batch, labels, patches, logit_rtol, atol,
                           loss_rtol)
        torch.cuda.synchronize()
        got = tracing.counters("launch")
        want = dict(zero, pair_stream_joint=k2 * layers,
                    pair_stream=0 if k2 else layers)
        if got != want:
            raise AssertionError(f"{name} eval forward launched {got}; "
                                 f"expected {want}")
        per_step = {"pair_stream_joint": k2 * layers,
                    "pair_stream": k1 * layers,
                    "node_rows": k2 * PPI_NODE_SUMS * layers}
        state, train_step, eval_step, launches = train_and_count(
            model, params, batch, labels,
            dict(zero,
                 **{n: c * TRAIN_STEPS for n, c in per_step.items()}))
        if k2 and not PPI_NODE_SUMS:
            table_rows_share(name, whole=True)
        log(f"{name}: per train step K2 {k2 * layers}, K1 {k1 * layers} "
            f"launches; nothing else launched")
        if not k2:
            for form in per_form:
                per_form[form] += launches["pair_stream"] // 2
        time_path(state, train_step, eval_step, batch, labels, real_edges,
                  device, argv, name)
        del model, state, train_step, eval_step
    torch.cuda.empty_cache()
    return [], typed_form_entries(checked, per_form)


# Phase 10's routes: (name, the params, the batch kind, launches a layer
# and train step of each counted wrapper, launches a layer of the eval
# forward, the eval check's tolerances, launches a layer and train step of
# each of 10a's call forms). The tolerances are those of the phases that
# run the same models (2, 4 and 9); the f32-stream routes differ from their
# plain versions only by the order of f32 sums. On the CPU, at the cut
# batches of tests/test_torch_chip_smoke.py, stand-ins for B3, B12 and K1
# that sum the same slots in a random order move the f32 routes' outputs
# by at most 8e-6 of the largest |output| (4.1e-5 of 5.1) and PPI_RGCN's
# bf16 logits by 1.1e-3; one edge type's scales doubled (B3, K1) or one
# chunk's slots doubled (B12) fail every route's check.
ROUTE_MODELS = (
    ("PPI_RGCN (merged plan)", "PPI_RGCN.json", "pairs",
     {"pair_spmm": 2}, {"pair_spmm": 1}, (MODEL_ATOL, 0.0, LOSS_RTOL),
     {"pair_spmm pairs forward": 1, "pair_spmm pairs backward": 1}),
    ("PPI_GNN_Edge_MLP (merged-target plan)", "PPI_GNN_Edge_MLP.json",
     "merged_targets", {"pair_spmm": 2}, {"pair_spmm": 1}, F32_STREAM_TOLS,
     {"pair_spmm merged-target forward": 1,
      "pair_spmm merged-target backward": 1}),
    ("PPI_GNN_FiLM (merged-target plan)", "PPI_GNN_FiLM.json",
     "merged_targets", {"pair_spmm": 2}, {"pair_spmm": 1}, F32_STREAM_TOLS,
     {"pair_spmm merged-target forward": 1,
      "pair_spmm merged-target backward": 1}),
    ("GNN_Edge_MLP reference default (scatter plans)",
     "edge_mlp_default_params()", "scatter", {"sorted_segment_sum": 5},
     {"sorted_segment_sum": 3}, (MODEL_ATOL, EDGE_MLP_LOGIT_RTOL, LOSS_RTOL),
     {"sorted_segment_sum stream bf16 320": 3,
      "sorted_segment_sum gathered bf16 320": 1,
      "sorted_segment_sum typed bf16 320": 1}),
    ("PPI_GNN_Edge_MLP (scatter plans)", "PPI_GNN_Edge_MLP.json", "scatter",
     {"sorted_segment_sum": 3}, {"sorted_segment_sum": 1}, F32_STREAM_TOLS,
     {"sorted_segment_sum stream f32 256": 1,
      "sorted_segment_sum gathered f32 256": 1,
      "sorted_segment_sum typed f32 256": 1}),
    ("PPI_GNN_FiLM source-only (scatter plans)",
     "PPI_GNN_FiLM.json, source-only", "scatter",
     {"sorted_segment_sum": 3}, {"sorted_segment_sum": 1}, F32_STREAM_TOLS,
     {"sorted_segment_sum stream f32 256": 1,
      "sorted_segment_sum gathered f32 256": 1,
      "sorted_segment_sum typed f32 512": 1}),
    ("GraphRegression_GNN_Edge_MLP (QM9 per-type plans)",
     "GraphRegression_GNN_Edge_MLP.json", "qm9", {"pair_stream": 2},
     {"pair_stream": 1}, F32_STREAM_TOLS, {}),
)


def route_params(source: str):
    """The hyperparameters of a phase 10 route, by their source."""
    from tf2_gnn_tpu_torch import workloads

    if source == "edge_mlp_default_params()":
        return workloads.edge_mlp_default_params()
    if source == "GraphRegression_GNN_Edge_MLP.json":
        return workloads.graph_regression_edge_mlp_params()
    if source == "PPI_GNN_FiLM.json, source-only":
        return dict(workloads.shipped_params("PPI_GNN_FiLM.json",
                                             "gnn_film"),
                    gnn_use_target_state_as_input=False)
    style = {"PPI_RGCN.json": "rgcn", "PPI_GNN_Edge_MLP.json":
             "gnn_edge_mlp", "PPI_GNN_FiLM.json": "gnn_film"}[source]
    return workloads.shipped_params(source, style)


def route_batch(kind: str, device):
    """(batch, labels, real edge count) of a phase 10 route's batch kind:
    phase 3's merged plan (``"pairs"``), phase 4's merged-target plan,
    phase 5's scatter plan, or phase 7's QM9 batch."""
    from tf2_gnn_tpu_torch.workloads import build_ppi_batch, build_qm9_batch

    if kind == "qm9":
        batch, labels, _ = build_qm9_batch(SEED, device=device)
        return batch, labels, int(batch.num_edges.sum())
    kwargs = {"pairs": dict(merged=True),
              "merged_targets": dict(merged=True, merge_targets=True),
              "scatter": dict(scatter=True)}[kind]
    return build_ppi_batch(SEED, device=device, **kwargs)


def route_model(params, batch, device, name: str):
    """The route's model on the card, random weights from the seed: the
    graph regression task on the QM9 batch, else node classification."""
    from tf2_gnn_tpu_torch.models.graph_regression_task import (
        GraphRegressionTask,
    )
    from tf2_gnn_tpu_torch.workloads import QM9_FEATURE_DIM

    if "graph_aggregation_layers" not in params:
        return model_from_params(params, device, batch.num_edge_types, name)
    model = GraphRegressionTask.from_params(
        params, input_dim=QM9_FEATURE_DIM,
        num_edge_types=batch.num_edge_types, device=device, seed=SEED)
    log(f"model {name}: {sum(p.numel() for p in model.parameters())} "
        f"parameters, {params['gnn_num_layers']} layers, hidden "
        f"{params['gnn_hidden_dim']}, edge stream {params['gnn_edge_dtype']}"
        f", {params['optimizer']} (lr {params['learning_rate']}, clip by "
        f"value {params['gradient_clip_value']})")
    return model


def compact_csr(compact, dtype):
    """The [out_rows, table_rows] CSR of a compact form's entries (one a
    stream row read, duplicates summed) in ``dtype``, B12's library
    yardstick."""
    import torch

    dev = compact.row_ptr.device
    rows = torch.repeat_interleave(
        torch.arange(compact.out_rows, device=dev),
        torch.diff(compact.row_ptr.long()))
    ones = torch.ones(rows.numel(), device=dev)
    coo = torch.sparse_coo_tensor(
        torch.stack([rows, compact.src_row.long()]), ones,
        (compact.out_rows, compact.table_rows)).coalesce()
    return torch.sparse_coo_tensor(
        coo.indices(), coo.values().to(dtype),
        coo.shape).coalesce().to_sparse_csr()


def merged_scatter_forms(batches, device):
    """Phase 10a: B3 over the merged plans' two directions (the
    ``"pairs"`` plan in bf16 at H = 320 with its 1/deg scales, the
    merged-target plan in f32 at H = 256 with unit scales) and B12's three
    forms over the scatter plan at the routes' widths, each over its
    compact form against its plain version, two launches bit-equal.
    Returns {form: (kernel, plain version, library calls, bound, detail,
    max abs err)}."""
    import torch

    from tf2_gnn_tpu_torch.ops import pair_spmm as ps
    from tf2_gnn_tpu_torch.ops import sorted_spmm as ss

    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    dtype_names = {torch.bfloat16: "bf16", torch.float32: "f32"}

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    forms = {}
    for kind, h, dtype, normalize in (("pairs", 320, torch.bfloat16, True),
                                      ("merged_targets", 256, torch.float32,
                                       False)):
        batch = batches[kind][0]
        plan = batch.pair_merged
        rows = batch.num_edge_types * batch.num_nodes_padded
        out_rows = plan.out_rows
        scales = ((plan.inv_fwd, plan.inv_bwd) if normalize
                  else ps.pair_unit_scales(plan, out_rows)[:2])
        label = {"pairs": "pairs", "merged_targets": "merged-target"}[kind]
        for direction, table_rows, into, arrays, scale, compact in (
                ("forward", rows, out_rows, plan.fwd, scales[0],
                 plan.fwd_rows(out_rows, rows)),
                ("backward", out_rows, rows, plan.bwd, scales[1],
                 plan.bwd_rows(rows, out_rows))):
            table = randn((table_rows, h), dtype)
            a32, a16, rows_read, valid = slot_matrix(
                *ps.slot_abs_ids(*arrays), scale, into, table_rows)
            bf16 = dtype == torch.bfloat16
            forms[f"pair_spmm {label} {direction}"] = (
                lambda t=table, s=scale, a=arrays, n=into, c=compact:
                ps.pair_spmm(t, s, *a, n, compact=c),
                lambda t=table, s=scale, a=arrays, n=into:
                ps.pair_spmm_plain(t, s, *a, n),
                (lambda a=(a16 if bf16 else a32), t=table:
                 torch.sparse.mm(a, t),
                 (lambda a=a32, t=table.float(): torch.sparse.mm(a, t))
                 if bf16 else None),
                kernel_bound_ms(rows_read, h, table.element_size(), valid,
                                into),
                f"{dtype_names[dtype]} [{table_rows}, {h}] -> f32 [{into}, "
                f"{h}], {valid} valid of {scale.numel()} slots, {rows_read} "
                f"distinct rows read")

    batch = batches["scatter"][0]
    plan = batch.scatter_merged
    v = batch.num_nodes_padded
    rows = batch.num_edge_types * v
    slots = plan.rel_tgt.numel()
    r_typed = ss.BLOCK_NODES * batch.num_edge_types
    calls = {
        "stream": lambda g, c: (
            lambda: ss.sorted_segment_sum(g, plan.rel_tgt, plan.tgt_blocks,
                                          v, compact=c),
            lambda: ss.sorted_segment_sum_plain(g, plan.rel_tgt,
                                                plan.tgt_blocks, v)),
        "gathered": lambda g, c: (
            lambda: ss.sorted_segment_sum_gathered(
                g, plan.bwd_to_fwd_idx, plan.bwd_sentinel, plan.rel_src,
                plan.src_blocks, rows, compact=c),
            lambda: ss.sorted_segment_sum_gathered_plain(
                g, plan.bwd_to_fwd_idx, plan.bwd_sentinel, plan.rel_src,
                plan.src_blocks, rows)),
        "typed": lambda g, c: (
            lambda: ss.sorted_segment_sum(g, plan.rel_typed, plan.tgt_blocks,
                                          rows, block_rows=r_typed,
                                          compact=c),
            lambda: ss.sorted_segment_sum_plain(g, plan.rel_typed,
                                                plan.tgt_blocks, rows,
                                                block_rows=r_typed)),
    }
    compacts = {"stream": plan.sum_rows("fwd", v),
                "gathered": plan.sum_rows("bwd_fused", rows),
                "typed": plan.sum_rows("fwd_typed", rows)}
    for form, dtype, h in (("stream", torch.bfloat16, 320),
                           ("stream", torch.float32, 256),
                           ("gathered", torch.bfloat16, 320),
                           ("gathered", torch.float32, 256),
                           ("typed", torch.bfloat16, 320),
                           ("typed", torch.float32, 256),
                           ("typed", torch.float32, 512)):
        stream = randn((slots, h), dtype)
        compact = compacts[form]
        a32 = compact_csr(compact, torch.float32)
        bf16 = dtype == torch.bfloat16
        a16 = compact_csr(compact, torch.bfloat16) if bf16 else None
        kernel_fn, plain_fn = calls[form](stream, compact)
        forms[f"sorted_segment_sum {form} {dtype_names[dtype]} {h}"] = (
            kernel_fn, plain_fn,
            (lambda a=(a16 if bf16 else a32), t=stream: torch.sparse.mm(a, t),
             (lambda a=a32, t=stream.float(): torch.sparse.mm(a, t))
             if bf16 else None),
            b12_bound_ms(compact, h * stream.element_size(), h),
            f"{dtype_names[dtype]} [{slots}, {h}] -> f32 [{compact.out_rows}, "
            f"{h}], {compact.src_row.numel()} entries")

    errs = {}
    for form, (kernel_fn, plain_fn, *_rest) in forms.items():
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        errs[form] = check_close(form, got, want, KERNEL_RTOL, KERNEL_ATOL)
        check_repeatable(form, kernel_fn, got)
        del got, want
    log("kernel check: " + ", ".join(f"{form} max_abs_err {err:.3e}"
                                     for form, err in errs.items())
        + f" (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}; each bit-equal across "
        "two launches)")
    return {form: forms[form] + (errs[form],) for form in forms}


def merged_scatter_path(device, argv):
    """Phase 10: the edge-MLP family on merged pair plans (B3 both ways,
    ``pair_typed_gather_scatter``), on merged-target plans (the factorised
    forms, B3) and on scatter plans (B12's three forms), and the shipped
    GraphRegression_GNN_Edge_MLP on the QM9 batch (K1). Returns no
    kernels-line entry and the entries of B3's and B12's new call
    forms."""
    import torch

    from tf2_gnn_tpu_torch.ops import pair_spmm as ps
    from tf2_gnn_tpu_torch.ops import sorted_spmm as ss
    from tf2_gnn_tpu_torch.utils import tracing

    zero = dict.fromkeys(tracing.counters("launch"), 0)

    t_phase = time.perf_counter()
    batches = {}
    for kind in ("pairs", "merged_targets", "scatter", "qm9"):
        t0 = time.perf_counter()
        batches[kind] = route_batch(kind, device)
        log(f"workload ({kind}): {batches[kind][2]} edges, V="
            f"{batches[kind][0].num_nodes_padded}, built in "
            f"{time.perf_counter() - t0:.1f} s")
    forms = merged_scatter_forms(batches, device)

    patches = [(ps, name, plain_version(plain)) for name, plain in (
        ("pair_spmm", ps.pair_spmm_plain),
        ("pair_spmm_stream", ps.pair_spmm_stream_plain),
        ("pair_spmm_stream_joint", ps.pair_spmm_stream_plain))]
    patches += [(ss, name, plain_version(getattr(ss, f"{name}_plain")))
                for name in (*ss.LAUNCHES, "sorted_segment_sum_gathered")]
    form_launches = {form: 0 for form in forms}
    for name, source, kind, per_layer, eval_per_layer, tols, \
            form_per_layer in ROUTE_MODELS:
        batch, labels, real_edges = batches[kind]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        held_gib = torch.cuda.memory_allocated(device) / 2**30
        params = route_params(source)
        model = route_model(params, batch, device, source)
        layers = params["gnn_num_layers"]
        route = model.gnn.mp_layer_0._route(batch)
        atol, logit_rtol, loss_rtol = tols
        tracing.reset()
        shape = ((batch.num_graphs_padded,) if kind == "qm9" else None)
        check_eval_forward(model, batch, labels, patches, logit_rtol, atol,
                           loss_rtol, shape=shape)
        torch.cuda.synchronize()
        got = tracing.counters("launch")
        want = dict(zero,
                    **{n: c * layers for n, c in eval_per_layer.items()})
        if got != want:
            raise AssertionError(f"{name} eval forward launched {got}; "
                                 f"expected {want}")
        state, train_step, eval_step, _ = train_and_count(
            model, params, batch, labels,
            dict(zero, **{
                n: c * layers * TRAIN_STEPS for n, c in per_layer.items()}))
        log(f"{name}: route {route}; per train step "
            + ", ".join(f"{n} {c * layers}" for n, c in per_layer.items())
            + " launches, nothing else launched; eval forward "
            + ", ".join(f"{n} {c * layers}"
                        for n, c in eval_per_layer.items()))
        for form, count in form_per_layer.items():
            form_launches[form] += count * layers * TRAIN_STEPS
        time_path(state, train_step, eval_step, batch, labels, real_edges,
                  device, argv, name)
        log(f"{name}: {held_gib:.2f} GiB were held before the route (the "
            "phase's batches and kernel inputs)")
        del model, state, train_step, eval_step
    torch.cuda.empty_cache()

    entries = []
    for form, (kernel_fn, plain_fn, (lib_fn, lib32_fn), (bound, bound_by),
               detail, err) in forms.items():
        b3 = form.startswith("pair_spmm")
        entries.append(time_kernel(
            form, "tf2_gnn_tpu_torch/csrc/pair_stream.cu",
            "tf2_gnn_tpu/ops/pair_spmm.py:678" if b3
            else "tf2_gnn_tpu/ops/spmm_pallas.py:442",
            form_launches[form], err, kernel_fn, plain_fn, lib_fn, lib32_fn,
            bound, bound_by, detail + f"; {form_launches[form]} launches in "
            "the routes' train steps", device=True))
    log(f"phase 10: {time.perf_counter() - t_phase:.1f} s")
    return [], entries


# Phase 11's models on the batches without plans, the unfused per-edge
# path: (name, the params' source, the batch, train steps, what the eval
# forward is held against, the check's tolerances (atol, share of the
# largest reference |logit|, loss rtol)). "fused": the same weights on the
# batch's per-type-plan form, whose route is fused; "cpu": the same model
# on the CPU, on the same batch (the options have no fused route). The
# tolerances are those of the phases that run the same models against
# their plain versions (2, 9, 10), held over the real rows (the padded
# edges reach the pad row on the unfused path alone): on both sides the
# same bf16 stream entries are summed in f32, in other orders. PPI_RGAT's
# fused route rounds its tables and scores to bf16 and stabilises by the
# bound, where the unfused path stays f32 under the exact max, so it is
# held to 1e-4 plus 2**-6 of the largest |logit| (four bf16 ulps) and
# 1e-3 of the loss. On the CPU, at the batches of
# tests/test_torch_chip_smoke.py, the unfused eval forwards lie within
# 3.6e-3 of the fused ones' largest |logit| 6.4 for PPI_RGCN, 3.4e-3 of
# 3.4 for PPI_RGIN, 2.3e-5 of 4.0 for PPI_GGNN, 3.0e-4 of 0.37 for
# PPI_RGAT and 4.5e-5 of 5.0 or less for the f32 models; with one edge
# type's messages doubled on the unfused side every check fails.
UNFUSED_RGAT_TOLS = (1e-4, 2.0 ** -6, LOSS_RTOL)
UNFUSED_MODELS = (
    ("PPI_RGCN (bench.py's \"xla\" path)", "PPI_RGCN.json", "ppi", 3,
     "fused", (MODEL_ATOL, 0.0, LOSS_RTOL)),
    ("GraphRegression_GNN_Edge_MLP (QM9, no plans)",
     "GraphRegression_GNN_Edge_MLP.json", "qm9", 3, "fused",
     F32_STREAM_TOLS),
    ("PPI_RGAT", "PPI_RGAT.json", "ppi", 2, "fused", UNFUSED_RGAT_TOLS),
    ("PPI_GGNN", "PPI_GGNN.json", "ppi", 2, "fused", GGNN_TOLS),
    ("PPI_RGIN", "PPI_RGIN.json", "ppi", 2, "fused", RGIN_TOLS),
    ("PPI_GNN_Edge_MLP", "PPI_GNN_Edge_MLP.json", "ppi", 2, "fused",
     F32_STREAM_TOLS),
    ("PPI_GNN_FiLM", "PPI_GNN_FiLM.json", "ppi", 2, "fused",
     F32_STREAM_TOLS),
    ("PPI_RGIN, mean aggregation", "PPI_RGIN.json, mean", "ppi", 2, "cpu",
     RGIN_TOLS),
    ("PPI_RGIN, max aggregation", "PPI_RGIN.json, max", "ppi", 2, "cpu",
     RGIN_TOLS),
    ("PPI_RGIN, sqrt_n aggregation", "PPI_RGIN.json, sqrt_n", "ppi", 2,
     "cpu", RGIN_TOLS),
    ("PPI_RGCN, activation before aggregation",
     "PPI_RGCN.json, activation before", "ppi", 2, "cpu",
     (MODEL_ATOL, 0.0, LOSS_RTOL)),
    ("GNN_Edge_MLP reference default, 2 hidden layers",
     "edge_mlp_default_params(), 2 hidden layers", "ppi", 2, "cpu",
     F32_STREAM_TOLS),
)
UNFUSED_TIMED_STEPS = 5  # train steps in each step-time window of phase 11


def unfused_params(source: str):
    """The hyperparameters of a phase 11 model, by their source: a shipped
    file or a phase 10 source, and the option it changes."""
    from tf2_gnn_tpu_torch import workloads

    base, _, option = source.partition(", ")
    if base == "edge_mlp_default_params()":
        return dict(workloads.edge_mlp_default_params(),
                    gnn_num_edge_MLP_hidden_layers=2)
    if base in ("PPI_RGAT.json", "PPI_GGNN.json", "PPI_RGIN.json"):
        params = workloads.shipped_params(
            base, base[len("PPI_"):-len(".json")].lower())
    else:
        params = route_params(base)
    if option in ("mean", "max", "sqrt_n"):
        params["gnn_aggregation_function"] = option
    elif option == "activation before":
        params["gnn_message_activation_before_aggregation"] = True
    return params


def unfused_batches(device):
    """Phase 11's batches by (kind, with plans): the PPI batch without a
    plan (``bench.py``'s ``"xla"`` batch) and with per-type plans (phase
    2's), the QM9 batch without a plan and with per-type plans (phase 7's);
    each (batch, labels, real edge count)."""
    from tf2_gnn_tpu_torch.workloads import build_ppi_batch, build_qm9_batch

    batches = {}
    for kind, build in (("ppi", build_ppi_batch), ("qm9", build_qm9_batch)):
        for plans in (False, True):
            t0 = time.perf_counter()
            batch, labels, _ = build(SEED, device=device, plans=plans)
            edges = int(batch.num_edges.sum())
            batches[kind, plans] = (batch, labels, edges)
            log(f"workload ({kind}, {'per-type plans' if plans else 'no plan'}"
                f"): {edges} edges, V={batch.num_nodes_padded}, built in "
                f"{time.perf_counter() - t0:.1f} s")
    return batches


def unfused_reference(model, batch, labels, against: str):
    """The eval forward phase 11 holds the card's against: (what, its
    outputs, the batch and labels it ran on)."""
    import copy

    import torch

    if against == "fused":
        route = model.gnn.mp_layer_0._route(batch)
        if route == "unfused":
            raise AssertionError("the per-type-plan batch took the unfused "
                                 "path")
        with torch.no_grad():
            out = model(batch, False)
        return f"unfused vs the same weights on the {route} route", out, \
            batch, labels
    cpu = torch.device("cpu")
    cpu_batch = batch.to(cpu)
    cpu_labels = {k: v.to(cpu) for k, v in labels.items()}
    with torch.no_grad():
        out = copy.deepcopy(model).to(cpu)(cpu_batch, False)
    return "card vs the CPU", out, cpu_batch, cpu_labels


def unfused_path(device, argv):
    """Phase 11: the unfused per-edge path on the batches without plans
    (``UNFUSED_MODELS``): each model's train steps launch no hand-written
    kernel; its eval forward is held against the same weights on a fused
    route, or against the CPU; its step and eval times beside the fused
    route's, and the peak memory."""
    import torch

    from tf2_gnn_tpu_torch.utils import tracing

    zero = dict.fromkeys(tracing.counters("launch"), 0)

    t_phase = time.perf_counter()
    batches = unfused_batches(device)
    log(f"phase 11: {torch.cuda.memory_allocated(device) / 2**30:.2f} GiB "
        "held before its models (its batches)")
    peak = 0
    for name, source, kind, steps, against, tols in UNFUSED_MODELS:
        bare, labels, edges = batches[kind, False]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        params = unfused_params(source)
        model = route_model(params, bare, device, name)
        layers = params["gnn_num_layers"]
        routes = {getattr(model.gnn, f"mp_layer_{i}")._route(bare)
                  for i in range(layers)}
        if routes != {"unfused"}:
            raise AssertionError(f"{name}: routes {routes} on the batch "
                                 "without plans")
        state, train_step, eval_step, _ = train_and_count(
            model, params, bare, labels, zero,
            steps=steps)
        log(f"{name}: no kernel launched in {steps} unfused train steps")
        ref_batch = batches[kind, True] if against == "fused" else \
            batches[kind, False]
        t_ref = time.perf_counter()
        what, out_ref, ref_batch, ref_labels = unfused_reference(
            model, *ref_batch[:2], against)
        log(f"{name}: the reference forward ({against}) in "
            f"{time.perf_counter() - t_ref:.1f} s")
        with torch.no_grad():
            out = model(bare, False)
        atol, logit_rtol, loss_rtol = tols
        # Real rows only: the padded edges reach the pad node's row on the
        # unfused path, never on a fused one, whose plans hold real edges.
        graphs = kind == "qm9"
        check_outputs_agree(
            what, model, bare, labels, out, out_ref, logit_rtol, atol,
            loss_rtol, shape=(bare.num_graphs_padded,) if graphs else None,
            ref_batch=ref_batch, ref_labels=ref_labels,
            rows=bare.num_graphs if graphs else bare.num_nodes)
        del out, out_ref
        time_path(state, train_step, eval_step, bare, labels, edges, device,
                  argv, f"{name}, unfused", steps=UNFUSED_TIMED_STEPS)
        peak = max(peak, torch.cuda.max_memory_allocated(device))
        if against == "fused":
            torch.cuda.reset_peak_memory_stats(device)
            fused, fused_labels, _ = batches[kind, True]
            # Warm-up: the plan's backward compact forms are built at the
            # first backward that reads them.
            for _ in range(2):
                train_step(state, fused, fused_labels)
            time_path(state, train_step, eval_step, fused, fused_labels,
                      edges, device, argv,
                      f"{name}, fused ({model.gnn.mp_layer_0._route(fused)})",
                      steps=UNFUSED_TIMED_STEPS)
            peak = max(peak, torch.cuda.max_memory_allocated(device))
        del model, state, train_step, eval_step
    torch.cuda.empty_cache()
    log(f"phase 11: {time.perf_counter() - t_phase:.1f} s, peak memory "
        f"{peak / 2**30:.2f} GiB")


# Phase 12's command-line runs: (name, the train entry's argv before the
# data path, after it, the dataset, the eval check's tolerances on the first
# TRAIN batch (atol, share of the largest |output|, loss rtol; phases 2 and
# 7's for the same models) or None, whether the test entry reloads its
# best checkpoint, and the node sums a layer and train step: 1 where the
# batches' plans read so few of their tables' rows that the tables hold
# only those, as QM9's, which ``CliRecorder`` also checks on the first
# TRAIN batch with ``check_read_rows_kernels``).
CLI_RUNS = (
    ("PPI_RGCN", ["RGCN", "PPI"], ["--max-epochs", "2"], "ppi",
     (MODEL_ATOL, 0.0, LOSS_RTOL), True, PPI_NODE_SUMS),
    ("QM9_RGCN", ["RGCN", "QM9"], ["--max-epochs", "2"], "qm9",
     (QM9_ATOL, QM9_LOGIT_RTOL, QM9_LOSS_RTOL), True, 1),
    ("PPI_GGNN_remat_bf16", ["GGNN", "PPI"],
     ["--max-epochs", "1", "--gnn_use_remat", "True", "--gnn_dense_dtype",
      "bfloat16"], "ppi", None, False, PPI_NODE_SUMS),
)


def batch_arrays(batch):
    """A host ``GraphBatch``'s arrays by name: the packed nodes and edges,
    the in-degrees and every plan array."""
    arrays = {"node_features": batch.node_features,
              "node_to_graph": batch.node_to_graph,
              "num_edges": batch.num_edges, "in_degrees": batch.in_degrees}
    for t, (s, g) in enumerate(zip(batch.edge_sources, batch.edge_targets)):
        arrays[f"edge_sources[{t}]"], arrays[f"edge_targets[{t}]"] = s, g
    for name in ("pair_plans", "scatter_plans"):
        for i, a in enumerate(getattr(batch, name) or ()):
            arrays[f"{name}[{i}]"] = a
    for t, plans in enumerate(batch.pair_plans_typed or ()):
        for i, a in enumerate(plans):
            arrays[f"pair_plans_typed[{t}][{i}]"] = a
    return arrays


def check_same_batch(what: str, got, want) -> None:
    """Two host batches hold the same arrays, bit for bit."""
    import numpy as np

    got, want = batch_arrays(got), batch_arrays(want)
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: arrays {sorted(got)} vs "
                             f"{sorted(want)}")
    for name, a in got.items():
        b = want[name]
        if a is None or b is None:
            if (a is None) != (b is None):
                raise AssertionError(f"{what}: {name} is None on one side")
            continue
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(
                a, b):
            raise AssertionError(f"{what}: {name} differs")


def check_num_batches(name: str, dataset) -> None:
    """``num_batches(fold)`` of a run's dataset against the batches the
    fold's epoch yields: on VALIDATION and TEST their count; on TRAIN the
    count of the epoch drawn from the ``rng`` state that ``num_batches``
    started from, which it must leave where that epoch leaves it (one
    permutation drawn)."""
    import numpy as np

    from tf2_gnn_tpu_torch.data.graph_dataset import DataFold

    counts = {}
    for fold in (DataFold.VALIDATION, DataFold.TEST):
        counts[fold.name] = (dataset.num_batches(fold), sum(
            1 for _ in dataset.batch_iterator(fold)))
    rng = dataset._rng
    start = rng.get_state()
    counted = dataset.num_batches(DataFold.TRAIN)
    after = rng.get_state()
    rng.set_state(start)
    counts["TRAIN"] = (counted, sum(
        1 for _ in dataset.batch_iterator(DataFold.TRAIN)))
    in_step = all(np.array_equal(a, b)
                  for a, b in zip(after, rng.get_state()))
    log(f"{name}: num_batches against the epoch's batches by fold: "
        f"{counts}; TRAIN's shuffle draws in step: {in_step}")
    if not in_step or any(n != m for n, m in counts.values()):
        raise AssertionError(f"{name}: num_batches by fold {counts} (ours, "
                             f"the epoch's); TRAIN's draws in step: "
                             f"{in_step}")


class CliRecorder:
    """What phase 12 reads of one command-line training run, through
    patches of the harness's own functions (``patches``): per finalised
    batch the host ms of packing and planning, the planners that ran
    (``native.PLANNED``: the C++ binding, or the numpy planner where a
    plan spilled) and the edges its plans spilled; for each batch of the
    first epoch the same batch finalised again on the numpy forms
    (``native.numpy_forms()``), timed, and held array-identical; per train
    epoch the steps, each step's device span (CUDA events around the step),
    the kernels launched (launch counts read before and after the epoch)
    and the loss; the first TRAIN batch's ``.to(device)`` and first
    compact forms (synchronised), and its eval forward against the plain
    versions; the model, dataset and weights of the last checkpoint
    written."""

    def __init__(self, name, tols, device, profile: bool,
                 node_sums: int):
        import threading

        self.name, self.tols, self.node_sums = name, tols, node_sums
        self.device, self.profile = device, profile
        self.batches, self.epochs = [], []
        self.first = None
        self.saved = None
        self._local = threading.local()

    def patches(self):
        from tf2_gnn_tpu_torch.data import graph_dataset
        from tf2_gnn_tpu_torch.harness import run, training

        return _patched([
            (graph_dataset.GraphDataset, "_finalise_batch",
             self._finalise(graph_dataset.GraphDataset._finalise_batch)),
            (graph_dataset, "build_pair_plans",
             self._plans(graph_dataset.build_pair_plans)),
            (training, "run_train_epoch",
             self._epoch(training.run_train_epoch)),
            (run, "save_model", self._save(run.save_model)),
        ])

    def _finalise(self, original):
        from tf2_gnn_tpu_torch import native

        def timed(dataset, batch_graphs, config):
            self._local.plan_s, self._local.spilled = 0.0, 0
            before = native.PLANNED.copy()
            t0 = time.perf_counter()
            out = original(dataset, batch_graphs, config)
            total = time.perf_counter() - t0
            return out, dict(pack=total - self._local.plan_s,
                             plan=self._local.plan_s,
                             spilled=self._local.spilled,
                             planners=dict(native.PLANNED - before))

        def finalise(dataset, batch_graphs, config):
            out, record = timed(dataset, batch_graphs, config)
            if not self.epochs:
                with native.numpy_forms():
                    ref, numpy_record = timed(dataset, batch_graphs, config)
                check_same_batch(f"{self.name} batch {len(self.batches)} "
                                 "(binding vs numpy forms)", out[0], ref[0])
                record["numpy"] = numpy_record
            self.batches.append(record)
            return out
        return finalise

    def _plans(self, original):
        def build(*args, **kwargs):
            t0 = time.perf_counter()
            plans = original(*args, **kwargs)
            self._local.plan_s += time.perf_counter() - t0
            # Sentinel overflow targets are the output row count (args[3]).
            self._local.spilled += int((plans.ovf_tgt < args[3]).sum())
            return plans
        return build

    def _first_batch(self, model, batch, labels):
        """The first TRAIN batch: ``.to(device)``, its joint plan and that
        plan's compact forms, each timed between synchronisations; where
        the run's tables hold only the rows its plans read
        (``node_sums``), the three launches over those rows' forms
        (``check_read_rows_kernels``); and the eval forward against the
        plain versions."""
        import torch

        from tf2_gnn_tpu_torch.harness.training import to_device

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch, labels = to_device(batch, labels, self.device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        plan = batch.pair_stream_joint
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        _ = (plan.fwd_rows, plan.bwd_rows)
        torch.cuda.synchronize()
        self.first = ((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                      (time.perf_counter() - t2) * 1e3)
        if self.node_sums:
            check_read_rows_kernels(self.name, plan,
                                    model.gnn.mp_layer_0.hidden_dim,
                                    self.device)
        if self.tols is not None:
            atol, logit_rtol, loss_rtol = self.tols
            graphs = "target_value" in labels
            check_eval_forward(
                model, batch, labels, joint_patches(),
                logit_rtol, atol, loss_rtol,
                shape=(batch.num_graphs_padded,) if graphs else None)

    def _epoch(self, original):
        import itertools

        import torch

        from tf2_gnn_tpu_torch.utils import tracing

        zero = dict.fromkeys(tracing.counters("launch"), 0)

        def epoch(train_step, state, batches, device=None, **kwargs):
            if not self.epochs:
                batches = iter(batches)
                first = next(batches)
                self._first_batch(state.model, *first)
                batches = itertools.chain([first], batches)
            spans = []

            def timed_step(state, batch, labels):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = train_step(state, batch, labels)
                end.record()
                spans.append((start, end))
                return out

            # Read, not reset: the dataset's worker thread plans batches
            # meanwhile, and ``native.PLANNED`` counts them.
            before = tracing.counters("launch")
            t0 = time.perf_counter()
            if self.profile:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    result = original(timed_step, state, batches, device,
                                      **kwargs)
                    torch.cuda.synchronize()
            else:
                result = original(timed_step, state, batches, device,
                                  **kwargs)
            torch.cuda.synchronize()
            epoch_ms = (time.perf_counter() - t0) * 1e3
            launches = {n: c - before[n]
                        for n, c in tracing.counters("launch").items()}
            gnn = state.model.gnn
            steps = len(spans)
            forward = gnn.num_layers * steps * (2 if gnn.use_remat else 1)
            expected = dict(zero,
                            pair_stream=gnn.num_layers * steps,
                            pair_stream_joint=forward,
                            node_rows=gnn.num_layers * steps * self.node_sums)
            if launches != expected:
                raise AssertionError(
                    f"{self.name} epoch {len(self.epochs) + 1}: launches "
                    f"{ {k: v for k, v in launches.items() if v} } in "
                    f"{steps} steps; expected K1 (pair_stream) "
                    f"{expected['pair_stream']}, K2 (pair_stream_joint) "
                    f"{forward} and node sums (node_rows) "
                    f"{expected['node_rows']}, every other kernel 0")
            loss, graphs_per_s = result[1], result[2]
            if not math.isfinite(loss):
                raise AssertionError(f"{self.name}: train loss {loss}")
            self.epochs.append(dict(
                steps=steps, loss=loss, graphs_per_s=graphs_per_s,
                step_ms=[s.elapsed_time(e) for s, e in spans],
                k1=launches["pair_stream"],
                k2=launches["pair_stream_joint"],
                node_sums=launches["node_rows"]))
            if self.profile:
                kernels = kernel_events(prof)
                busy_ms = sum(_self_device_us(e) for e in kernels) / 1e3
                log(f"{self.name} epoch {len(self.epochs)} profile: kernel "
                    f"time {busy_ms:.3f} ms of a {epoch_ms:.3f} ms profiled "
                    f"epoch (device busy share {busy_ms / epoch_ms:.3f})")
                log_kernels(kernels, steps)
            return result
        return epoch

    def _save(self, original):
        def save(path, model, model_params, dataset, **kwargs):
            original(path, model, model_params, dataset, **kwargs)
            self.saved = (model, dataset, {
                k: v.detach().clone() for k, v in model.state_dict().items()})
        return save

    def report(self, seconds: float, peak_bytes: int) -> None:
        def mean_ms(records, key):
            return 1e3 * sum(r[key] for r in records) / len(records)

        spilled = [b["spilled"] for b in self.batches]
        compared = [b for b in self.batches if "numpy" in b]
        numpy_forms = [b["numpy"] for b in compared]
        log(f"{self.name}: {len(self.batches)} batches finalised, host ms "
            f"a batch: pack {mean_ms(self.batches, 'pack'):.1f}, plan "
            f"{mean_ms(self.batches, 'plan'):.1f}; the first epoch's "
            f"{len(compared)} batches, binding vs numpy forms: pack "
            f"{mean_ms(compared, 'pack'):.1f} vs "
            f"{mean_ms(numpy_forms, 'pack'):.1f}, plan "
            f"{mean_ms(compared, 'plan'):.1f} vs "
            f"{mean_ms(numpy_forms, 'plan'):.1f}, batches and plans "
            "array-identical; first TRAIN batch: "
            f".to(device) {self.first[0]:.1f} ms, joint plan (host build "
            f"and copy) {self.first[1]:.1f} ms, its forward and backward "
            f"compact forms {self.first[2]:.1f} ms")
        log(f"{self.name}: planners a batch, in finalising order: "
            f"{[b['planners'] for b in self.batches]}")
        if not all(b["planners"].get("pair binding") for b in self.batches):
            raise AssertionError(f"{self.name}: a batch was planned without "
                                 "the C++ binding")
        if any(spilled):
            log(f"{self.name}: overflow edges spilled a batch, in finalising "
                f"order: {spilled}")
        else:
            slots = self.saved[1].padding_config.pair_overflow
            log(f"{self.name}: no batch spilled an edge into its overflow "
                f"slots (each type's plan holds {slots}); "
                "tests/test_torch_datasets.py::test_spilled_batch_matches_jax"
                " carries the spilled case")
        for i, e in enumerate(self.epochs, 1):
            step_ms = sorted(e["step_ms"])
            log(f"{self.name} epoch {i}: {e['steps']} steps, loss "
                f"{e['loss']:.6f}, {e['graphs_per_s']:.2f} graphs/s, step "
                f"ms (device span) {[round(x, 3) for x in e['step_ms']]}, "
                f"K1 {e['k1']}, K2 {e['k2']}, node sums {e['node_sums']}")
        log(f"{self.name}: {seconds:.1f} s, peak memory "
            f"{peak_bytes / 2**30:.2f} GiB")


def cli_path(device, argv):
    """Phase 12: train and test from the command line. Datasets written
    from the seed in the loaders' formats; ``CLI_RUNS`` through the train
    entry's own ``run`` (in process, so the kernels are built once) with
    ``CliRecorder`` watching, then the test entry on the best checkpoints,
    whose TEST metric must equal the saved model's in memory."""
    import torch

    from tf2_gnn_tpu_torch import workloads
    from tf2_gnn_tpu_torch.cli import test as cli_test
    from tf2_gnn_tpu_torch.cli import train as cli_train
    from tf2_gnn_tpu_torch.data.graph_dataset import DataFold
    from tf2_gnn_tpu_torch.harness.training import (
        make_eval_step,
        run_eval_epoch,
    )

    t_phase = time.perf_counter()
    root = ROOT / "build" / "phase12"
    data = {"ppi": workloads.write_ppi_files(root / "ppi", SEED),
            "qm9": workloads.write_qm9_files(root / "qm9", SEED)}
    log(f"phase 12: PPI files ({workloads.PPI_FOLD_GRAPHS} graphs of "
        f"{workloads.NODES_PER_GRAPH} nodes, {workloads.FWD_EDGES_PER_GRAPH} "
        f"forward links each) and QM9 files ({workloads.QM9_FOLD_MOLECULES} "
        f"molecules) written in {time.perf_counter() - t_phase:.1f} s")
    for name, head, tail, kind, tols, reload, node_sums in CLI_RUNS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        recorder = CliRecorder(name, tols, device, "--profile" in argv,
                               node_sums)
        with recorder.patches():
            best = cli_train.run(
                head + [str(data[kind]), "--save-dir", str(root / "trained"),
                        "--run-name", name, "--seed", str(SEED), "--quiet",
                        "--device", str(device)] + tail)
        recorder.report(time.perf_counter() - t0,
                        torch.cuda.max_memory_allocated(device))
        model, dataset, weights = recorder.saved
        dataset.load_data(data[kind], {DataFold.TEST})
        check_num_batches(name, dataset)
        if not reload:
            continue
        model.load_state_dict(weights)
        _, _, results = run_eval_epoch(make_eval_step(model),
                                       dataset.batch_iterator(DataFold.TEST),
                                       device)
        in_memory = model.compute_epoch_metrics(results)[0]
        del model, dataset, weights, recorder
        t0 = time.perf_counter()
        reloaded = cli_test.run([str(best), str(data[kind]), "--device",
                                 str(device)])
        log(f"{name}: test entry on {best.name}: TEST metric {reloaded!r} "
            f"in {time.perf_counter() - t0:.1f} s; the saved model in "
            f"memory: {in_memory!r}")
        if not (math.isfinite(reloaded)
                and abs(reloaded - in_memory) <= 1e-6 * max(1.0,
                                                             abs(in_memory))):
            raise AssertionError(f"{name}: the reloaded checkpoint's TEST "
                                 f"metric {reloaded} differs from the model "
                                 f"in memory's {in_memory}")
    torch.cuda.empty_cache()
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s")


# Phase 13: the kernel wrappers each flavour's fused route launches in one
# run of a dump (``reference_parity.run``: the encoder's eval forward, the
# model's forward and one backward), per layer; the runs without plans
# launch none. The dumps' small batches read 0.47 to 0.80 of their tables'
# rows, so on the pair-joint route the tables hold only those rows, and
# the products' input gradient is summed by node once a layer.
REFERENCE_LAUNCHES = {
    "RGCN": {"pair_stream_joint": 2, "pair_stream": 1, "node_rows": 1},
    "GGNN": {"pair_stream_joint": 2, "pair_stream": 1, "node_rows": 1},
    "RGIN": {"pair_stream_joint": 2, "pair_stream": 1, "node_rows": 1},
    "GNN_FiLM": {"pair_stream": 3},
    "GNN_Edge_MLP": {"pair_stream": 3},
    "RGAT": {"pair_attention_expd": 2, "pair_spmm": 8,
             "pair_attention_bwd_fused": 1},
}
# Phase 13d's check of the encoder on a ``GNNInput`` batch against the same
# graphs batched by the dataset (f32 edge stream): states within
# GNN_INPUT_ATOL plus GNN_INPUT_RTOL of the largest |reference entry|,
# gradients within GNN_INPUT_GRAD_RTOL of each tensor's largest entry. The
# GNNInput batch's message activation (relu) takes the dataset batch's
# signs (``relu_inputs``): the unfused route's sums, which add in no fixed
# order on the card, put a relu input that lies within rounding of 0 on
# either side of it from run to run, and one such input moved a weight's
# gradient by 0.6% of its largest entry on an H100. Each relu input whose
# sign the two runs disagree on must lie
# within the states' tolerance of 0 (``check_relu_flips``).
GNN_INPUT_ATOL = 1e-4
GNN_INPUT_RTOL = 2.0 ** -12
GNN_INPUT_GRAD_RTOL = 1e-3


def reference_run(dump, data, kind: str, device):
    """Phase 13 on one dump and plan kind: the dump's data through the
    port's loaders (the batch checked against the dump's), its weights
    imported, then one eval forward and one backward on ``device`` with
    every launch count set to 0 just before and read just after, held
    against the dump at the parity test's tolerances. Returns (route of
    layer 0, launches, ``reference_parity.compare``'s report)."""
    import torch

    from tf2_gnn_tpu_torch.harness import reference_parity as rp
    from tf2_gnn_tpu_torch.utils import tracing

    model, dataset = rp.build(dump, data, kind, device)
    batch, labels = rp.first_batch(dataset)
    rp.check_batch(batch, labels, dump)
    rp.import_weights(model, dump)
    route = model.gnn.mp_layer_0._route(batch.to(device))
    if (route == "unfused") != (kind == "none"):
        raise AssertionError(f"{dump.name} on {kind} plans takes route "
                             f"{route}")
    tracing.reset()
    outputs = rp.run(model, batch, labels)
    torch.cuda.synchronize()
    launches = _launches()
    layers = model.gnn.num_layers
    expected = {} if kind == "none" else {
        n: c * layers for n, c in REFERENCE_LAUNCHES[dump.model].items()}
    if launches != expected:
        raise AssertionError(f"{dump.name} on {kind} plans launched "
                             f"{launches}; expected {expected}")
    return route, launches, rp.compare(outputs, dump)


def gnn_input_case(device, ppi_dir: Path):
    """Phase 13d's encoder and batches. A ``GNNInput`` of the 3 VALIDATION
    graphs of the PPI files (their real rows, as the dataset batched
    them), padded by ``batch_from_gnn_input`` (no plans, the unfused
    route), the dataset's batch of the same graphs (per-type plans, K2 and
    K1), and ``GNN`` at PPI_RGCN's width (f32 edge stream, random weights
    from the seed). Returns (``run``, the GNNInput batch, the dataset's
    batch, real rows, real edges): ``run(batch, pinned)`` is one forward
    and one backward of the encoder on ``batch`` under ``relu_inputs(v,
    pinned)``, with every launch count set to 0 just before and read just
    after, returning (the real rows of the final and every layer's states,
    {parameter: gradient}, {kernel: launches}, the relu inputs)."""
    import numpy as np
    import torch

    from tf2_gnn_tpu_torch import workloads
    from tf2_gnn_tpu_torch.data import DataFold, PPIDataset
    from tf2_gnn_tpu_torch.harness.config import (
        load_default_hypers,
        merge_params,
    )
    from tf2_gnn_tpu_torch.layers import GNN, GNNInput, batch_from_gnn_input
    from tf2_gnn_tpu_torch.utils import tracing

    if not (ppi_dir / "valid_graph.json").exists():
        workloads.write_ppi_files(ppi_dir, SEED)
    shipped = load_default_hypers("PPI", "RGCN")
    dataset = PPIDataset(merge_params(PPIDataset.get_default_hyperparameters(),
                                      shipped["task_params"]),
                         rng=np.random.RandomState(SEED))
    dataset.load_data(ppi_dir, {DataFold.VALIDATION})
    planned, _ = next(iter(dataset.batch_iterator(DataFold.VALIDATION)))
    v = planned.num_nodes
    counts = [int(c) for c in planned.num_edges]
    gnn_input = GNNInput(
        node_features=planned.node_features[:v],
        adjacency_lists=[np.stack([s[:c], t[:c]], axis=1) for s, t, c in zip(
            planned.edge_sources, planned.edge_targets, counts)],
        node_to_graph_map=planned.node_to_graph[:v],
        num_graphs=planned.num_graphs)
    bare = batch_from_gnn_input(gnn_input).to(device)
    planned = planned.to(device)
    params = {k[len("gnn_"):]: value for k, value in merge_params(
        workloads.shipped_params("PPI_RGCN.json", "rgcn"),
        {"gnn_edge_dtype": "float32"}).items() if k.startswith("gnn_")}
    gnn = GNN.from_params(params, input_dim=workloads.FEATURE_DIM,
                          num_edge_types=dataset.num_edge_types)
    gnn.reset_parameters(torch.Generator().manual_seed(SEED))
    gnn = gnn.to(device)
    routes = (gnn.mp_layer_0._route(bare), gnn.mp_layer_0._route(planned))
    if routes != ("unfused", "pair_joint"):
        raise AssertionError(f"GNNInput batch / dataset batch routes {routes}")
    cot = torch.randn((v, gnn.hidden_dim),
                      generator=torch.Generator().manual_seed(SEED + 13)
                      ).to(device)

    def run(batch, pinned):
        tracing.reset()
        gnn.zero_grad(set_to_none=True)
        with relu_inputs(v, pinned) as inputs:
            final, reps = gnn(batch, False)
            (final[:v] * cot).sum().backward()
        torch.cuda.synchronize()
        return ([final[:v].detach()] + [r[:v].detach() for r in reps],
                {n: p.grad.detach().clone()
                 for n, p in gnn.named_parameters()},
                _launches(), inputs)

    return run, bare, planned, v, sum(counts)


def gradient_shares(got, want):
    """{parameter: largest |got - want| as a share of its largest |want|}."""
    return {name: float((got[name] - w).abs().max())
            / max(float(w.abs().max()), 1e-30) for name, w in want.items()}


def gnn_input_check(device, ppi_dir: Path) -> None:
    """Phase 13d: the public API at full width (``gnn_input_case``). The
    dataset's batch runs first (K2 and K1 once a layer), then the GNNInput
    batch (no kernel launched) with its relu keeping the first run's signs
    (``relu_inputs``, ``GNN_INPUT_*``); the two are held together over the
    real rows, states and gradients."""
    import torch

    t0 = time.perf_counter()
    run, bare, planned, v, edges = gnn_input_case(device, ppi_dir)
    want = run(planned, None)
    got = run(bare, [x > 0 for x in want[3]])
    layers = len(want[3])
    planned_launches = {"pair_stream_joint": layers, "pair_stream": layers}
    if PPI_NODE_SUMS:
        planned_launches["node_rows"] = layers * PPI_NODE_SUMS
    expected = ({}, planned_launches)
    if (got[2], want[2]) != expected:
        raise AssertionError(f"GNNInput batch launched {got[2]}, the "
                             f"dataset batch {want[2]}; expected "
                             f"{expected}")
    flips, flip_max = check_relu_flips(got[3], want[3])
    state_err = 0.0
    for g, w in zip(got[0], want[0]):
        if not torch.isfinite(g).all():
            raise AssertionError("GNNInput batch: non-finite states")
        err = float((g - w).abs().max())
        limit = GNN_INPUT_ATOL + GNN_INPUT_RTOL * float(w.abs().max())
        if err > limit:
            raise AssertionError(f"GNNInput batch: states differ by {err} "
                                 f"from the dataset batch's (limit {limit})")
        state_err = max(state_err, err / limit)
    shares = gradient_shares(got[1], want[1])
    for name, share in shares.items():
        if not share <= GNN_INPUT_GRAD_RTOL:
            raise AssertionError(f"GNNInput batch: gradient of {name} "
                                 f"differs by {share} of its largest entry")
    log(f"phase 13d: GNNInput of {planned.num_graphs} graphs ({v} nodes, "
        f"{edges} edges) padded to V = {bare.num_nodes_padded} (the "
        f"dataset's: {planned.num_nodes_padded}), GNN at hidden "
        f"{want[0][0].shape[1]}, {layers} layers, f32: routes "
        f"('unfused', 'pair_joint'), launches {got[2]} / {want[2]}; relu "
        f"inputs on opposite sides of 0 in the two runs {flips} (largest "
        f"|x| {flip_max:.3g}); states within {state_err:.3g} of their "
        f"limit ({GNN_INPUT_ATOL} + {GNN_INPUT_RTOL:.3g} of the largest), "
        f"gradients within {max(shares.values()):.3g} of their largest "
        f"entries (limit {GNN_INPUT_GRAD_RTOL}); "
        f"{time.perf_counter() - t0:.1f} s")


HOOK_FACTOR = 0.75  # phase 13e's input hook scales the features by it


def hook_check(device, argv) -> None:
    """Phase 13e: ``GraphTaskModel.compute_initial_node_features`` at full
    width. A subclass of the shipped PPI_RGCN whose hook returns the
    features times ``HOOK_FACTOR`` (a new tensor, so ``forward`` replaces
    the batch) takes ``TRAIN_STEPS`` train steps on phase 2's bench batch:
    K1 and K2 once a layer and step, every other kernel 0, and the joint
    plan (``stream_joint_plan``) built once for the batch, since the
    replaced batch shares its plan forms. Its eval logits after training
    equal, bit for bit, those of the base model with the same weights on
    the batch transformed beforehand. The train step is timed as phase 2
    times its own and logged beside phase 2's, with the card's name and
    power limit."""
    import torch

    from tf2_gnn_tpu_torch.data import graph_batch
    from tf2_gnn_tpu_torch.models.node_multiclass_task import (
        NodeMulticlassTask,
    )
    from tf2_gnn_tpu_torch.utils import tracing
    from tf2_gnn_tpu_torch.workloads import (
        FEATURE_DIM,
        NUM_LABELS,
        build_ppi_batch,
        shipped_params,
    )

    zero = dict.fromkeys(tracing.counters("launch"), 0)

    class ScaledInput(NodeMulticlassTask):
        def compute_initial_node_features(self, batch, training,
                                          generator=None):
            return batch.node_features * HOOK_FACTOR

    t0 = time.perf_counter()
    params = shipped_params("PPI_RGCN.json", "rgcn")
    batch, labels, real_edges = build_ppi_batch(SEED, device=device)

    def model(cls):
        return cls.from_params(params, input_dim=FEATURE_DIM,
                               num_edge_types=batch.num_edge_types,
                               device=device, seed=SEED,
                               num_labels=NUM_LABELS)

    hooked = model(ScaledInput)
    builds = []
    build = graph_batch.stream_joint_plan

    def counted(*args, **kwargs):
        builds.append(1)
        return build(*args, **kwargs)

    layers = params["gnn_num_layers"]
    with mock.patch.object(graph_batch, "stream_joint_plan", counted):
        state, train_step, eval_step, launches = train_and_count(
            hooked, params, batch, labels,
            dict(zero, pair_stream=layers * TRAIN_STEPS,
                 pair_stream_joint=layers * TRAIN_STEPS,
                 node_rows=layers * TRAIN_STEPS * PPI_NODE_SUMS),
            steps=TRAIN_STEPS)
    if len(builds) != 1:
        raise AssertionError(f"the hook's {TRAIN_STEPS} train steps and "
                             f"eval forward built the joint plan "
                             f"{len(builds)} times; expected once for the "
                             "batch")

    base = model(NodeMulticlassTask)
    base.load_state_dict(hooked.state_dict())
    hooked.eval()
    base.eval()
    with torch.no_grad():
        got = hooked(batch, False)[0]
        want = base(batch.replace(
            node_features=batch.node_features * HOOK_FACTOR), False)[0]
    if not (bool(torch.isfinite(got).all()) and torch.equal(got, want)):
        raise AssertionError(
            f"the hook's eval logits differ from the base model's on the "
            f"transformed batch by {float((got - want).abs().max())}")
    step_ms, _ = time_path(state, train_step, eval_step, batch, labels,
                           real_edges, device, argv,
                           "PPI_RGCN with the input hook", steps=TIMED_STEPS)
    log(f"phase 13e: input hook on PPI_RGCN ({layers} layers, hidden "
        f"{params['gnn_hidden_dim']}, edge stream {params['gnn_edge_dtype']}"
        f"): {TRAIN_STEPS} train steps with K1 {launches['pair_stream']} "
        f"and K2 {launches['pair_stream_joint']} launches (node sums "
        f"{launches['node_rows']}), the joint plan "
        f"built {len(builds)} time(s), eval logits bit-equal to the base "
        f"model's on the transformed batch; "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"phase 13e: train step with the hook {step_ms:.3f} ms, phase 2's "
        f"without it {STEP_MS.get('PPI_RGCN', float('nan')):.3f} ms "
        f"({TIMED_STEPS} steps each; {card_line()})")


@contextlib.contextmanager
def relu_inputs(v: int, pinned=None):
    """For a ``with`` block, every message-passing layer's after-aggregation
    relu records its input's first ``v`` rows in the list the block gets,
    and, given ``pinned`` (one bool mask of [v, H] a layer, in call order),
    keeps exactly the entries its layer's mask marks on those rows (the
    input's own sign on the rest). Raises on a layer whose message
    activation is not relu after the aggregation."""
    from tf2_gnn_tpu_torch.layers.message_passing import base

    inputs = []
    plain = base.MessagePassing._post_aggregate

    def post_aggregate(layer, aggregated, node_states, batch, training):
        if (not layer._apply_message_activation
                or layer.message_activation_before_aggregation
                or layer.message_activation_function != "relu"):
            raise AssertionError(f"{type(layer).__name__}: no relu after "
                                 "the aggregation")
        inputs.append(aggregated.detach()[:v].clone())
        if pinned is None:
            return plain(layer, aggregated, node_states, batch, training)
        keep = aggregated.detach() > 0
        keep[:v] = pinned[len(inputs) - 1]
        return aggregated * keep

    with mock.patch.object(base.MessagePassing, "_post_aggregate",
                           post_aggregate):
        yield inputs


def check_relu_flips(got, want):
    """(count, largest |x|) of the relu inputs, layer by layer, that lie on
    opposite sides of 0 in ``got`` and ``want``. Raises where one lies
    farther from 0 than the states' tolerance (GNN_INPUT_ATOL plus
    GNN_INPUT_RTOL of the layer's largest |want| entry)."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} relu calls against {len(want)}")
    count, largest = 0, 0.0
    for layer, (g, w) in enumerate(zip(got, want)):
        flipped = (g > 0) != (w > 0)
        n = int(flipped.sum())
        if not n:
            continue
        size = float(g.abs().maximum(w.abs())[flipped].max())
        limit = GNN_INPUT_ATOL + GNN_INPUT_RTOL * float(w.abs().max())
        if size > limit:
            raise AssertionError(f"layer {layer}: {n} relu inputs on "
                                 f"opposite sides of 0, one {size} from it "
                                 f"(limit {limit})")
        count, largest = count + n, max(largest, size)
    return count, largest


def reference_path(device, argv):
    """Phase 13: the TF reference's own recorded runs on the card. Each of
    the eight dumps (``reference_parity.CASES``) on the batch without
    plans and on its flavour's fused plan kind (``reference_run``), then
    the public API at full width (``gnn_input_check``)."""
    import torch

    from tf2_gnn_tpu_torch.harness import reference_parity as rp

    t_phase = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 13 needs f32 products without TF32")
    root = ROOT / "build" / "phase13"
    totals = {}
    limits = (f"limits: rtol {rp.RTOL} + atol {rp.ATOL} for representations "
              f"and outputs, loss rtol {rp.LOSS_RTOL}, gradients "
              f"{rp.GRAD_RTOL} of each tensor's largest entry")
    for name, task, _ in rp.CASES:
        dump = rp.load_dump(name)
        data = rp.write_data(task, root)
        for kind in ("none", rp.FUSED_PLANS[dump.model]):
            t0 = time.perf_counter()
            route, launches, report = reference_run(dump, data, kind,
                                                    device)
            for n, c in launches.items():
                totals[n] = totals.get(n, 0) + c
            reps = max((v for k, v in report.items()
                        if k.startswith("rep::")), key=lambda x: x[0])
            shown = {"reps": reps, **{k: v for k, v in report.items()
                                      if not k.startswith("rep::")}}
            log(f"phase 13 {name} ({dump.model}, {task}) on {kind} plans: "
                f"route {route}, launches {launches or 'none'}; largest "
                "error as a share of its limit (abs): " + ", ".join(
                    f"{k} {share:.3g} ({err:.2e})"
                    for k, (share, err) in shown.items())
                + f"; {time.perf_counter() - t0:.2f} s")
    log(f"phase 13: every dump within the reference's tolerances on both "
        f"routes ({limits}); launches by kernel over the fused runs: "
        f"{totals}")
    gnn_input_check(device, ROOT / "build" / "phase12" / "ppi")
    hook_check(device, argv)
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase 14: scale-out over torch.distributed on the one card

SCALEOUT_STEPS = 3        # train steps of cases (a) and (b)
SCALEOUT_SHORT_STEPS = 2  # train steps of cases (c), (d) and (e)
# Case (e)'s replica graphs: uniform random edges, 3 a node, one edge
# type, of this many nodes each.
HYBRID_NODES = 32768
# Limits of phase 14, each case against one process on the same card.
# (a) and (f): the same kernels on the same batches, and a psum of two
# (or one) f32 values, which is the single process's own sum: the loss
# within 1e-6 relative, every parameter within 1e-6 absolute after each
# step (Adam at lr 1e-3).
DP_LOSS_RTOL, DP_PARAM_ATOL = 1e-6, 1e-6
# (b)-(e): each shard sums its own slots in another order than the
# unpartitioned plan, which a bf16 stream re-rounds now and then. Each
# case's ``limits`` (loss rtol at every step, step-1 gradients as a share
# of each tensor's largest |entry|, eval logits atol and share of the
# largest |logit|) sit 2.5-40 times above what the case reads on the card
# (PERF.md, phase 14), and far below what a dropped halo gives (case
# (e): 0.019 and 0.72, against 1e-6 and 2**-8).
# The kernels each fused case must launch on every rank in its train
# steps (B7 is on no call path: B4's mask sum gives dB), and in its eval
# forward.
SCALEOUT_KERNELS = {
    "ppi_rgcn": ("pair_stream", "pair_stream_joint"),
    "scaling": ("pair_spmm",),
    "ppi_rgat": ("pair_attention_expd", "pair_spmm",
                 "pair_attention_bwd_fused"),
    "edge_mlp": ("relu_pair_fwd_m", "relu_pair_da"),
    "rgcn_sorted": ("sorted_segment_sum_scaled",),
}
SCALEOUT_FORWARD_KERNELS = {
    "ppi_rgcn": ("pair_stream_joint",),
    "ppi_rgat": ("pair_attention_expd", "pair_spmm"),
    "edge_mlp": ("relu_pair_fwd",),
    "rgcn_sorted": ("sorted_segment_sum_scaled",),
}


def scaleout_params(model: str, layers: int = None):
    """A phase 14 model's hyperparameters, input dropout 0 (the ranks'
    masks cannot match the single process's)."""
    from tf2_gnn_tpu_torch import workloads

    params = {
        "ppi_rgcn": lambda: workloads.shipped_params("PPI_RGCN.json", "rgcn"),
        "ppi_rgat": lambda: workloads.shipped_params("PPI_RGAT.json", "rgat"),
        "edge_mlp": workloads.edge_mlp_default_params,
        "rgcn_sorted": workloads.rgcn_sorted_params,
        "scaling": workloads.scaling_params,
    }[model]()
    params["gnn_layer_input_dropout_rate"] = 0.0
    if layers is not None:
        params["gnn_num_layers"] = layers
    return params


def scaleout_cases():
    """Phase 14's cases (a)-(e), and (e) with a planted halo fault."""
    from tf2_gnn_tpu_torch import workloads

    ppi = dict(num_graphs_padded=workloads.GRAPHS_PER_BATCH + 1)
    short = SCALEOUT_SHORT_STEPS
    scaling = dict(loss=2e-3, grads=2.0 ** -10)
    e = dict(name="e", kind="hybrid", model="ppi_rgcn", layers=2,
             data="hybrid", steps=short, limits=dict(loss=1e-6,
                                                     grads=2.0 ** -8))
    return [
        dict(name="a", kind="dp", model="ppi_rgcn", data="ppi_dp",
             steps=SCALEOUT_STEPS),
        dict(name="b_dense", kind="spmd", model="scaling", data="scaling",
             halo="dense", steps=SCALEOUT_STEPS, limits=scaling),
        dict(name="b_ring", kind="spmd", model="scaling", data="scaling",
             halo="ring", steps=SCALEOUT_STEPS, limits=scaling),
        dict(name="c", kind="spmd", model="ppi_rgcn", data="ppi",
             partition=dict(ppi, build_pair_plans=True, pair_per_type=True,
                            reorder=True), steps=short, forward=True,
             limits=dict(loss=5e-5, grads=2.0 ** -7, logits=(1e-4,
                                                              2.0 ** -7))),
        dict(name="d_rgat", kind="spmd", model="ppi_rgat", layers=2,
             data="ppi", partition=dict(ppi, build_pair_plans=True,
                                        halo="dense", reorder=False),
             steps=short, forward=True, reference_plans=dict(merged=True),
             limits=dict(loss=1e-5, grads=2.0 ** -8,
                         logits=(1e-5, 2.0 ** -10))),
        dict(name="d_edge_mlp", kind="spmd", model="edge_mlp", layers=2,
             data="ppi", partition=dict(ppi, build_pair_plans=True,
                                        pair_merge_targets=True,
                                        reorder=False),
             steps=short, forward=True,
             reference_plans=dict(merged=True, merge_targets=True),
             limits=dict(loss=1e-5, grads=2.0 ** -14,
                         logits=(1e-4, 2.0 ** -12))),
        dict(name="d_rgcn_sorted", kind="spmd", model="rgcn_sorted",
             layers=2, data="ppi",
             partition=dict(ppi, build_scatter_plans=True, halo=False,
                            reorder=False),
             steps=short, forward=True, reference_plans=dict(scatter=True),
             limits=dict(loss=1e-6, grads=2.0 ** -16,
                         logits=(1e-5, 2.0 ** -16))),
        e,
        dict(e, name="e_fault", fault="ring_slab"),
    ]


def _ppi_graph():
    """The PPI bench graph as raw arrays (``build_raw_arrays(SEED)``) and
    its labels, ``build_ppi_batch_host(SEED)``'s own draw."""
    import numpy as np

    from tf2_gnn_tpu_torch import workloads

    nf, adj, n2g = workloads.build_raw_arrays(SEED)
    labels = (np.random.RandomState(SEED).rand(nf.shape[0],
                                               workloads.NUM_LABELS)
              > 0.9).astype(np.float32)
    return nf, adj, n2g, labels


def _hybrid_replicas():
    """Two replica graphs of ``HYBRID_NODES`` nodes, built as
    tests/test_spmd.py::test_hybrid_mesh_runs_typed_pair_replicas builds
    them (3 edges a node, one edge type) but with uniform random edges,
    so that half of them cross between the two node shards, and sharing
    one edge list, so that their partitions' edge budgets and ring slabs
    agree: (features, labels) differ by replica."""
    import numpy as np

    from tf2_gnn_tpu_torch import workloads

    rng = np.random.RandomState(6)
    v = HYBRID_NODES
    src = rng.randint(0, v, v * 3)
    tgt = rng.randint(0, v, v * 3)
    adj = [np.stack([src, tgt], 1).astype(np.int32)]
    out = []
    for _ in range(2):
        nf = rng.randn(v, workloads.FEATURE_DIM).astype(np.float32)
        labels = (rng.rand(v, workloads.NUM_LABELS) > 0.9).astype(np.float32)
        out.append((nf, adj, np.zeros((v,), np.int32), labels))
    return out


def _hybrid_partition(nf, adj, n2g, labels, shards: int):
    from tf2_gnn_tpu_torch.parallel import partition_graph

    return partition_graph(nf, adj, n2g, 1, shards, num_graphs_padded=2,
                           node_labels={"node_labels": labels},
                           build_pair_plans=True, pair_per_type=True,
                           halo="ring", reorder=False)


def scaleout_data(case, shards: int):
    """(stacked host batch, stacked labels) of a case over ``shards``
    shards (the replicas' over "data" for the hybrid case)."""
    from tf2_gnn_tpu_torch import workloads
    from tf2_gnn_tpu_torch.parallel import (
        partition_graph,
        stack_batches,
        stack_partitioned_batches,
    )

    if case["data"] == "ppi_dp":
        pairs = [workloads.build_ppi_batch_host(seed)[:2]
                 for seed in range(shards)]
        return stack_batches([b for b, _ in pairs], [l for _, l in pairs])
    if case["data"] == "scaling":
        return workloads.scaling_partition(shards, halo=case["halo"])
    if case["data"] == "ppi":
        nf, adj, n2g, labels = _ppi_graph()
        return partition_graph(nf, adj, n2g, workloads.GRAPHS_PER_BATCH,
                               shards, node_labels={"node_labels": labels},
                               **case["partition"])
    parts = [_hybrid_partition(nf, adj, n2g, labels, shards // 2)
             for nf, adj, n2g, labels in _hybrid_replicas()]
    return stack_partitioned_batches([b for b, _ in parts],
                                     [l for _, l in parts])


def scaleout_model(case, device, num_types: int):
    from tf2_gnn_tpu_torch import workloads
    from tf2_gnn_tpu_torch.models.node_multiclass_task import (
        NodeMulticlassTask,
    )

    params = scaleout_params(case["model"], case.get("layers"))
    dim = (workloads.SCALING_FEATURE_DIM if case["model"] == "scaling"
           else workloads.FEATURE_DIM)
    model = NodeMulticlassTask.from_params(
        params, input_dim=dim, num_edge_types=num_types, device=device,
        seed=SEED, num_labels=workloads.NUM_LABELS)
    return model, params


class FirstGradients:
    """An optimizer that keeps the gradients it applies first (f32 numpy,
    in the parameters' order), then steps as the one it wraps."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.grads = None

    def zero_grad(self) -> None:
        self.optimizer.zero_grad()

    def step(self, step: int) -> None:
        if self.grads is None:
            self.grads = [p.grad.detach().float().cpu().numpy()
                          for group in self.optimizer.torch_optimizer
                          .param_groups for p in group["params"]
                          if p.grad is not None]
        self.optimizer.step(step)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _flat_params(model):
    import numpy as np

    return np.concatenate([p.detach().float().cpu().numpy().reshape(-1)
                           for p in model.parameters()])


def _launches():
    """The kernels launched since the last ``tracing.reset()``, by name."""
    from tf2_gnn_tpu_torch.utils import tracing

    return {k: v for k, v in tracing.counters("launch").items() if v}


def scaleout_rank(rank: int, world: int, cases):
    """One rank of phase 14: every case of ``cases`` in order (all ranks
    alike), each returning what the main process compares."""
    import torch

    from tf2_gnn_tpu_torch.parallel import collectives

    device = collectives.process_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = []
    for case in cases:
        with (_zeroed_ring_slabs() if case.get("fault") == "ring_slab"
              else contextlib.nullcontext()):
            results.append(scaleout_rank_case(rank, world, case, device))
    return results


@contextlib.contextmanager
def _zeroed_ring_slabs():
    """A planted fault: every ring slab arrives as zeros (the halo lost,
    both ways)."""
    import torch

    from tf2_gnn_tpu_torch.parallel import collectives

    ppermute = collectives.ppermute
    with mock.patch.object(collectives, "ppermute",
                           lambda x, axis, k: torch.zeros_like(
                               ppermute(x, axis, k))):
        yield


def scaleout_rank_case(rank: int, world: int, case, device):
    """One case of ``scaleout_rank`` on this rank."""
    import torch

    from tf2_gnn_tpu_torch import parallel as par
    from tf2_gnn_tpu_torch.harness.optimizers import make_optimizer
    from tf2_gnn_tpu_torch.harness.training import create_train_state
    from tf2_gnn_tpu_torch.parallel import collectives
    from tf2_gnn_tpu_torch.utils import tracing

    t_case = time.perf_counter()
    kind = case["kind"]
    if kind == "dp":
        mesh, axes = par.make_mesh(axis_name="data"), "data"
        make_step = par.make_dp_train_step
    elif kind == "spmd":
        mesh, axes = par.make_mesh(axis_name="nodes"), "nodes"
        make_step = par.make_spmd_train_step
    else:
        mesh = par.make_hybrid_mesh(2, world // 2)
        axes = ("data", "nodes")
        make_step = par.make_hybrid_train_step
    host, host_labels = scaleout_data(case, world)
    batch, labels = par.distribute_batch(mesh, (host, host_labels), axes)
    model, params = scaleout_model(case, device, batch.num_edge_types)
    par.replicate_to_mesh(mesh, model)
    layer = model.gnn.mp_layer_0
    out = {"rank": rank, "route": (layer._route(batch)
                                   if hasattr(layer, "_route")
                                   else "unfused"),
           "halo": ("ring" if batch.halo_ring_send is not None
                    else "dense" if batch.halo_send_idx is not None
                    else "all_gather" if batch.spmd_axis else "none"),
           "setup_s": time.perf_counter() - t_case}
    if case.get("forward"):
        tracing.reset()
        logits = par.make_spmd_forward(model, mesh)(batch)[0]
        out["forward_launches"] = _launches()
        if rank == 0:
            out["forward"] = par.restore_node_order(logits, host)
    optimizer = FirstGradients(make_optimizer(params,
                                              model.parameters()))
    state = create_train_state(model, optimizer, seed=SEED)
    step = make_step(model, optimizer, mesh)
    tracing.reset()
    losses, params_by_step, step_s = [], [], []
    for _ in range(case["steps"]):
        _sync(device)
        t0 = time.perf_counter()
        state, metrics = step(state, batch, labels)
        losses.append(float(metrics["loss"]))
        _sync(device)
        step_s.append(time.perf_counter() - t0)
        if kind == "dp" and rank == 0:
            params_by_step.append(_flat_params(model))
    steps = case["steps"]
    out.update(
        losses=losses, launches=_launches(),
        collectives={k: {"calls": v["calls"] / steps,
                         "bytes": v["bytes"] / steps}
                     for k, v in collectives.counts_snapshot().items()
                     if v["calls"]},
        step_ms=1e3 * sum(step_s[1:] or step_s) / len(step_s[1:]
                                                      or step_s),
        final_params=_flat_params(model),
        host_staged=sorted(collectives.HOST_STAGED))
    if rank == 0:
        out["grads"] = optimizer.grads
        out["params_by_step"] = params_by_step
    return out


def reference_steps(model, params, batches, steps: int, device):
    """The single process's steps over ``batches`` ((batch, labels,
    weight)), their gradients combined as the parallel step combines them,
    ``sum_b w_b g_b / max(sum_b w_b, 1)``: (losses, step-1 gradients, flat
    parameters after each step)."""
    import torch

    from tf2_gnn_tpu_torch.harness.optimizers import make_optimizer

    optimizer = make_optimizer(params, model.parameters())
    plist = [p for p in model.parameters() if p.requires_grad]
    losses, grads, params_by_step = [], None, []
    for step in range(steps):
        total, loss_sum, weight_sum = None, None, None
        for batch, labels, weight in batches:
            model.train()
            optimizer.zero_grad()
            metrics = model.compute_task_metrics(
                batch, model(batch, True), labels)
            metrics["loss"].backward()
            w = torch.tensor(float(weight), device=device)
            g = [(torch.zeros_like(p) if p.grad is None else p.grad.float())
                 * w for p in plist]
            loss = metrics["loss"].detach() * w
            if total is None:
                total, loss_sum, weight_sum = g, loss, w
            else:
                total = [a + b for a, b in zip(total, g)]
                loss_sum, weight_sum = loss_sum + loss, weight_sum + w
        weight_sum = torch.clamp(weight_sum, min=1.0)
        for p, g in zip(plist, total):
            p.grad = (g / weight_sum).to(p.dtype)
        if step == 0:
            grads = [p.grad.float().cpu().numpy() for p in plist]
        optimizer.step(step)
        losses.append(float(loss_sum / weight_sum))
        params_by_step.append(_flat_params(model))
    _sync(device)
    return losses, grads, params_by_step


def scaleout_reference(case, device):
    """One process on the same card: the unpartitioned graph (a shard of
    one, or the batch the single-chip phases plan), or the same batches,
    combined as the parallel step combines them."""
    import torch

    from tf2_gnn_tpu_torch import workloads
    from tf2_gnn_tpu_torch.harness.training import to_device

    if case["data"] == "ppi_dp":
        pairs = [to_device(*workloads.build_ppi_batch_host(seed)[:2],
                           device) for seed in range(2)]
        batches = [(b, l, b.num_graphs) for b, l in pairs]
    elif case["data"] == "scaling":
        # The 2-shard run's graph in one shard: no remote source, so the
        # ring has no distance and the ext rows are the local rows.
        host, labels = workloads.scaling_partition(1, halo="ring",
                                                   graph_shards=2)
        batches = [(*to_device(host.shard(0).replace(spmd_axis=None),
                               {k: v[0] for k, v in labels.items()},
                               device), 1)]
    elif case["data"] == "ppi":
        host, labels, _ = workloads.build_ppi_batch_host(
            SEED, **case.get("reference_plans", {}))
        batches = [(*to_device(host, labels, device), 1)]
    else:
        batches = []
        for nf, adj, n2g, labels in _hybrid_replicas():
            host, lab = _hybrid_partition(nf, adj, n2g, labels, 1)
            batches.append((*to_device(host.shard(0).replace(spmd_axis=None),
                                       {k: v[0] for k, v in lab.items()},
                                       device), 1))
    model, params = scaleout_model(case, device, batches[0][0].num_edge_types)
    ref = {}
    if case.get("forward"):
        model.eval()
        with torch.no_grad():
            (logits,) = model(batches[0][0], False)
        n = int(batches[0][0].num_nodes)
        ref["forward"] = logits[:n].float().cpu().numpy()
    ref["losses"], ref["grads"], ref["params_by_step"] = reference_steps(
        model, params, batches, case["steps"], device)
    return ref


def _share(got, want) -> float:
    """Largest |got - want| over the largest |want| (1 where want is 0)."""
    import numpy as np

    scale = float(np.abs(want).max()) or 1.0
    return float(np.abs(np.asarray(got) - want).max()) / scale


def scaleout_errors(case, results, ref):
    """Hold the ranks' results against the single process's: every rank
    launched the case's kernels and holds rank 0's parameters (else it
    raises); returns {check: (largest error, limit)}."""
    import numpy as np

    first = results[0]
    errors = {}
    for r in results:
        missing = [k for k in SCALEOUT_KERNELS[case["model"]]
                   if not r["launches"].get(k)]
        if case.get("forward"):
            missing += [f"{k} (eval forward)"
                        for k in SCALEOUT_FORWARD_KERNELS[case["model"]]
                        if not r["forward_launches"].get(k)]
        if missing:
            raise AssertionError(f"phase 14 ({case['name']}): rank "
                                 f"{r['rank']} launched no {missing}")
        if not np.array_equal(r["final_params"], first["final_params"]):
            raise AssertionError(f"phase 14 ({case['name']}): rank "
                                 f"{r['rank']}'s parameters differ from "
                                 "rank 0's")
    losses = np.asarray(first["losses"])
    want_losses = np.asarray(ref["losses"])
    loss_err = float(np.max(np.abs(losses - want_losses)
                            / np.abs(want_losses)))
    if case["kind"] == "dp":
        errors["loss (rel)"] = (loss_err, DP_LOSS_RTOL)
        errors["params (abs)"] = (max(
            float(np.abs(a - b).max()) for a, b in
            zip(first["params_by_step"], ref["params_by_step"])),
            DP_PARAM_ATOL)
    else:
        limits = case["limits"]
        errors["loss (rel)"] = (loss_err, limits["loss"])
        errors["step-1 gradients (share)"] = (max(
            _share(g, w) for g, w in zip(first["grads"], ref["grads"])),
            limits["grads"])
        if case.get("forward"):
            want = ref["forward"]
            got = first["forward"][:want.shape[0]]
            atol, share = limits["logits"]
            scale = float(np.abs(want).max())
            err = float(np.abs(got - want).max())
            errors["eval logits (abs)"] = (err, atol + share * scale)
    return errors


def _report(errors) -> str:
    return ", ".join(f"{k} {e:.3g} of {lim:.3g}"
                     for k, (e, lim) in errors.items())


def scaleout_check(case, results, ref) -> str:
    """``scaleout_errors`` within every limit; returns the case's report
    (the largest error of each check against its limit). A case with a
    planted ``fault`` must fail the limits instead: every check but the
    numbers holds, and some number does not."""
    errors = scaleout_errors(case, results, ref)
    report = _report(errors)
    within = all(e <= lim for e, lim in errors.values())
    if case.get("fault"):
        if within:
            raise AssertionError(f"phase 14 ({case['name']}): the check "
                                 f"passed a planted {case['fault']} fault: "
                                 f"{report}")
        return f"refused as it must be: {report}"
    if not within:
        raise AssertionError(f"phase 14 ({case['name']}): {report}")
    return report


def scaleout_log(case, results, report: str) -> None:
    first = results[0]
    launches = [r["launches"] for r in results]
    log(f"phase 14 ({case['name']}, {case['kind']}, {len(results)} ranks): "
        f"route {first['route']}, halo {first['halo']}; launches per rank "
        f"in {case['steps']} steps {launches}"
        + (f", eval forward {[r['forward_launches'] for r in results]}"
           if case.get("forward") else "")
        + f"; collectives a step (rank 0) {first['collectives']}; step ms "
        f"{[round(r['step_ms'], 3) for r in results]}; losses "
        f"{[round(x, 6) for x in first['losses']]}; {report}; setup "
        f"{max(r['setup_s'] for r in results):.1f} s")


def gather_scatter_sorted_check(device) -> None:
    """``gather_scatter_sorted`` (B12 both ways over one edge type's dual
    plan) once on the card against its plain version, at the PPI batch's
    forward edges and hidden 320."""
    import numpy as np
    import torch

    from tf2_gnn_tpu_torch import workloads
    from tf2_gnn_tpu_torch.ops import sorted_spmm as ss
    from tf2_gnn_tpu_torch.utils import tracing

    batch, _, _ = workloads.build_ppi_batch_host(SEED, plans=False)
    v = batch.num_nodes_padded
    src, tgt = batch.edge_sources[1], batch.edge_targets[1]
    plan = ss.DualScatterPlan.from_host(ss.build_dual_plans(
        src, tgt, int(batch.num_edges[1]), v,
        ss.plan_chunk_budget(src.shape[0], v)), v).to(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    table0 = torch.randn((v, 320), generator=gen, device=device)
    cot = torch.randn((v, 320), generator=gen, device=device)

    def run():
        table = table0.clone().requires_grad_(True)
        out = ss.gather_scatter_sorted(table, plan, torch.bfloat16)
        (out * cot).sum().backward()
        return out.detach(), table.grad

    tracing.reset()
    got = run()
    launches = ss.LAUNCHES["sorted_segment_sum"]
    with mock.patch.object(ss, "sorted_segment_sum_gathered", plain_version(
            ss.sorted_segment_sum_gathered_plain)):
        want = run()
    errs = [check_close(f"gather_scatter_sorted {name}", x, y, KERNEL_RTOL,
                        KERNEL_ATOL)
            for name, x, y in zip(("sums", "table gradient"), got, want)]
    if launches != 2:
        raise AssertionError(f"gather_scatter_sorted launched B12 "
                             f"{launches} times; expected 2")
    log(f"phase 14: gather_scatter_sorted (B12 over the dual plan of "
        f"{int(batch.num_edges[1])} edges, H = 320, bf16 stream) against "
        f"its plain version: max abs err {max(errs):.3g} (limits rtol "
        f"{KERNEL_RTOL}, atol {KERNEL_ATOL}), {launches} launches")


def nccl_case(device) -> None:
    """Case (f): one rank over the default backend (NCCL on the card) in
    this process, one DP step of PPI_RGCN on the PPI batch against the
    single process's step."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from tf2_gnn_tpu_torch import parallel as par
    from tf2_gnn_tpu_torch import workloads
    from tf2_gnn_tpu_torch.harness.optimizers import make_optimizer
    from tf2_gnn_tpu_torch.harness.training import (
        create_train_state,
        to_device,
    )
    from tf2_gnn_tpu_torch.parallel import collectives
    from tf2_gnn_tpu_torch.utils import tracing

    backend = "nccl" if device.type == "cuda" else "gloo"
    case = dict(name="f", kind="dp", model="ppi_rgcn", steps=1)
    host, labels, _ = workloads.build_ppi_batch_host(SEED)
    batch, tlabels = to_device(host, labels, device)
    model, params = scaleout_model(case, device, batch.num_edge_types)
    ref = {}
    ref["losses"], _, ref["params_by_step"] = reference_steps(
        model, params, [(batch, tlabels, batch.num_graphs)], 1, device)
    with tempfile.TemporaryDirectory() as tmp:
        par.initialize_multiprocess(f"file://{tmp}/rendezvous", 1, 0,
                                    backend=backend, device=device)
        try:
            mesh = par.make_mesh()
            model, params = scaleout_model(case, device,
                                           batch.num_edge_types)
            stacked = par.stack_batches([host], [labels])
            one, one_labels = par.distribute_batch(mesh, stacked)
            optimizer = make_optimizer(params, model.parameters())
            state = create_train_state(model, optimizer, seed=SEED)
            tracing.reset()
            t0 = time.perf_counter()
            _, metrics = par.make_dp_train_step(model, optimizer, mesh)(
                state, one, one_labels)
            loss = float(metrics["loss"])
            _sync(device)
            step_ms = 1e3 * (time.perf_counter() - t0)
            got = _flat_params(model)
            launches = _launches()
            counts = collectives.counts_snapshot()
        finally:
            dist.destroy_process_group()
            collectives.use_mesh(None)
            collectives.set_process_device(None)
    errors = {"loss (rel)": (abs(loss - ref["losses"][0])
                             / abs(ref["losses"][0]), DP_LOSS_RTOL),
              "params (abs)": (float(np.abs(got - ref["params_by_step"][0])
                                     .max()), DP_PARAM_ATOL)}
    report = ", ".join(f"{k} {e:.3g} of {lim:.3g}"
                       for k, (e, lim) in errors.items())
    missing = [k for k in SCALEOUT_KERNELS["ppi_rgcn"] if not launches.get(k)]
    if missing or any(not e <= lim for e, lim in errors.values()):
        raise AssertionError(f"phase 14 (f): launched {launches}; {report}")
    log(f"phase 14 (f, dp, 1 rank over {backend}): launches {launches}; "
        f"collectives {({k: v for k, v in counts.items() if v['calls']})}; "
        f"step ms {step_ms:.3f}; {report}")


def scaleout_path(device, argv):
    """Phase 14: scale-out on the card. The ranks are processes started
    with ``spawn`` (``parallel.launch.run_ranks``) over gloo, on this one
    card, each case held against one process on the same card running the
    unpartitioned graph or the same batches: (a) DP of PPI_RGCN on two
    bench batches, (b) the scaling workload on both halo forms, (c) the
    PPI batch on per-type plans with RCM reordering, (d) RGAT, the
    reference-default GNN_Edge_MLP and RGCN on merged, merged-target and
    scatter plans (the last with the all_gather) on 2 ranks that stay up
    across the cases; (e) the hybrid 2 x 2 step on 4 ranks; (f) one rank
    over NCCL in this process. (e) runs again with every ring slab zeroed,
    which the check must refuse. Also ``gather_scatter_sorted`` once
    against its plain version."""
    from tf2_gnn_tpu_torch.parallel.launch import run_ranks

    t_phase = time.perf_counter()
    gather_scatter_sorted_check(device)
    cases = scaleout_cases()
    clusters = ((2, [c for c in cases if c["kind"] != "hybrid"]),
                (4, [c for c in cases if c["kind"] == "hybrid"]))
    staged = set()
    for world, group in clusters:
        t0 = time.perf_counter()
        results = run_ranks(scaleout_rank, world, (group,),
                            device=device.type)
        log(f"phase 14: {world} ranks ran {[c['name'] for c in group]} in "
            f"{time.perf_counter() - t0:.1f} s (spawn included)")
        refs = {}
        for i, case in enumerate(group):
            per_case = [r[i] for r in results]
            staged.update(*(r["host_staged"] for r in per_case))
            # A faulted case is held against its healthy twin's reference.
            key = case["name"].split("_fault")[0]
            if key not in refs:
                refs[key] = scaleout_reference(case, device)
            report = scaleout_check(case, per_case, refs[key])
            scaleout_log(case, per_case, report)
    log(f"phase 14: collectives staged through the host (gloo with CUDA "
        f"tensors): {sorted(staged) or 'none'}")
    nccl_case(device)
    log(f"phase 14: every case within its limits; one card's multi-rank "
        f"step times say nothing of scaling efficiency; "
        f"{time.perf_counter() - t_phase:.1f} s")


def probe_path(device, argv):
    """Phase 8: the design probes at their own shapes; P1 and P2 through
    B3's kernel on the probe's plans of the PPI edges, P3 in f32 and bf16.
    Returns their three entries, and P3's bf16 entry."""
    import numpy as np
    import torch

    from tf2_gnn_tpu_torch.ops import pair_spmm as ps
    from tf2_gnn_tpu_torch.ops import probes
    from tf2_gnn_tpu_torch.utils import tracing
    from tf2_gnn_tpu_torch.workloads import NODE_BUDGET, build_raw_arrays

    # The probe's edges: every real edge of the PPI batch, sources in the
    # merged l * V + u row space; its table: bf16 [3 V, 384].
    t0 = time.perf_counter()
    v = NODE_BUDGET
    _, adjacency, _ = build_raw_arrays(SEED)
    srcs = np.concatenate([a[:, 0].astype(np.int64) + l * v
                           for l, a in enumerate(adjacency)])
    tgts = np.concatenate([a[:, 1] for a in adjacency])
    rows, h = len(adjacency) * v, PROBE_H
    plans = {"pair_spmm_unrolled": probes.unrolled_plan(srcs, tgts, rows,
                                                         v).to(device),
             "pair_spmm_chunked": probes.chunked_plan(srcs, tgts, rows,
                                                      v).to(device)}
    log(f"workload (probes): {srcs.shape[0]} edges over {rows} source rows, "
        + ", ".join(f"{name} {p.src_blk.shape[0]} chunks in "
                    f"{p.grp_tgt.shape[0]} groups"
                    for name, p in plans.items())
        + f", built in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    table = torch.randn((rows, h), generator=gen,
                        device=device).to(torch.bfloat16)
    ref = np.zeros((v, h), np.float32)  # the probe's check
    np.add.at(ref, tgts, table.float().cpu().numpy()[srcs])
    ref = torch.from_numpy(ref).to(device)
    r, c, reps = DYNGATHER_SHAPE
    gtab = torch.randn((r, c), generator=gen, device=device)
    gidx = torch.randint(0, r, (r, c), generator=gen, device=device,
                         dtype=torch.int32)
    gtabs = {"dyngather": gtab, "dyngather bf16": gtab.to(torch.bfloat16)}

    fns = {name: (lambda p=p, fn=getattr(probes, name): fn(table, p, v),
                  lambda p=p: ps.pair_spmm_plain(table, *p.kernel_args, v))
           for name, p in plans.items()}
    for form, t in gtabs.items():
        fns[form] = (lambda t=t: probes.dyngather(t, gidx, reps),
                     lambda t=t: probes.dyngather_plain(t, gidx, reps))

    # The probes' own run, with every launch count set to 0 just before
    # and read just after each call: B3's kernel once for P2 and once for
    # P1, P3's once a dtype, and nothing else.
    launches, errs = {}, {}
    for form, (kernel_fn, plain_fn) in fns.items():
        tracing.reset()
        got = kernel_fn()
        torch.cuda.synchronize()
        counts = _launches()
        kernel = "dyngather" if form.startswith("dyngather") else "pair_spmm"
        if counts != {kernel: 1}:
            raise AssertionError(f"{form} launched {counts}; expected "
                                 f"{kernel} once")
        launches[form] = counts[kernel]
        check_repeatable(form, kernel_fn, got)
        want = plain_fn()
        errs[form] = check_close(form, got, want, KERNEL_RTOL, KERNEL_ATOL)
        if kernel == "pair_spmm":
            probe_err = float((got - ref).abs().max() / ref.abs().max())
            if probe_err > PROBE_CHECK_RTOL:
                raise AssertionError(f"{form}: rel-max error {probe_err} "
                                     "against the probe's np.add.at check")
            log(f"{form}: rel-max error vs the probe's numpy check "
                f"{probe_err:.2e}; bit-equal across two launches")
        else:
            if not torch.equal(got, want):
                raise AssertionError(f"{form}: differs from its plain "
                                     "version")
            log(f"{form}: {probes.dyngather_form(r, c, gtabs[form].dtype)} "
                f"form, {probes.strip_cols(r, c, gtabs[form].dtype)} columns "
                "a strip; bit-equal to its plain version and across two "
                "launches")
        del got, want
    log("kernel check: " + ", ".join(f"{form} max_abs_err {err:.3e}"
                                     for form, err in errs.items())
        + f" (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}); launches {launches}")

    # Bounds as PERF.md counts them: for P1/P2 B3's (``kernel_bound_ms``);
    # for P3 the table, the indices and the output once each, and one add
    # a shift and element. Library calls: torch.sparse.mm of the plan's
    # CSR; for P3 one torch.gather over all the shifted index sets, built
    # outside the timed window, then a sum.
    kernels = []
    replaces = {"pair_spmm_unrolled": "benchmarks/pair_probe.py:189",
                "pair_spmm_chunked": "benchmarks/pair_probe.py:276",
                "dyngather": "benchmarks/dyngather_probe.py:37"}
    table_f32 = table.float()
    for name, p in plans.items():
        src, tgt, valid = ps.slot_abs_ids(*p.kernel_args[1:])
        a32, a16, rows_read, n_valid = slot_matrix(src, tgt, valid,
                                                   p.kernel_args[0], v, rows)
        bound = kernel_bound_ms(rows_read, h, 2, n_valid, v)
        kernels.append(time_kernel(
            name, "tf2_gnn_tpu_torch/csrc/pair_stream.cu", replaces[name],
            launches[name], errs[name], *fns[name],
            lambda a16=a16: torch.sparse.mm(a16, table),
            lambda a32=a32: torch.sparse.mm(a32, table_f32), *bound,
            f"B3's kernel, group {p.group}, bf16 [{rows}, {h}] table, "
            f"{n_valid} valid of {p.rel_src.numel()} slots", device=True))
    shifted = (gidx.long()[None] + torch.arange(reps, device=device)[:, None,
                                                                     None]) % r
    forms = []
    for form, t in gtabs.items():
        expanded = t[None].expand(reps, r, c)
        bound = bound_ms(r * c * (t.element_size() + 4 + 4), reps * r * c)
        entry = time_kernel(
            form, "tf2_gnn_tpu_torch/csrc/dyngather.cu",
            replaces["dyngather"], launches[form], errs[form], *fns[form],
            lambda e=expanded: torch.gather(e, 1, shifted).sum(
                0, dtype=torch.float32), None, *bound,
            f"{t.dtype} [{r}, {c}], {reps} shifts, "
            f"{probes.dyngather_form(r, c, t.dtype)} form", device=True)
        # The probe's default dtype is its entry; bf16 is another form.
        (kernels if form == "dyngather" else forms).append(entry)
    return kernels, forms


def _demangle(names):
    """``names`` through ``c++filt``; as given where it is missing or
    fails."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, check=True)
        return out.stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return list(names)


def _ptxas_report(log: str, match: str):
    """(kernel, registers, spill stores, spill loads) of every entry
    function whose name holds ``match`` in ``nvcc -Xptxas -v``'s output."""
    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and match in name:
            rows.append((name, int(m.group(1))) + spills)
    names = _demangle([r[0] for r in rows])
    return [(n,) + r[1:] for n, r in zip(names, rows)]


def main(argv) -> int:
    import torch

    t_start = time.perf_counter()
    device = require_card()
    sys.path.insert(0, str(ROOT))
    from tf2_gnn_tpu_torch.ops import cuda_build

    # A reference states its float32 product precision: full f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for "
        f"{sorted(logs) or 'cached libraries'}")
    for source, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {source}: {line.strip()}")
    from tf2_gnn_tpu_torch import native

    t0 = time.perf_counter()
    native.build()
    native.available()
    log(f"build: the C++ host engine ({native.library_path().name}, g++ "
        f"{' '.join(native.CXX_FLAGS)}) ready in "
        f"{time.perf_counter() - t0:.1f} s")
    # By name: the registers and spills of B8's kernel and of each mode
    # of the relu-pair row owner (B4, B6, B7).
    for source, match in (("pair_stream.cu", "expd_rows"),
                          ("pair_edge_mlp.cu", "relu_pair_rows")):
        for name, regs, stores, loads in _ptxas_report(logs.get(source, ""),
                                                       match):
            log(f"  ptxas {name}: {regs} registers, spill stores {stores} "
                f"B, loads {loads} B")
    log(f"device: {torch.cuda.get_device_name(device)} "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")

    # -- 2. PPI_RGCN, 3. PPI_RGAT, 4. GNN_Edge_MLP, 5. scatter plans,
    # -- 6. RGAT on per-type plans, 7. QM9_RGCN, 8. the probes, 9. GGNN,
    # -- RGIN, PPI_GNN_Edge_MLP and GNN-FiLM, 10. the edge-MLP family on
    # -- merged, merged-target and scatter plans, GraphRegression, 11. the
    # -- unfused per-edge path on the batches without plans, 12. training
    # -- and testing from the command line, 13. the TF reference's recorded
    # -- runs and the public API, 14. scale-out over torch.distributed -----
    # Each path returns its kernels-line entries, and phases 3-6 also the
    # entries of other call forms (none for phase 4), which are logged.
    def timed(phase: int, path):
        t_phase = time.perf_counter()
        result = path(device, argv)
        log(f"phase {phase} ({path.__name__}): "
            f"{time.perf_counter() - t_phase:.1f} s")
        return result

    kernels = timed(2, rgcn_path)
    other_forms = []
    for phase, path in ((3, rgat_path), (4, edge_mlp_path), (5, sorted_path),
                        (6, typed_rgat_path)):
        torch.cuda.empty_cache()
        path_kernels, path_forms = timed(phase, path)
        kernels += path_kernels
        other_forms += path_forms
    torch.cuda.empty_cache()
    qm9_entries = timed(7, qm9_path)
    torch.cuda.empty_cache()
    probe_kernels, probe_forms = timed(8, probe_path)
    kernels += probe_kernels
    torch.cuda.empty_cache()
    flavour_kernels, flavour_forms = timed(9, flavours_path)
    kernels += flavour_kernels
    torch.cuda.empty_cache()
    route_kernels, route_forms = merged_scatter_path(device, argv)
    kernels += route_kernels
    torch.cuda.empty_cache()
    unfused_path(device, argv)
    torch.cuda.empty_cache()
    cli_path(device, argv)
    torch.cuda.empty_cache()
    reference_path(device, argv)
    torch.cuda.empty_cache()
    scaleout_path(device, argv)
    t0 = time.perf_counter()
    add_device_times(kernels + other_forms + probe_forms + qm9_entries
                     + flavour_forms + route_forms)
    log(f"device times of the kernels' entries: "
        f"{time.perf_counter() - t0:.1f} s")
    if len(kernels) != len({k["name"] for k in kernels}) or len(kernels) != 18:
        raise AssertionError(f"kernels line: {[k['name'] for k in kernels]}; "
                             "expected 18 distinct kernels")

    log(f"wall time: {time.perf_counter() - t_start:.1f} s for the whole "
        "script, the build included")
    card = card_line()
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def profile_step(train_step, state, batch, labels, step_ms: float,
                 steps: int = 5) -> None:
    """Device time by kernel over a few train steps (torch.profiler), and
    the device's busy share of the unprofiled step time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, metrics = train_step(state, batch, labels)
        torch.cuda.synchronize()

    kernels = kernel_events(prof)
    busy_ms = sum(_self_device_us(e) for e in kernels) / steps / 1e3
    log(f"profile: {steps} steps, kernel time {busy_ms:.3f} ms/step of a "
        f"{step_ms:.3f} ms unprofiled step (device busy share "
        f"{busy_ms / step_ms:.3f})")
    log_kernels(kernels, steps)


def kernel_events(prof):
    """The profile's CUDA kernels by device time, largest first. A user
    annotation on the device (the optimizer's step) spans kernels that are
    listed on their own, and the host gaps between them: it is not kernel
    time."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _self_device_us(e) > 0
               and not getattr(e, "is_user_annotation", False)]
    kernels.sort(key=_self_device_us, reverse=True)
    return kernels


def log_kernels(kernels, steps: int) -> None:
    """The 15 largest kernels a step, then the rest of the hand-written
    ones (all in anonymous namespaces of csrc/*.cu), whose device time a
    wrapper's CUDA-event timing hides when the host is slower than the
    kernel."""
    shown = [e for i, e in enumerate(kernels)
             if i < 15 or "(anonymous namespace)" in e.key]
    for e in shown:
        log(f"  {_self_device_us(e) / steps / 1e3:8.4f} ms/step  "
            f"{e.count // steps:4d}x  {e.key[:100]}")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
