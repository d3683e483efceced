#!/usr/bin/env python3
"""Smoke run of the PyTorch port (qmf_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one NVIDIA H100 (sm_90a),
PyTorch built for CUDA and nvcc. It imports no jax. Phases, one line each:

0. the card: name and power limit (nvidia-smi), torch and CUDA versions;
1. build the host I/O library from csrc/host_io.cpp (g++) and the CUDA
   kernels from csrc/ (nvcc, sm_90a), each build's seconds;
2. the kernel against its plain PyTorch version, f32 and f64, through its
   batch-first entry (solve_spd), its batch-last entry (cholesky_solve_t on
   a (k, k, B) buffer) and solve_spd(layout="t"), k in {1, 8, 16, 30, 31,
   33, 64, 65, 128, either entry's max k} x B in {1, 13, either entry's
   systems per block + 1, 4097 (k <= 128)}; non-SPD rows give NaN through
   either entry, beside SPD rows of their block, one of them in a tail
   block; then, at the ml20m user side's shape (B = 138,493, k = 64), both
   entries on resident buffers, layout="t" with its batch-last copy, that
   copy alone, the batch-first entry reading the batch-last buffer through
   strides, the plain version and torch.linalg.solve timed in turns, with
   the bound and the systems per block;
3. the CLI main path at ml100k scale with CLI defaults (k = 30): each
   side's hot width (hot_width "auto"), launch count (one chol_solve a
   class of the packing at those widths), factor files, test AUC, and the factors against a plain-cholesky
   run on the card; the read and the save through the native library
   (data/native.py), whose reader gives the numpy reader's arrays on both
   files and whose writer the Python writer's bytes on the trained factors;
4. the WALSEngine at ml20m scale and k = 64, 3 epochs, with the defaults
   (so each side at the hot width "auto" resolves, both printed): the
   pack's kind (device-packed), init's stages and peak memory, and every class's four
   tensors against a host pack of the same data, element for element, with
   both packs' seconds; epoch times and losses, AUC, launch count (and
   launches per epoch), peak memory; then
   the kernel against the plain version on that run's largest width class;
   then (4p) the split path's user half-epoch under torch.profiler: device
   ms, chol_solve_kernel's time, the largest kernels by device time.
   Phases 5-7 time the kernels on phase 4's data packed at H = 0 on both
   sides (phase 4's engine where "auto" resolved 0, else the same data
   packed again at H = 0 holding its trained factors);
5. the build+solve kernel against its plain version, bf16 and f32 streams,
   without and with the hot head, k in {8, 30, 64} x D in {8, 320, 512} x
   N in {1, 13, 300}, plus wide streams split over blocks, (N, D) in
   {(1, 4096), (8, 32768)}; then the kernel, its plain version and the
   split path's build + chol_solve timed on phase 4's largest user class
   and on its widest item class;
6. solver="fused": the CLI at ml100k (hot_width "auto": build_solve's
   launches of each variant, one a chunk, the hot one on a side above 0),
   then WALSEngine at ml20m, k = 64, with hot_width = 1024 on phase 4's
   data, 3 epochs: init's stages, epoch times against phase 4's, losses,
   AUC within 2e-3 of phase 4's, launch counts, peak memory; then the hot
   variant against
   its plain version on that run's largest user class, checked and timed;
   then each item class of the fused+hot path, and the user and item
   half-epochs of the split and fused paths at H = 0 and of fused+hot,
   timed in turns;
7. the gather kernels (vec, warp, tile, fill) against their plain
   version, bit for bit: bf16/f32/f64 x k in {1, 3, 30, 64, 65, 128} x R in
   {1, 255, 513, 2^20} x int32/int64 indices, fill with indices in
   [-rows-3, rows+3), a table view that starts one element into its
   storage, a 2-D index; then the three probe entry points
   (tools.gather_micro's default shapes, tools.vmem_gather_micro at 2^22
   rows with and without the L2 window, tools.solver_micro at B = 512 and
   2048), whose launches are counted; then the gather kernels, their plain
   version and index_select timed in turns at the probes' shapes and on
   phase 4's largest user class (its col_idx against the item factors in
   bf16), with both bounds;
8. serving: the recommend CLI on phase 3's ml100k factor files with
   --exclude_seen on its training file (every line parses, no listed item
   was seen, scores descend); then recommend_top_n on phase 4's ml20m
   factors for all users in batches of 4,096, n = 10, seen items excluded:
   users/s, peak memory, exclude_seen.cu's launches (one a batch), and 64
   sampled users against a numpy float64 ranking wherever the score gap to
   the next item exceeds 1e-4; then exclude_seen.cu on the first batch's
   scores and seen set, against its plain version bit for bit, and both
   timed in turns beside the kernel's bytes bound;
9. BPR (plain tensor ops: qmf_tpu's BPR path reaches no kernel): (a) the
   hashes and one grouped presample+pack of 2^20 rows, word, bitmap and
   Bloom membership, on the card against the same calls on CPU tensors,
   bit for bit; (b) three grouped epochs at a small size in float64 on the
   card against the CPU on the same keys, within 1e-9, for each
   item_scatter and once with Bloom membership; (c) the bpr CLI with its
   defaults on phase 3's ml100k files: factor files, falling losses, test
   AUC, and the recommend CLI serving from them; (d) BPREngine on phase 4's
   ml20m data with k = 30, 3 negatives, batch 32,768, float32: the init
   stages, one warm-up epoch and three timed, real triplet updates a
   second, losses, test AUC, the overflow count, peak memory; then the last
   epoch's packed stream decoded as the SGD loop decodes it, every real
   row checked: no negative chosen before the last round is a positive of
   its user; then (9p) one epoch under torch.profiler: wall ms beside
   device ms, launches, the largest kernels by device time, the host's ops
   by their own CPU time.
10. the sharded engines (qmf_tpu_torch/parallel): (a) ShardedWALSEngine
   over NCCL at world 1 on phase 4's data (device-packed, init's stages),
   the split path and fused with hot_width = 1024, 2 epochs each, against
   epochs 1-2 of phases 4 and 6
   (bit-for-bit equality printed, normwise error held at 5x phase 2's f32
   bound), with epoch seconds, launches and collective bytes per
   half-epoch, and its half-epochs with and without the mesh in turns;
   (b) two gloo ranks sharing the card (NCCL takes one card a rank),
   started by parallel.launch.spawn and reading files the parent wrote:
   WALS at ml20m (phase 4's configuration, 3 epochs: each rank's launches
   and epoch seconds, test AUC within 2e-3 of phase 4's, factors normwise
   within twice the spread between phases 6 and 4, and at least 5x phase
   2's f32 bound), WALS at phase 3's ml100k in float64 and BPR at phase
   9b's small size in float64, 3 epochs each, within 1e-9 of the
   single-device engines on the card; and which
   collectives gloo runs on CUDA tensors; (c) ShardedBPREngine over NCCL at
   world 1 with phase 9d's configuration, one warm-up and one timed epoch,
   updates/s beside 9d's, then one epoch under torch.profiler as 9p, then
   its parts: tools/bpr_decomp.decompose (the replayed epoch, pass 1 and
   the SGD loop in turns) and tools/bpr_grouped_micro's base, mesh and
   collective (the step's all_gather alone) on its stream, every ms
   finite and positive, pass 1 + loop and collective x steps beside its
   epoch and 9d's (16b's parts); (d)
   the wals CLI under torchrun's environment at world 1, --solver=fused
   on phase 3's files: each build_solve variant's launches against phase
   6's CLI run's, AUC against that run's.
   Then the launches of each kernel on the sharded paths.
11. the control plane (qmf_tpu_torch/distributed) through its three CLIs
   as subprocesses: (a) phase 4's ml20m split written as a ratings file, a
   task of k = 64, 3 epochs, solver "auto" on a wals_scheduler with no
   labor, submitted and polled with wals_submit, against the wals CLI on
   the same files (byte for byte, and normwise within 5x phase 2's f32
   bound): the worker's chol_solve launches, epochs, losses, start-up
   stages and init's stages, the worker's and the CLI's read and save
   through the native library, the worker's pack on the card, AUC on phase
   4's 3,000 test users within 2e-3 of phase 4's; (b)
   wals_scheduler --backend=gloo --device=cuda:0 and one wals_labor on
   phase 3's ml100k files, two ranks sharing the card: a float32 "fused"
   task (each rank's hot widths equal to one device's, and its launches of
   each build_solve variant one a chunk of its share, AUC within 2e-3 of
   phase 6's CLI run) and a float64 "auto" task within 1e-9 of one device; (c) that
   float64 task again with the labor's epochs stretched and its worker
   killed after its first epoch: two attempts, the second resumed from the
   checkpoint, within 1e-9 of one device; (d) one ml100k epoch under
   utils.tracing.trace (epochs dispatched one by one, fuse_epoch=False):
   the trace holds wals_epoch_1 and every chol_solve kernel of the epoch
   inside it. Then the launches of each kernel there.
12. one-program epochs as CUDA graphs (fuse_epoch, ops/graphs.py), run
   where their inputs are alive: (a) after phase 8, on phases 4 and 6's
   engines (phase 4's packed data, not read or packed again), the split
   path and fused+hot, 3 epochs each from their trained factors eagerly
   (fuse_epoch=False), one replay an epoch (checkpointing on) and as a
   whole run: factors and losses torch.equal to eager, launches an epoch
   by kernel equal to eager's (24 chol_solve.cu a split epoch), one replay
   and one eager epoch under torch.profiler (each of the port's kernels'
   events in the replay against what the launch counters add at it, and
   against the eager epoch's: every counted launch is a node), capture
   and instantiation seconds, epoch seconds, peak memory, then CUDA
   events around eager epochs and around replays (the replay's device ms
   is the epoch's busy time; the idle share is 1 - busy / wall); (b) after
   phase 9p: phase 9d's engine ran each grouped epoch (pass 1 and the SGD
   loop) as one graph, a fresh engine of its configuration runs it
   eagerly on the same keys: updates/s, wall and event ms an epoch, the
   replay's event ms, a floor on the eager epoch's idle share, peak
   memory, capture seconds and nodes, AUC within 1e-3 of each other; then
   phase 9b's size in float64, three epochs with a decaying rate, the
   graph within 1e-9 of the eager epoch on the card and on the CPU.
13. the rest of the one-program epochs, on live data: (d) right after
   12a, on phase 4's engine: WALS class_solve=False (chol_solve.cu once a
   chunk) against class_solve=True, 2 epochs each from the trained
   factors, eagerly and as a whole run: factors and losses torch.equal,
   launches an epoch, peak memory, epoch seconds, the replay's event ms,
   and the kernel against its plain version on one chunk; (a) after 12b,
   on phase 9d's engine: the grouped epoch as one graph beside 12b's form
   (pass 1 eager, the SGD loop a graph) and the eager epoch, each trained
   again from 9d's start (updates/s, wall and event ms, idle share,
   capture seconds and nodes, peak memory, AUC within 1e-3 of 9d's); then
   the rounds sampler: pass 1's stream and overflow count torch.equal to
   a compaction through torch.nonzero, and one epoch eager, captured and
   replayed; (b) the packed legacy epoch (grouped_epoch=False, batch
   32,768) and (c) the in-step one (batch 24,576, not a power of two: a
   graph of one step, replayed once a step, beside a graph of 64 steps),
   each eager, captured and replayed on one epoch's draws: updates/s,
   capture seconds, nodes. In each, the replay is held bit for bit to the
   eager epoch under torch.use_deterministic_algorithms (index_add_'s
   default atomics sum duplicate rows in the order the card runs them).
14. hot_width "auto" (ops/hot.py's rule with its H100 constants), right
   after 13d on phase 4's data: the fused build at "auto", 3 epochs (each
   build_solve variant's launches, test AUC within 2e-3 of phase 4's);
   then for the split build (phase 4's widths) and the fused one, each
   side: auto's pick, and the side's half-epoch replayed as a CUDA graph
   (tools/hot_micro.py: CUDA events, median of 5, the widths in turns) at
   H = 0, at the pick and at its neighbouring candidates, each beside the
   rule's modeled build ms; the pick's ratio to H = 0 (at most 1.03) and
   to the fastest width timed.

15. the measurement entry points: (b) right after 14, on phase 4's engine
   (no new init), tools/epoch_decomp.decompose: the replayed epoch, each
   side's build with and without the hot head and its solve, each part
   captured and replayed as a CUDA graph, every part finite and positive;
   (a) after the WALS engines are freed, ``python -m
   qmf_tpu_torch.tools.bench`` as a subprocess at its defaults (ml20m, k =
   64, 7 epochs, then BPR at k = 30) with one spread round: its two metric
   lines, finite, with the card's name and power limit; then the phase's
   seconds on a ``phase 15 total`` line.
16. the decomposition probes: (a) right after 15b, on phase 4's engine (at
   "auto"'s widths) and on the H = 0 engine of phases 5-7 (no new init),
   tools/build_attrib.attribute: each side's width classes, the split build
   with and without the hot head and the fused build_solve.cu with and
   without it, each class captured and replayed as a CUDA graph, every
   class's ms finite and positive, each side's sums beside 15b's side
   parts, and build_solve.cu's launches in the phase on a line of their
   own; (b) between 12b and 13, on phase 9d's engine (batch 32,768, word
   sampler) and on two fresh engines of its data (batch 8,192; the Bloom
   filter with the CSR check), each bpr_decomp.init_like 9d's engine:
   tools/bpr_decomp.decompose (the replayed epoch, pass 1 and the SGD loop
   timed in turns, pass 1's stages, the bench step's host parts), every
   part finite and positive, and on 9d's and the Bloom engine
   bpr_decomp.split_check: pass 1 and the loop, each a CUDA graph, replayed
   torch.equal to a graph of the epoch program under
   torch.use_deterministic_algorithms; then the phase's seconds on a
   ``phase 16 total`` line.
17. the grouped step's probe, right after 16b and before 13, on phase
   9d's engine as 16b leaves it (its epoch graph's nodes held to 52,177
   and the 6 of its three parts' stamps): tools/bpr_grouped_micro in
   engine mode (the first 100 steps of the engine's pass 1 stream, the
   JAX probe's seven variants) and in
   synthetic mode (the JAX probe's inputs and six default variants),
   each variant's steps a CUDA graph, all replayed in turns: ms a step,
   nodes a step, the difference from base, base's bytes bound and its
   share, updates/s, every ms finite and positive; base held to the
   production loop on the same steps under
   torch.use_deterministic_algorithms, torch.equal; then the phase's
   seconds on a ``phase 17 total`` line.
18. the recovery cost, right after 11 on 11a's ratings file:
   tools/recovery_cost's pair (k = 64, 3 epochs, solver "auto", a
   scheduler and one labor as two gloo ranks on cuda:0, epochs stretched
   as 11c's): run A uninterrupted, run B with the labor's worker killed
   after the first checkpoint; each wall, the kill, the detection, the
   resumed attempt's epochs, wall and start-up stages, each run's
   launches (on this line only), B's factors normwise within 5x phase 2's
   f32 bound of A's, and the card's name and power limit.

Phases 3, 4, 6, 10a, 10d, 11a and 14 run with fuse_epoch=True (the default):
on the card each epoch is a replay of a captured graph, and the launch
counts include the replays (ops/graphs.py keeps the counters true).

Then the run's seconds on a line of their own, a JSON line describing each
kernel (times, launches, errors, and the bound: the larger of the bytes it
must move over 3.35 TB/s and its operations over the peak rate of their
type), and as the last line ``{"ok": true, "device": {...}}``. Any failure raises, and the exit code is
not 0. There is no CPU path: without a CUDA device it fails at phase 0.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 42
# (B, k) of the ml20m user half-epoch's solve at the benchmarked width
ML20M_USERS, K_MAIN = 138_493, 64
# Kernel vs plain, normwise per system: |x_kernel - x_plain| <= tol *
# max(1, max|x_plain| of that system). f32: the 2e-4 of
# tests/test_pallas_solve.py (which holds it elementwise on 16 systems; over
# 4097 systems of its generator even plain f32 vs f64 exceeds it
# elementwise at k = 64, so it is applied per system). f64: 1e-10.
F32_TOL, F64_TOL = 2e-4, 1e-10
# Phase 5's grid, its wide (N, D) cases (the D split), and the hot width
# of its hot cases and of phase 6.
BS_KS, BS_DS, BS_NS, BS_H, HOT_WIDTH = (8, 30, 64), (8, 320, 512), \
    (1, 13, 300), 300, 1024
BS_WIDE = ((1, 4096), (8, 32768))
ALPHA, LAM = 40.0, 0.05  # WALSConfig's defaults
# Phase 7's grid: row widths, index counts, table rows.
GATHER_KS, GATHER_RS, GATHER_ROWS = (1, 3, 30, 64, 65, 128), \
    (1, 255, 513, 1 << 20), 997
# The gather kernels: gather_rows' variants, and "vec" with fill.
GATHER_KERNELS = ("vec", "warp", "tile", "fill")
# Phase 8: users a batch, list length, users held against numpy float64,
# the score gap below which two items may swap places in f32, and the bound
# on |f32 score - f64 score| (k = 64 products of factors below ~1).
SERVE_BATCH, SERVE_N, SERVE_SAMPLE, SERVE_GAP, SERVE_TOL = \
    4096, 10, 64, 1e-4, 1e-4
# Phase 9: bench.py's BPR configuration (k, negatives, batch), the rows of
# the presample comparison, CUDA against CPU in float64 on the same keys
# (atomics reorder float64 sums by rounding only), and the warm-up and
# timed epochs at ml20m.
BPR_K, BPR_NEG, BPR_BATCH = 30, 3, 32768
BPR_PACK_ROWS, BPR_F64_TOL, BPR_WARM, BPR_TIMED = 1 << 20, 1e-9, 1, 3
# Phase 13: the in-step legacy epoch's batch (not a power of two, so the
# engine samples inside each step), the prefix of its steps that the phase
# runs (one eager epoch of all 1,978 takes ~18 s on an H100), and the steps
# of the whole-epoch graph it is measured beside.
BPR_INSTEP_BATCH, INSTEP_STEPS, INSTEP_WHOLE_STEPS = 24576, 128, 64
# H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores, dense bf16 FLOP/s on them.
HBM_BPS, FP32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12


def _bound(nbytes: float, ops_s: float) -> tuple[float, str]:
    """(least ms, what bounds it) for ``nbytes`` moved and ``ops_s``
    seconds of arithmetic at peak."""
    bytes_s = nbytes / HBM_BPS
    return 1e3 * max(bytes_s, ops_s), "bytes" if bytes_s >= ops_s else \
        "operations"


def _chol_bound(bsz: int, k: int, item: int) -> tuple[float, str]:
    """chol_solve's bound: read the lower triangle and b, write x; k^3/3
    for the factor and 2 k^2 for the substitutions, on the CUDA cores."""
    nbytes = bsz * (k * (k + 1) // 2 + 2 * k) * item
    ops = bsz * (k ** 3 / 3 + 2 * k * k)
    return _bound(nbytes, ops / FP32_FLOPS)


def _bs_bound(args) -> tuple[float, str]:
    """build_solve's bound on its arguments: read every input once, write x
    and b; the stream's and the hot head's updates of A's lower triangle
    and b at the stream type's peak, the solve at fp32's."""
    import torch

    yg, w, conf, ytyl, hot, y_hot = args
    n, d, k = yg.shape
    upd = k * (k + 1) // 2 + k
    ins = [yg, w, conf, ytyl] + ([*hot, y_hot] if hot is not None else [])
    nbytes = sum(t.numel() * t.element_size() for t in ins) + 2 * n * k * 4
    h = 0 if y_hot is None else y_hot.shape[0]
    rate = BF16_FLOPS if yg.dtype == torch.bfloat16 else FP32_FLOPS
    ops_s = (2 * n * (d + h) * upd / rate
             + n * (k ** 3 / 3 + 2 * k * k) / FP32_FLOPS)
    return _bound(nbytes, ops_s)


def _normwise_err(got, want) -> tuple[float, float]:
    """(max abs error, max error over max(1, the system's max |x|))."""
    import torch

    diff = (got - want).abs()
    scale = torch.clamp(want.abs().amax(dim=1, keepdim=True), min=1.0)
    return float(diff.max()), float((diff / scale).max())


def _recorder(engine, epochs: list):
    """A WALSEngine progress_cb that appends (epoch, loss, seconds, (user,
    item) factors on the host) to ``epochs`` for every epoch, in either
    form of fuse_epoch: a whole run calls progress_cb once, at its end, so
    the engine's _fused_run is wrapped to keep the run's per-epoch losses;
    its epochs then share the run's seconds equally, and only the last
    holds factors (None before)."""
    run_losses = []
    run = engine._fused_run

    def fused_run(nepochs):
        run_losses[:] = run(nepochs)
        return run_losses

    def record(epoch, loss, dt):
        factors = (engine.user_factors.cpu(), engine.item_factors.cpu())
        n = max(1, len(run_losses))
        for e, x in enumerate(run_losses[:-1], epoch - n + 1):
            epochs.append((e, x, dt / n, None))
        epochs.append((epoch, loss, dt / n, factors))
        run_losses.clear()

    engine._fused_run = fused_run
    return record


def _line(phase: str, t0: float, **numbers) -> None:
    items = " ".join(f"{k}={v}" for k, v in numbers.items())
    print(f"phase {phase}: ok {items} ({time.time() - t0:.3f}s)", flush=True)


def card() -> str:
    """Phase 0: the card, or raise."""
    import torch

    t0 = time.time()
    if not torch.cuda.is_available():
        raise RuntimeError(
            "chip_smoke.py needs a CUDA device; torch.cuda.is_available() "
            "is False (there is no CPU path)"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _line("0 card", t0, torch=torch.__version__, cuda=torch.version.cuda,
          device=repr(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count())
    return smi


def build() -> None:
    """Phase 1: compile the host I/O library (g++) and the kernels (nvcc)
    from the checkout's sources."""
    from qmf_tpu_torch import kernels
    from qmf_tpu_torch.data import native

    t0 = time.time()
    host_lib = native.build()  # raises: no quiet fallback on the card's host
    if not native.available():
        raise RuntimeError(f"host I/O library: {native.unavailable_reason()}")
    host_s = time.time() - t0
    t1 = time.time()
    kernels.load()
    for ln in kernels.build_log.splitlines():
        if "registers" in ln or "spill" in ln:
            print("  ptxas:", ln.strip(), flush=True)
    _line("1 build", t0, lib=os.path.relpath(kernels.LIB_PATH),
          cuda_build_s=round(time.time() - t1, 3),
          host_io_lib=os.path.relpath(host_lib),
          host_io_build_s=round(host_s, 3))


def _spd_np(bsz: int, k: int, seed: int):
    """tests/test_pallas_solve.py's generator for k <= 64 (m m^T + 0.1 I);
    the better-conditioned m m^T / k + I above."""
    import numpy as np

    rng = np.random.default_rng(seed)
    m = rng.normal(size=(bsz, k, k))
    if k <= 64:
        a = m @ m.transpose(0, 2, 1) + 0.1 * np.eye(k)
    else:
        a = m @ m.transpose(0, 2, 1) / k + np.eye(k)
    return a, rng.normal(size=(bsz, k))


def _time_ms(fn, reps: int = 5) -> float:
    import torch

    fn()  # warm up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _median_ms(fns: dict, reps: int = 5) -> dict:
    """Median CUDA-event time of each callable, after one warm-up call
    each, the callables taking turns."""
    import statistics

    import torch

    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def kernel_check(ks=(1, 8, 16, 30, 31, 33, 64, 65, 128),
                 batches=(1, 13, 4097)) -> dict:
    """Phase 2: both entries of the kernel vs plain on the card, then both,
    the plain version and the library's batched solve timed. ``batches``
    above 128 run only up to k = 128; each k also runs one block's systems
    + 1 of either entry, and each dtype the largest k of either entry."""
    import torch

    from qmf_tpu_torch import kernels
    from qmf_tpu_torch.ops import spd_solve

    t0 = time.time()
    dev = torch.device("cuda")
    dtypes = (torch.float32, torch.float64)
    # "t": cholesky_solve_t on a resident batch-last buffer; "t_copy":
    # solve_spd(layout="t"), which makes that buffer itself
    entries = {
        "nat": lambda a, b: spd_solve.solve_spd(a, b),
        "t": lambda a, b: spd_solve.cholesky_solve_t(
            a.permute(1, 2, 0).contiguous(), b.t().contiguous()).t(),
        "t_copy": lambda a, b: spd_solve.solve_spd(a, b, layout="t"),
    }
    max_k = {(dt, e): kernels.chol_solve_max_k(dt, e != "nat")
             for dt in dtypes for e in entries}
    worst = {(dt, e): 0.0 for dt in dtypes for e in ("nat", "t")}
    cases = 0
    for k in sorted(set(ks) | set(max_k.values())):
        k_runs = [key for key, most in max_k.items() if k <= most]
        k_batches = {bsz for bsz in batches if bsz <= 128 or k <= 128}
        for dt in {dt for dt, _ in k_runs}:
            limits = kernels.chol_solve_limits(dt, k)
            k_batches |= {limits.systems_per_block + 1,
                          limits.systems_per_block_t + 1}
        for bsz in sorted(k_batches):
            a64, b64 = _spd_np(bsz, k, seed=1000 * k + bsz)
            for dtype in dtypes:
                a = torch.as_tensor(a64, dtype=dtype, device=dev)
                b = torch.as_tensor(b64, dtype=dtype, device=dev)
                want = spd_solve.solve_spd_reference(a, b)
                for entry in (e for dt, e in k_runs if dt == dtype):
                    got = entries[entry](a, b)
                    torch.cuda.synchronize()
                    err, scaled = _normwise_err(got, want)
                    tol = F32_TOL if dtype == torch.float32 else F64_TOL
                    if not scaled <= tol:
                        raise AssertionError(
                            f"k={k} B={bsz} {dtype} {entry}: normwise "
                            f"error {scaled} > {tol} (max abs {err})")
                    key = (dtype, entry[:1] if entry != "nat" else entry)
                    worst[key] = max(worst[key], err)
                    cases += 1
    # non-SPD rows: non-finite in both versions and through both entries,
    # the others of their block untouched; the last bad one in a tail block
    n30 = kernels.chol_solve_limits(torch.float32, 30)
    for entry, per_block in (("nat", n30.systems_per_block),
                             ("t", n30.systems_per_block_t)):
        n_nan = per_block + 3
        nan_rows = (2, 5 % per_block, per_block + 1)
        a64, b64 = _spd_np(n_nan, 30, seed=7)
        a64[list(nan_rows)] *= -1.0
        for dtype in dtypes:
            a = torch.as_tensor(a64, dtype=dtype, device=dev)
            b = torch.as_tensor(b64, dtype=dtype, device=dev)
            for x in (entries[entry](a, b),
                      spd_solve.solve_spd_reference(a, b)):
                bad = ~torch.isfinite(x).all(dim=1)
                if bad.tolist() != [i in nan_rows for i in range(n_nan)]:
                    raise AssertionError(
                        f"non-SPD rows ({entry}): {bad.tolist()}")

    # timing at the ml20m user side's shape, on well-conditioned systems:
    # the batch-first entry on (B, k, k); the batch-last entry on a resident
    # (k, k, B) buffer, no copy in the timed call; solve_spd(layout="t")
    # with its copy, and that copy alone; and the batch-first entry reading
    # the batch-last buffer through its strides, one warp a system (how the
    # batch-last operand was read before it had its own load). The two
    # entries' times for the `kernels` line are five calls back to back
    # each, as the batch-first entry has always been timed here; the rest,
    # and both entries again, take turns (medians), so that they compare
    # with each other under one clock and cache state
    g = torch.Generator(device=dev).manual_seed(SEED)
    m = torch.randn(ML20M_USERS, K_MAIN, K_MAIN, generator=g, device=dev)
    a = torch.baddbmm(torch.eye(K_MAIN, device=dev), m, m.transpose(1, 2),
                      alpha=1.0 / K_MAIN)
    del m
    b = torch.randn(ML20M_USERS, K_MAIN, generator=g, device=dev)
    a_t, b_t = a.permute(1, 2, 0).contiguous(), b.t().contiguous()
    x_t = torch.empty_like(b_t)
    a_tv, b_tv = a_t.permute(2, 0, 1), b_t.t()
    nat_ms = _time_ms(lambda: spd_solve.solve_spd(a, b))
    t_ms = _time_ms(lambda: spd_solve.cholesky_solve_t(a_t, b_t))
    ms = _median_ms({
        "nat": lambda: spd_solve.solve_spd(a, b),
        "t": lambda: spd_solve.cholesky_solve_t(a_t, b_t),
        "t_copy": lambda: spd_solve.solve_spd(a, b, layout="t"),
        "copy": lambda: (a.permute(1, 2, 0).contiguous(),
                         b.t().contiguous()),
        "strided": lambda: kernels.launch_chol_solve(a_tv, b_tv, x_t.t()),
        "plain": lambda: spd_solve.solve_spd_reference(a, b),
        "plain_t": lambda: spd_solve.solve_spd_reference(a_tv, b_tv),
        "library": lambda: torch.linalg.solve(a, b),
        "library_t": lambda: torch.linalg.solve(a_tv, b_tv),
    })
    want = spd_solve.solve_spd_reference(a, b)
    big_err, scaled = _normwise_err(spd_solve.solve_spd(a, b), want)
    big_err_t, scaled_t = _normwise_err(
        spd_solve.cholesky_solve_t(a_t, b_t).t(), want)
    if not max(scaled, scaled_t) <= F32_TOL:
        raise AssertionError(f"B={ML20M_USERS} k=64 f32: err {big_err} "
                             f"batch-first, {big_err_t} batch-last")
    del a, b, a_t, b_t, a_tv, b_tv, x_t, want
    torch.cuda.empty_cache()
    bound_ms, bound_by = _chol_bound(ML20M_USERS, K_MAIN, 4)
    limits = kernels.chol_solve_limits(torch.float32, K_MAIN)
    f32, f64 = dtypes
    _line("2 kernel", t0, cases=cases,
          max_abs_err_f32=worst[f32, "nat"], max_abs_err_f64=worst[f64, "nat"],
          max_abs_err_t_f32=worst[f32, "t"], max_abs_err_t_f64=worst[f64, "t"],
          max_k_f32=max_k[f32, "nat"], max_k_f64=max_k[f64, "nat"],
          max_k_t_f32=max_k[f32, "t"], max_k_t_f64=max_k[f64, "t"],
          timed_shape=f"({ML20M_USERS},{K_MAIN},{K_MAIN})f32",
          systems_per_block=limits.systems_per_block,
          system_bytes=limits.system_bytes,
          systems_per_block_t=limits.systems_per_block_t,
          system_bytes_t=limits.system_bytes_t,
          kernel_ms=nat_ms, kernel_t_entry_ms=t_ms,
          kernel_in_turns_ms=ms["nat"], kernel_t_entry_in_turns_ms=ms["t"],
          kernel_t_layout_ms=ms["t_copy"], batch_last_copy_ms=ms["copy"],
          strided_batch_first_entry_ms=ms["strided"],
          plain_ms=ms["plain"], plain_t_ms=ms["plain_t"],
          linalg_solve_ms=ms["library"], linalg_solve_t_ms=ms["library_t"],
          bound_ms=bound_ms, bound_by=bound_by,
          timed_max_abs_err=big_err, timed_max_abs_err_t=big_err_t)
    return {"ms": nat_ms, "plain_ms": ms["plain"],
            "library_ms": ms["library"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err_f32": worst[f32, "nat"],
            "t": {"ms": t_ms, "plain_ms": ms["plain_t"],
                  "library_ms": ms["library_t"],
                  "max_abs_err": worst[f32, "t"]}}


def _split(users, items, values, seed=SEED):
    """10% of the ratings, picked by a seeded RNG, held out as test."""
    import numpy as np

    from qmf_tpu_torch.data import Dataset

    test = np.random.default_rng(seed).random(len(users)) < 0.1
    return (Dataset(users[~test], items[~test], values[~test]),
            Dataset(users[test], items[test], values[test]))


def _engine_launches(engine) -> dict:
    """Launches of each kernel one epoch of an initialised engine makes:
    chol_solve once a class on the split path; on the fused path one
    build_solve call a chunk, of the hot variant on a side whose hot width
    is above 0."""
    from qmf_tpu_torch.ops import als_ops

    counts = dict.fromkeys(("chol_solve", "build_solve", "build_solve_hot"),
                           0)
    for side in ("user", "item"):
        classes, chunks, hot, _, _ = _side(engine, side)
        if engine._solver != "fused":
            counts["chol_solve"] += len(classes)
            continue
        key = "build_solve" if hot is None else "build_solve_hot"
        counts[key] += sum(len(als_ops._chunks(c[1].shape[0], ch))
                           for c, ch in zip(classes, chunks))
    return counts


def _path_launches(dataset, cfg, device: str = "cuda",
                   world: int = 1) -> tuple:
    """(:func:`_engine_launches` of an engine of ``cfg`` on ``dataset``,
    each side's hot width), the engine packed as the path's own packs, its
    widths resolved on ``device`` as the path resolves them (hot_width
    "auto": the rule of ops/hot.py). ``world`` packs as a sharded engine of
    that many ranks does, each of which launches as many."""
    from qmf_tpu_torch.models import WALSEngine

    class Packed(WALSEngine):
        def _row_multiple(self) -> int:
            return 8 * world

    engine = Packed(cfg, device=device)
    engine.init(dataset)
    return _engine_launches(engine), engine.hot_widths


def _auc_of_files(user_path, item_path, test, device,
                  num_test_users: int = 0):
    """Test AUC of saved factor files, over every test user, or over
    ``num_test_users`` of them drawn as phase 4's metrics engine draws
    them (seed SEED)."""
    import numpy as np
    import torch

    from qmf_tpu_torch.data import IdIndex, load_factors
    from qmf_tpu_torch.metrics import AUC
    from qmf_tpu_torch.models.engine import Engine

    (uids, ufd), (iids, ifd) = load_factors(user_path), load_factors(item_path)
    users, labels = Engine.init_avg_test_data(
        test, IdIndex(uids), IdIndex(iids), num_test_users, SEED)
    u = torch.as_tensor(ufd.factors[users], device=device)
    v = torch.as_tensor(ifd.factors, device=device)
    return AUC().compute(labels, u @ v.T), ufd.factors, ifd.factors, (
        np.asarray(uids), np.asarray(iids))


def cli_path(preset: str = "ml100k", device: str = "cuda",
             out_dir: str | None = None) -> dict:
    """Phase 3: the CLI with its defaults, through the kernel. Returns the
    paths of the ratings and factor files, which outlive the call where
    ``out_dir`` is given."""
    import numpy as np
    import torch

    from qmf_tpu_torch.tools.datagen import PRESETS, generate, write_ratings
    from qmf_tpu_torch import WALSConfig
    from qmf_tpu_torch.cli import wals as cli
    from qmf_tpu_torch.data import native
    from qmf_tpu_torch.models import WALSEngine
    from qmf_tpu_torch.ops import spd_solve

    t0 = time.time()
    train, test = _split(*generate(**PRESETS[preset], seed=SEED))
    cfg = WALSConfig()  # the CLI's defaults
    per_epoch, widths = _path_launches(train, cfg, device)
    expect = per_epoch["chol_solve"] * cfg.nepochs
    with (tempfile.TemporaryDirectory(prefix="qmf_chip_smoke_")
          if out_dir is None else contextlib.nullcontext(out_dir)) as tmp:
        paths = {n: os.path.join(tmp, n) for n in
                 ("train.txt", "test.txt", "user.dat", "item.dat")}
        for name, ds in (("train.txt", train), ("test.txt", test)):
            write_ratings(paths[name], ds.user_ids, ds.item_ids, ds.values)
        spd_solve.launches = 0
        native.last_path.update(read=None, write=None)
        rc = cli.main([
            f"--train_dataset={paths['train.txt']}",
            f"--test_dataset={paths['test.txt']}",
            "--test_avg_metrics=auc,p@10",
            f"--user_factors={paths['user.dat']}",
            f"--item_factors={paths['item.dat']}",
            f"--device={device}",
        ])
        launches = spd_solve.launches
        if rc != 0:
            raise AssertionError(f"wals CLI returned {rc}")
        io_path = dict(native.last_path)
        if io_path != {"read": "native", "write": "native"}:
            raise AssertionError(f"the CLI's read and save took {io_path}")
        read_same = _native_read_parity(paths["train.txt"], paths["test.txt"])
        auc, u_file, v_file, (uids, iids) = _auc_of_files(
            paths["user.dat"], paths["item.dat"], test, device)
    if launches != expect:
        raise AssertionError(f"CLI launched the kernel {launches} times, "
                             f"expected classes x epochs = {expect}")
    if not auc > 0.5:
        raise AssertionError(f"CLI test AUC {auc} <= 0.5")
    # the same training with the plain solve, on the card
    plain = WALSEngine(WALSConfig(solver="cholesky"), device=device)
    plain.init(train)
    plain.optimize()
    if not (np.array_equal(uids, plain.user_index.ids)
            and np.array_equal(iids, plain.item_index.ids)):
        raise AssertionError("factor file ids differ from the index order")
    diff = max(
        float(np.abs(f - t.cpu().numpy()).max())
        for f, t in ((u_file, plain.user_factors),
                     (v_file, plain.item_factors))
    )
    if not diff <= 2e-3:
        raise AssertionError(f"kernel vs plain-cholesky factors: {diff}")
    write_same = _native_write_parity(plain)
    torch.cuda.empty_cache()
    _line("3 cli", t0, preset=preset, ratings=len(train),
          hot_widths=widths, launches=launches, expected=expect,
          test_auc=auc,
          max_abs_factor_diff_vs_cholesky=diff, io_path=io_path,
          native_read_equal_to_numpy=read_same,
          native_write_bytes_equal_to_python=write_same)
    return paths


def _native_read_parity(*paths: str) -> bool:
    """Phase 3: the native reader's arrays against the numpy reader's on
    each file, or raise."""
    import numpy as np

    from qmf_tpu_torch.data import native
    from qmf_tpu_torch.data.dataset import _read_numpy

    for path in paths:
        got, want = native.read_dataset(path), _read_numpy(path)
        if not all(np.array_equal(getattr(got, f), getattr(want, f))
                   for f in ("user_ids", "item_ids", "values")):
            raise AssertionError(f"{path}: native and numpy readers differ")
    return True


def _native_write_parity(engine) -> bool:
    """Phase 3: the native writer's bytes against the Python writer's on
    ``engine``'s trained factors, with and without biases, or raise."""
    from qmf_tpu_torch.data import native
    from qmf_tpu_torch.data.factor_io import write_factors_python

    with tempfile.TemporaryDirectory(prefix="qmf_chip_smoke_") as tmp:
        for side in ("user", "item"):
            ids = getattr(engine, f"{side}_index").ids
            f = getattr(engine, f"{side}_factors").cpu().double().numpy()
            for biases in (None, f[:, 0] * 3):
                out = [os.path.join(tmp, n) for n in ("native", "python")]
                native.write_factors(out[0], ids, f, biases)
                write_factors_python(out[1], ids, f, biases)
                with open(out[0], "rb") as a, open(out[1], "rb") as b:
                    if a.read() != b.read():
                        raise AssertionError(
                            f"{side} factors: native and Python writers "
                            f"differ (biases: {biases is not None})")
    return True


def ml20m_data(preset: str = "ml20m"):
    """The (train, test) split phases 4 and 6 share, and its seconds."""
    from qmf_tpu_torch.tools.datagen import PRESETS, generate

    t0 = time.time()
    data = _split(*generate(**PRESETS[preset], seed=SEED))
    return data, time.time() - t0


def model_scale(data, t_data: float, device: str = "cuda",
                nepochs: int = 3) -> dict:
    """Phase 4: WALSEngine at ml20m scale, k = 64, through the kernel."""
    import numpy as np
    import torch

    from qmf_tpu_torch import MetricsConfig, WALSConfig
    from qmf_tpu_torch.metrics import MetricsEngine
    from qmf_tpu_torch.models import WALSEngine
    from qmf_tpu_torch.ops import als_ops, spd_solve

    t0 = time.time()
    train, test = data
    me = MetricsEngine(MetricsConfig(num_test_users=3000, seed=SEED))
    me.add_test_avg_metric("auc")
    cfg = WALSConfig(nfactors=K_MAIN, nepochs=nepochs,
                     matmul_precision="default", batch_rows=8192)
    engine = WALSEngine(cfg, me, device=device)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.time()
    engine.init(train)
    engine.init_test(test)
    torch.cuda.synchronize()
    t_init = time.time() - t1
    init_peak = torch.cuda.max_memory_allocated()
    if engine._pack_kind != "device-packed":
        raise AssertionError(f"phase 4 was {engine._pack_kind}")
    host_stages = _host_pack_equal(engine, train)
    epochs = []
    engine.progress_cb = _recorder(engine, epochs)
    n_classes = len(engine._user_classes) + len(engine._item_classes)
    spd_solve.launches = 0
    engine.optimize()
    launches = spd_solve.launches
    peak = torch.cuda.max_memory_allocated()
    losses = [loss for _, loss, _, _ in epochs]
    if launches != n_classes * nepochs:
        raise AssertionError(f"{launches} launches, expected "
                             f"{n_classes} classes x {nepochs} epochs")
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite losses {losses}")
    if any(b > a for a, b in zip(losses[1:], losses[2:])):
        raise AssertionError(f"loss rose after epoch 2: {losses}")
    _, auc = me.last("test_avg_auc")
    if not auc > 0.5:
        raise AssertionError(f"test AUC {auc} <= 0.5")

    # the kernel vs its plain version on this run's largest user class,
    # built against the trained item factors (not counted above)
    biggest = max(range(len(engine._user_classes)),
                  key=lambda i: engine._user_classes[i][1].shape[0])
    _, col, val, mask = engine._user_classes[biggest]
    y = engine.item_factors
    a, b, _ = als_ops._build_chunked(
        y, als_ops.gramian(y), col, val, mask, cfg.confidence_weight,
        cfg.regularization_lambda, cfg.matmul_precision,
        engine._user_chunks[biggest])
    x_kernel = spd_solve.solve_spd(a, b)
    x_plain = spd_solve.solve_spd_reference(a, b)
    scale = float(x_plain.abs().max())
    err, scaled = _normwise_err(x_kernel, x_plain)
    # both are f32 Cholesky solves of the same systems: their gap is
    # rounding times each system's conditioning, which trained WALS systems
    # do not bound as the synthetic ones of phase 2 do; 5x phase 2's bound
    if not scaled <= 5 * F32_TOL:
        raise AssertionError(f"largest class: kernel vs plain normwise "
                             f"error {scaled} (max abs {err}, max|x| {scale})")
    _line("4 ml20m", t0, users=engine.nusers, items=engine.nitems,
          ratings=len(train), k=K_MAIN, hot_widths=engine.hot_widths,
          data_s=round(t_data, 3),
          init_s=round(t_init, 3), pack=engine._pack_kind,
          init_stages=_stages(engine), init_peak_bytes=init_peak,
          device_pack_s=_pack_s(engine._init_stages),
          host_pack_s=_pack_s(host_stages), host_pack_init_stages={
              k: round(v, 3) for k, v in host_stages.items()},
          host_pack_classes_equal=True,
          epoch_program=_program_kind(engine),
          epoch_s=[round(dt, 4) for _, _, dt, _ in epochs],
          losses=[f"{x:.10g}" for x in losses], test_auc=auc,
          classes=n_classes, launches=launches,
          launches_per_epoch=launches / nepochs, peak_bytes=peak,
          class_rows=a.shape[0], class_max_abs_err=err, class_normwise_err=scaled,
          class_max_abs_x=scale)
    return {"launches": launches, "max_abs_err": err, "engine": engine,
            "auc": auc, "epoch_s": [dt for _, _, dt, _ in epochs],
            "epochs": epochs, "hot_widths": dict(engine.hot_widths)}


def unsplit_engine(engine, data, device: str = "cuda"):
    """Phase 4's engine with both hot widths at 0: ``engine`` itself where
    hot_width "auto" resolved 0 on both sides, else its configuration
    packed again at H = 0 (tools/build_attrib.h0_engine) holding its
    trained factors. Phases 5-7 time the kernels on its classes, as every
    run before hot_width "auto" did."""
    from qmf_tpu_torch.tools import build_attrib

    return build_attrib.h0_engine(engine, data[0], device)


def _program_kind(engine) -> str:
    """How a WALSEngine ran its epochs: a CUDA graph, eager ops as one
    program (with the reasons), or dispatched one by one."""
    from qmf_tpu_torch.ops import graphs

    if not engine.config.fuse_epoch:
        return "eager(fuse_epoch=False)"
    if isinstance(engine._program, graphs.EpochGraph):
        return (f"cuda_graph(capture_s={engine._program.capture_s:.4f},"
                f"replays={engine._program.replays})")
    return f"eager({'; '.join(engine._eager_reasons)})"


def _stages(engine) -> dict:
    """An engine's init stages, in ms-rounded seconds."""
    return {k: round(v, 3) for k, v in engine._init_stages.items()}


def _pack_s(stages: dict) -> float:
    """Seconds of both sides' pack."""
    return round(stages["pack_user"] + stages["pack_item"], 3)


def _host_pack_equal(engine, train) -> dict:
    """Phase 4: the same data and configuration packed once more on the
    host; every class's four tensors must equal the device pack's, element
    for element. Returns the host-packed engine's init stages."""
    import dataclasses

    import torch

    from qmf_tpu_torch.models import WALSEngine

    host = WALSEngine(dataclasses.replace(engine.config, device_pack=False),
                      device=engine.device)
    host.init(train)
    if host._pack_kind != "host-packed":
        raise AssertionError(f"the host pack was {host._pack_kind}")
    for side in ("user", "item"):
        got, want = (getattr(e, f"_{side}_classes") for e in (engine, host))
        if getattr(engine, f"_{side}_chunks") != \
                getattr(host, f"_{side}_chunks") or len(got) != len(want):
            raise AssertionError(f"{side}: device and host packs differ in "
                                 "their classes or chunks")
        for i, (g, w) in enumerate(zip(got, want)):
            for name, a, b in zip(("row_ids", "col_idx", "values", "mask"),
                                  g, w):
                if a.dtype != b.dtype or not torch.equal(a, b):
                    raise AssertionError(f"{side} class {i}: {name} of the "
                                         "device pack differs from the host "
                                         "pack's")
    stages = host._init_stages
    del host
    torch.cuda.empty_cache()
    return stages


def _bs_inputs(n: int, d: int, k: int, h: int, dtype, seed: int,
               device: str = "cuda") -> list:
    """Seeded build_solve arguments on the card: the gathered rows of a
    random fixed-side table with WALS weights (alpha r on ~80% of the
    slots) and, for h > 0, a hot head of h rows observed at ~30% density."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n_cols = 4 * k + 64
    y = rng.normal(0.0, 0.3, (n_cols, k))
    mask = rng.random((n, d)) < 0.8
    w = ALPHA * rng.integers(1, 11, (n, d)) * 0.5 * mask
    f32 = dict(dtype=torch.float32, device=device)
    args = [torch.as_tensor(y[rng.integers(0, n_cols, (n, d))], **f32).to(
        dtype), torch.as_tensor(w, **f32), torch.as_tensor(mask + w, **f32),
        torch.as_tensor(y.T @ y + LAM * np.eye(k), **f32)]
    if not h:
        return args + [None, None]
    seen = rng.random((n, h)) < 0.3
    w_a = ALPHA * rng.integers(1, 11, (n, h)) * 0.5 * seen
    hot = tuple(torch.as_tensor(v, **f32).to(dtype)
                for v in (w_a, w_a + seen))
    return args + [hot, torch.as_tensor(rng.normal(0.0, 0.3, (h, k)),
                                        **f32).to(dtype)]


def _bs_compare(args, tol: float) -> float:
    """build_solve's kernel against its plain version on ``args``: raises
    unless x and b agree normwise per row within ``tol``; returns the max
    abs error of x."""
    import torch

    from qmf_tpu_torch.ops import build_solve

    x, b = build_solve.build_solve(*args)
    x_plain, b_plain = build_solve.build_solve_reference(*args)
    torch.cuda.synchronize()
    err, scaled = _normwise_err(x, x_plain)
    b_err, b_scaled = _normwise_err(b, b_plain)
    if not (scaled <= tol and b_scaled <= tol):
        raise AssertionError(
            f"build_solve vs plain: x normwise {scaled} (max abs {err}), "
            f"b normwise {b_scaled} (max abs {b_err}), bound {tol}")
    return err


def _side(engine, side: str) -> tuple:
    """(classes, chunks, hot state, fixed-side factors, rows) of one side
    of an engine: what als_ops.train_epoch hands _solve_side."""
    if side == "user":
        return (engine._user_classes, engine._user_chunks, engine._user_hot,
                engine.item_factors, engine.nusers)
    return (engine._item_classes, engine._item_chunks, engine._item_hot,
            engine.user_factors, engine.nitems)


def _class_inputs(engine, i: int, side: str = "user") -> list:
    """build_solve's arguments for class i of one side of a trained engine,
    formed from the other side's factors as als_ops._solve_side forms
    them."""
    import torch

    from qmf_tpu_torch.ops import als_ops

    cfg = engine.config
    classes, _, hot, y, _ = _side(engine, side)
    _, col, val, mask = classes[i]
    y_s = y.to(torch.bfloat16) if cfg.matmul_precision == "default" else y
    maskf = mask.to(val.dtype)
    w = cfg.confidence_weight * val * maskf
    ytyl = als_ops.gramian(y) + cfg.regularization_lambda * torch.eye(
        y.shape[1], device=y.device)
    args = [y_s[col], w, maskf + w, ytyl, None, None]
    if hot is not None:
        ids, hot_classes = hot
        args[4] = hot_classes[i][:2]
        args[5] = als_ops.hot_tables(y[ids], cfg.matmul_precision)[0]
    return args


def _biggest_user_class(engine) -> int:
    return max(range(len(engine._user_classes)),
               key=lambda i: engine._user_classes[i][1].shape[0])


def _time_class(engine, i: int, side: str) -> tuple:
    """Kernel, plain and the split path's build + chol_solve on class i of
    one side, against the trained factors of the other: (shape, kernel
    max abs error, {name: median ms}, the kernel's (bound ms, bound by))."""
    from qmf_tpu_torch.ops import als_ops, build_solve

    cfg = engine.config
    classes, chunks, _, y, _ = _side(engine, side)
    _, col, val, mask = classes[i]
    args = _class_inputs(engine, i, side)
    # trained WALS systems: phase 4's bound for its trained class
    err = _bs_compare(args, 5 * F32_TOL)
    yty = als_ops.gramian(y)
    ms = _median_ms({
        "kernel": lambda: build_solve.build_solve(*args),
        "plain": lambda: build_solve.build_solve_reference(*args),
        "split": lambda: als_ops._solve_bucket_body(
            y, yty, col, val, mask, cfg.confidence_weight,
            cfg.regularization_lambda, "kernel", cfg.matmul_precision,
            chunks[i]),
    })
    return (f"({col.shape[0]},{col.shape[1]},{y.shape[1]})bf16", err, ms,
            _bs_bound(args))


def fused_kernel_check(split_engine, device: str = "cuda") -> dict:
    """Phase 5: the build+solve kernel vs plain over the grid and the wide
    cases, then the kernel, plain and the split path timed on phase 4's
    largest user class and widest item class, against its trained
    factors."""
    import itertools

    import torch

    from qmf_tpu_torch.ops import build_solve

    t0 = time.time()
    worst = 0.0
    grid = list(itertools.product((torch.bfloat16, torch.float32),
                                  (0, BS_H), BS_KS, BS_DS, BS_NS))
    grid += [(dtype, h, k, d, n) for dtype, h, k, (n, d) in itertools.product(
        (torch.bfloat16, torch.float32), (0, BS_H), BS_KS, BS_WIDE)]
    for seed, (dtype, h, k, d, n) in enumerate(grid):
        args = _bs_inputs(n, d, k, h, dtype, seed, device)
        worst = max(worst, _bs_compare(args, F32_TOL))
    # rows with no weight have A = ytyl; a negative-definite ytyl gives NaN
    # there, and the weighted rows stay SPD
    args = _bs_inputs(8, 64, 30, 0, torch.bfloat16, 7, device)
    for t in args[1:3]:
        t[[2, 5]] = 0.0
    args[3] = -LAM * torch.eye(30, device=device)
    for x, _ in (build_solve.build_solve(*args),
                 build_solve.build_solve_reference(*args)):
        bad = ~torch.isfinite(x).all(dim=1)
        if bad.tolist() != [i in (2, 5) for i in range(8)]:
            raise AssertionError(f"non-SPD rows: {bad.tolist()}")

    engine = split_engine
    user_shape, err, ms, bound = _time_class(
        engine, _biggest_user_class(engine), "user")
    widest = max(range(len(engine._item_classes)),
                 key=lambda i: engine._item_classes[i][1].shape[1])
    item_shape, item_err, item_ms, item_bound = _time_class(
        engine, widest, "item")
    _line("5 build_solve", t0, cases=len(grid), max_abs_err=worst,
          timed_class=user_shape, class_max_abs_err=err,
          kernel_ms=ms["kernel"], plain_ms=ms["plain"], bound_ms=bound[0],
          bound_by=bound[1], item_bound_ms=item_bound[0],
          split_build_chol_ms=ms["split"], widest_item_class=item_shape,
          item_max_abs_err=item_err, item_kernel_ms=item_ms["kernel"],
          item_plain_ms=item_ms["plain"],
          item_split_build_chol_ms=item_ms["split"])
    return {"max_abs_err": err, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound[0], "bound_by": bound[1]}


def _cli_fused(preset: str = "ml100k", device: str = "cuda") -> tuple:
    """The CLI with --solver=fused: each side at the width hot_width
    "auto" resolves, so build_solve's two variants launch once a chunk
    each, the hot one on a side above 0. Returns (launches of each
    variant, their expected counts an epoch, the widths, test AUC)."""
    from qmf_tpu_torch.tools.datagen import PRESETS, generate, write_ratings
    from qmf_tpu_torch import WALSConfig
    from qmf_tpu_torch.cli import wals as cli
    from qmf_tpu_torch.ops import build_solve, spd_solve

    train, test = _split(*generate(**PRESETS[preset], seed=SEED))
    cfg = WALSConfig(solver="fused")
    per_epoch, widths = _path_launches(train, cfg, device)
    expect = (per_epoch["build_solve"] * cfg.nepochs,
              per_epoch["build_solve_hot"] * cfg.nepochs, 0)
    with tempfile.TemporaryDirectory(prefix="qmf_chip_smoke_") as tmp:
        paths = {n: os.path.join(tmp, n) for n in
                 ("train.txt", "test.txt", "user.dat", "item.dat")}
        for name, ds in (("train.txt", train), ("test.txt", test)):
            write_ratings(paths[name], ds.user_ids, ds.item_ids, ds.values)
        build_solve.launches = build_solve.launches_hot = 0
        spd_solve.launches = 0
        rc = cli.main([
            f"--train_dataset={paths['train.txt']}",
            f"--test_dataset={paths['test.txt']}",
            "--test_avg_metrics=auc", "--solver=fused",
            f"--user_factors={paths['user.dat']}",
            f"--item_factors={paths['item.dat']}",
            f"--device={device}",
        ])
        counts = (build_solve.launches, build_solve.launches_hot,
                  spd_solve.launches)
        if rc != 0:
            raise AssertionError(f"wals CLI --solver=fused returned {rc}")
        auc = _auc_of_files(paths["user.dat"], paths["item.dat"], test,
                            device)[0]
    if counts != expect or not sum(counts) > 0:
        raise AssertionError(f"CLI --solver=fused launches (build_solve, "
                             f"build_solve_hot, chol_solve) = {counts}, "
                             f"expected {expect} at widths {widths}")
    if not auc > 0.5:
        raise AssertionError(f"CLI --solver=fused test AUC {auc} <= 0.5")
    return ({"build_solve": counts[0], "build_solve_hot": counts[1]},
            per_epoch, widths, auc)


def _half_epoch_ms(paths: dict) -> dict:
    """Median ms of the user and item half-epochs (als_ops._solve_side on
    an engine's classes and trained factors) of each path, name ->
    (engine, solver, mesh or None), the paths taking turns."""
    from qmf_tpu_torch.ops import als_ops

    fns = {}
    for name, (engine, solver, mesh) in paths.items():
        cfg = engine.config
        for side in ("user", "item"):
            classes, chunks, hot, y, n = _side(engine, side)
            fns[f"{name}_{side}"] = (
                lambda y=y, c=classes, ch=chunks, n=n, hot=hot, s=solver,
                cfg=cfg, m=mesh: als_ops._solve_side(
                    y, c, ch, n, cfg.confidence_weight,
                    cfg.regularization_lambda, s, cfg.matmul_precision, hot,
                    m))
    return _median_ms(fns, reps=3)


def _item_class_ms(engine) -> list:
    """(rows, width, median ms) of each item class of a fused engine, one
    class at a time through als_ops._solve_side."""
    from qmf_tpu_torch.ops import als_ops

    cfg = engine.config
    classes, chunks, hot, y, n = _side(engine, "item")
    fns = {}
    for i in range(len(classes)):
        one_hot = None if hot is None else (hot[0], [hot[1][i]])
        fns[i] = (lambda i=i, one_hot=one_hot: als_ops._solve_side(
            y, [classes[i]], [chunks[i]], n, cfg.confidence_weight,
            cfg.regularization_lambda, "fused", cfg.matmul_precision,
            one_hot))
    ms = _median_ms(fns, reps=3)
    return [(classes[i][1].shape[0], classes[i][1].shape[1], ms[i])
            for i in fns]


def fused_path(data, split: dict, split_engine, device: str = "cuda",
               nepochs: int = 3) -> dict:
    """Phase 6: solver="fused" through the CLI (ml100k, hot_width "auto"),
    then WALSEngine at ml20m, k = 64, hot_width = 1024, on phase 4's data;
    then its item classes, and the half-epochs of the split path and the
    fused path without the hot head (both on ``split_engine``, phase 4's
    data at H = 0) and with it."""
    import numpy as np
    import torch

    from qmf_tpu_torch import MetricsConfig, WALSConfig
    from qmf_tpu_torch.metrics import MetricsEngine
    from qmf_tpu_torch.models import WALSEngine
    from qmf_tpu_torch.ops import build_solve, spd_solve

    t0 = time.time()
    cli_launches, cli_expect, cli_widths, cli_auc = _cli_fused(
        device=device)
    train, test = data
    me = MetricsEngine(MetricsConfig(num_test_users=3000, seed=SEED))
    me.add_test_avg_metric("auc")
    cfg = WALSConfig(nfactors=K_MAIN, nepochs=nepochs,
                     matmul_precision="default", batch_rows=8192,
                     solver="fused", hot_width=HOT_WIDTH)
    engine = WALSEngine(cfg, me, device=device)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.time()
    engine.init(train)
    engine.init_test(test)
    torch.cuda.synchronize()
    t_init = time.time() - t1
    epochs = []
    engine.progress_cb = _recorder(engine, epochs)
    chunks = sum(-(-c[1].shape[0] // ch) for c, ch in zip(
        engine._user_classes + engine._item_classes,
        engine._user_chunks + engine._item_chunks))
    build_solve.launches = build_solve.launches_hot = 0
    spd_solve.launches = 0
    engine.optimize()
    counts = (build_solve.launches, build_solve.launches_hot,
              spd_solve.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [loss for _, loss, _, _ in epochs]
    if counts != (0, chunks * nepochs, 0):
        raise AssertionError(
            f"launches (build_solve, build_solve_hot, chol_solve) = "
            f"{counts}, expected (0, {chunks} chunks x {nepochs} epochs, 0)")
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite losses {losses}")
    if any(b >= a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"losses did not fall: {losses}")
    _, auc = me.last("test_avg_auc")
    if not abs(auc - split["auc"]) <= 2e-3:
        raise AssertionError(f"fused+hot test AUC {auc} vs split path "
                             f"{split['auc']}: differ by more than 2e-3")

    # the hot variant vs its plain version on this run's largest user
    # class, against the trained item factors (not counted above)
    i = _biggest_user_class(engine)
    args = _class_inputs(engine, i)
    err = _bs_compare(args, 5 * F32_TOL)
    ms = _median_ms({
        "kernel": lambda: build_solve.build_solve(*args),
        "plain": lambda: build_solve.build_solve_reference(*args),
    })
    bound_ms, bound_by = _bs_bound(args)
    item_classes = _item_class_ms(engine)
    half = _half_epoch_ms({"split_h0": (split_engine, "kernel", None),
                           "fused_h0": (split_engine, "fused", None),
                           "fused_hot": (engine, "fused", None)})
    _line("6 fused", t0, cli_preset="ml100k", cli_hot_widths=cli_widths,
          cli_launches=cli_launches, cli_test_auc=cli_auc,
          users=engine.nusers, items=engine.nitems,
          k=K_MAIN, hot_width=HOT_WIDTH, init_s=round(t_init, 3),
          pack=engine._pack_kind, init_stages=_stages(engine),
          epoch_program=_program_kind(engine),
          epoch_s=[round(dt, 4) for _, _, dt, _ in epochs],
          split_epoch_s=[round(dt, 4) for dt in split["epoch_s"]],
          losses=[f"{x:.10g}" for x in losses], test_auc=auc,
          split_test_auc=split["auc"], chunks=chunks, launches=counts[1],
          peak_bytes=peak,
          timed_class=f"({args[0].shape[0]},{args[0].shape[1]},{K_MAIN})"
                      f"bf16+H{args[5].shape[0]}",
          class_max_abs_err=err, kernel_ms=ms["kernel"],
          plain_ms=ms["plain"], bound_ms=bound_ms, bound_by=bound_by,
          item_class_ms="[" + ",".join(
              f"({r},{w},{t:.4f})" for r, w, t in item_classes) + "]",
          **{f"half_epoch_ms_{name}": round(t, 4)
             for name, t in half.items()})
    return {"launches": counts[1], "cli_launches": cli_launches,
            "cli_expect": cli_expect, "cli_auc": cli_auc, "max_abs_err": err, "ms": ms["kernel"],
            "plain_ms": ms["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "epochs": epochs, "engine": engine}


def profile_split_user(engine) -> None:
    """Phase 4p: the split path's user half-epoch (as phase 6 times it)
    once under torch.profiler, after one warm-up: device ms, and the
    largest kernels and copies by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from qmf_tpu_torch.ops import als_ops

    t0 = time.time()
    cfg = engine.config
    classes, chunks, hot, y, n = _side(engine, "user")

    def half_epoch():
        als_ops._solve_side(y, classes, chunks, n, cfg.confidence_weight,
                            cfg.regularization_lambda, "kernel",
                            cfg.matmul_precision, hot)
        torch.cuda.synchronize()

    half_epoch()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        half_epoch()

    def self_ms(e):
        return e.self_device_time_total / 1e3

    # device-side events only (kernels, copies): an operator's self device
    # time repeats its kernels'
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and self_ms(e) > 0]
    events.sort(key=self_ms, reverse=True)
    chol = [e for e in events if "chol_solve_kernel" in e.key]
    if not chol:
        raise AssertionError("the profile shows no chol_solve_kernel")
    top = ", ".join(f"{e.key[:60]!r}:{self_ms(e):.3f}ms/{e.count}"
                    for e in events[:8])
    _line("4p profile", t0, half_epoch="split_user",
          device_ms=round(sum(self_ms(e) for e in events), 3),
          chol_solve_kernel_ms=round(sum(self_ms(e) for e in chol), 3),
          chol_solve_kernel_calls=sum(e.count for e in chol),
          top=f"[{top}]")


def _gather_cases(device: str = "cuda") -> int:
    """Every gather kernel against the plain version, bit for bit, over the
    grid, a table view that starts one element into its storage, and a 2-D
    index. Returns the number of cases; raises on the first that differs."""
    import itertools

    import torch

    from qmf_tpu_torch.ops import gather

    g = torch.Generator(device=device).manual_seed(SEED)

    def check(table, idx, kernel, what):
        fill = kernel == "fill"
        got = gather.gather_rows(table, idx, "vec" if fill else kernel, fill)
        torch.cuda.synchronize()
        want = gather.gather_rows_plain(table, idx, fill)
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"gather {kernel} differs from plain: {what}")

    def indices(shape, kernel, dtype):
        lo, hi = ((-GATHER_ROWS - 3, GATHER_ROWS + 3) if kernel == "fill"
                  else (0, GATHER_ROWS))
        return torch.randint(lo, hi, shape, generator=g,
                             device=device).to(dtype)

    dtypes = (torch.bfloat16, torch.float32, torch.float64)
    cases = 0
    for dtype, k in itertools.product(dtypes, GATHER_KS):
        table = torch.randn(GATHER_ROWS, k, generator=g,
                            device=device).to(dtype)
        for n, idx_dtype, kernel in itertools.product(
                GATHER_RS, (torch.int32, torch.int64), GATHER_KERNELS):
            check(table, indices((n,), kernel, idx_dtype), kernel,
                  f"{dtype} k={k} R={n} {idx_dtype}")
            cases += 1
    for dtype, kernel in itertools.product(dtypes, GATHER_KERNELS):
        flat = torch.randn(1 + GATHER_ROWS * 64, generator=g,
                           device=device).to(dtype)
        view = flat[1:].view(GATHER_ROWS, 64)
        width = gather.vector_bytes(64 * view.element_size(),
                                    view.data_ptr(), 0)
        if view.data_ptr() % 16 == 0 or width != view.element_size():
            raise AssertionError(f"the view at {view.data_ptr():#x} does not "
                                 f"break 16-byte alignment (width {width})")
        check(view, indices((7, 33), kernel, torch.int64), kernel,
              f"{dtype} view one element into its storage, 2-D index")
        cases += 1
    return cases


def _gather_timed(table, idx) -> dict:
    """The kernels, their plain versions and index_select on one
    (table, idx), checked bit for bit and then timed in turns: median ms by
    name, with the two bounds as ``bound`` and ``every_row``."""
    import torch

    from qmf_tpu_torch.ops import gather
    from qmf_tpu_torch.tools import gather_micro

    flat = idx.reshape(-1)
    fns = {
        **{v: (lambda v=v: gather.gather_rows(table, flat, v))
           for v in GATHER_KERNELS[:-1]},
        "fill": lambda: gather.gather_rows(table, flat, "vec", True),
        "plain": lambda: gather.gather_rows_plain(table, flat),
        "plain_fill": lambda: gather.gather_rows_plain(table, flat, True),
        "index_select": lambda: torch.index_select(table, 0, flat),
    }
    want = fns["index_select"]()
    for name in GATHER_KERNELS:
        got = fns[name]()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"gather {name} differs from index_select at table "
                f"{tuple(table.shape)} {table.dtype}, {flat.numel()} rows")
    del want, got
    out = gather_micro.median_ms(fns, table.device)
    out["bound"], out["every_row"] = gather_micro.gather_bounds(table, flat)
    return out


def gather_check(engine, device: str = "cuda") -> dict:
    """Phase 7: the gather kernels vs plain, the probes' entry points (the
    path whose launches are counted), and the kernels timed beside
    index_select at the probes' shapes and on phase 4's largest user
    class."""
    import torch

    from qmf_tpu_torch.ops import gather, spd_solve
    from qmf_tpu_torch.tools import (gather_micro, solver_micro,
                                     vmem_gather_micro)

    t0 = time.time()
    dev = torch.device(device)
    cases = _gather_cases(device)

    # the probes, as their entry points run them; their tables go to stderr
    for name in gather.launches:
        gather.launches[name] = 0
    spd_solve.launches_t = 0
    with contextlib.redirect_stdout(sys.stderr):
        micro = gather_micro.sweep(device=dev)
        vmem = vmem_gather_micro.sweep(device=dev)
        solver = solver_micro.sweep(device=dev)
    launches = dict(gather.launches, chol_solve_t=spd_solve.launches_t)
    if not all(launches.values()):
        raise AssertionError(f"a kernel was never launched by the probes: "
                             f"{launches}")
    if vmem["l2_limit_after"] != 0:
        raise AssertionError(f"persisting L2 carve-out left at "
                             f"{vmem['l2_limit_after']} bytes")

    rng, _, yb = gather_micro.tables(dev)
    n, d = gather_micro.DEFAULT_SPECS[0]
    at_micro = _gather_timed(yb, gather_micro.indices(rng, n, d, dev)[1])
    at_vmem = _gather_timed(*vmem_gather_micro.inputs(
        vmem_gather_micro.DEFAULT_LOG2, dev))
    # real traffic: phase 4's largest user class against the item factors
    col = engine._user_classes[_biggest_user_class(engine)][1]
    at_class = _gather_timed(engine.item_factors.to(torch.bfloat16), col)
    torch.cuda.empty_cache()

    def ms(d, names):
        return {f"{n}_ms": round(d[n], 5) for n in names}

    spec_ms = {
        f"micro_{r['spec'][0]}x{r['spec'][1]}": "[" + ",".join(
            f"{k}:{v:.5f}" for k, v in r["ms"].items()) + "]"
        for r in micro}
    _line("7 gather", t0, cases=cases, max_abs_diff=0.0,
          probe_launches=launches, **spec_ms,
          micro_bound_ms=[round(r["bound_ms"], 5) for r in micro],
          micro_every_row_ms=[round(r["every_row_ms"], 5) for r in micro],
          vmem_rows=vmem["rows"], vmem="[" + ",".join(
              f"{k}:{v:.5f}" for k, v in vmem["ms"].items()) + "]",
          vmem_bound_ms=round(vmem["bound_ms"], 5),
          vmem_every_row_ms=round(vmem["every_row_ms"], 5),
          l2_limit_after=vmem["l2_limit_after"],
          **{f"solver_B{r['batch']}": "[" + ",".join(
              f"{k}:{v:.5f}" for k, v in r["ms"].items()) + "]"
             for r in solver},
          timed_micro=f"({n * d},64)bf16/int32",
          **{f"micro_{k}": v for k, v in ms(
              at_micro, (*GATHER_KERNELS, "plain",
                         "index_select")).items()},
          timed_vmem=f"({vmem['rows']},64)bf16/int32",
          **{f"vmem_{k}": v for k, v in ms(
              at_vmem, ("vec", "tile", "fill", "plain_fill",
                        "index_select")).items()},
          timed_class=f"({col.shape[0]},{col.shape[1]})int64 from "
                      f"({engine.nitems},{K_MAIN})bf16",
          **{f"class_{k}": v for k, v in ms(
              at_class, (*GATHER_KERNELS, "index_select",
                         "bound", "every_row")).items()})
    return {"launches": launches, "micro": at_micro, "vmem": at_vmem}


def _parse_recommendations(path: str) -> dict:
    """user id -> [(item id, score), ...] of a recommend CLI output file;
    raises on a line that does not parse."""
    out = {}
    with open(path) as f:
        for ln in f:
            user, _, rest = ln.rstrip("\n").partition("\t")
            pairs = [p.split(":") for p in rest.split()]
            out[int(user)] = [(int(i), float(v)) for i, v in pairs]
    return out


def _exclude_seen_timed(uf, itf, seen, users) -> dict:
    """exclude_seen.cu on one batch's scores (``users``' rows of the
    factors) and seen set: against its plain version bit for bit, then
    both timed back to back (a launch of ~20 us timed alone reads the
    host's dispatch, not the card), with the bytes bound (each seen id read
    once and as many elements written, the users and two indptr reads a
    row)."""
    import torch

    from qmf_tpu_torch.ops import als_ops, exclude_seen

    users = torch.as_tensor(users, device=uf.device)
    scores = als_ops.compute_scores(uf[users], itf)
    want = exclude_seen.exclude_seen_plain(scores.clone(), seen, users)
    got = exclude_seen.exclude_seen_(scores.clone(), seen, users)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
        raise AssertionError("exclude_seen.cu differs from its plain version "
                             f"on a batch of {users.shape[0]} users")
    at = users.long()
    nnz = int((seen.indptr[at + 1] - seen.indptr[at]).sum())
    kernel_ms = _time_ms(
        lambda: exclude_seen.exclude_seen_(scores, seen, users), reps=200)
    plain_ms = _time_ms(
        lambda: exclude_seen.exclude_seen_plain(scores, seen, users), reps=20)
    nbytes = nnz * (4 + scores.element_size()) + users.shape[0] * 3 * 4
    bound_ms, bound_by = _bound(nbytes, 0.0)
    return {"ms": kernel_ms, "plain_ms": plain_ms, "nnz": nnz,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "excluded": int(torch.isinf(want).sum())}


def serving(cli_files: dict, data, engine, device: str = "cuda") -> dict:
    """Phase 8: the recommend CLI on phase 3's files, then recommend_top_n
    over every user of phase 4's ml20m factors, seen items excluded, then
    exclude_seen.cu on the first batch. Returns the kernel's launches in
    the served run, its check and its times."""
    import numpy as np
    import torch

    from qmf_tpu_torch.cli import recommend as cli
    from qmf_tpu_torch.data import load_factors, read_dataset
    from qmf_tpu_torch.models.recommend import recommend_top_n
    from qmf_tpu_torch.ops import exclude_seen
    from qmf_tpu_torch.ops.bpr_ops import make_pos_set

    t0 = time.time()
    out_path = os.path.join(os.path.dirname(cli_files["user.dat"]),
                            "recs.txt")
    rc = cli.main([
        f"--user_factors={cli_files['user.dat']}",
        f"--item_factors={cli_files['item.dat']}",
        f"--exclude_seen={cli_files['train.txt']}",
        f"--topn={SERVE_N}", f"--output={out_path}", f"--device={device}",
    ])
    if rc != 0:
        raise AssertionError(f"recommend CLI returned {rc}")
    recs = _parse_recommendations(out_path)
    ratings = read_dataset(cli_files["train.txt"])
    seen_pairs = set(zip(ratings.user_ids.tolist(),
                         ratings.item_ids.tolist()))
    file_users = load_factors(cli_files["user.dat"])[0]
    if sorted(recs) != sorted(int(u) for u in file_users):
        raise AssertionError("recommend CLI: users in the output differ "
                             "from the factor file's")
    for user, pairs in recs.items():
        if len(pairs) != SERVE_N:
            raise AssertionError(f"user {user}: {len(pairs)} items listed")
        if any((user, item) in seen_pairs for item, _ in pairs):
            raise AssertionError(f"user {user}: a seen item was listed")
        if any(b > a for (_, a), (_, b) in zip(pairs, pairs[1:])):
            raise AssertionError(f"user {user}: scores do not descend")

    # ml20m: every user of phase 4's engine, seen = its training ratings
    train, _ = data
    rows = engine.user_index.lookup(train.user_ids)
    cols = engine.item_index.lookup(train.item_ids)
    uf, itf = engine.user_factors, engine.item_factors
    t1 = time.time()
    seen = make_pos_set(rows, cols, engine.nusers, device=device)
    t_seen = time.time() - t1
    users = np.arange(engine.nusers, dtype=np.int32)

    def serve_all():
        parts = [recommend_top_n(uf, itf, users[s:s + SERVE_BATCH],
                                 n=SERVE_N, seen=seen, device=device)
                 for s in range(0, len(users), SERVE_BATCH)]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    recommend_top_n(uf, itf, users[:SERVE_BATCH], n=SERVE_N, seen=seen,
                    device=device)  # warm up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # the engine, the factors, seen
    exclude_seen.launches = 0
    t1 = time.time()
    idx, scores = serve_all()
    t_serve = time.time() - t1
    peak = torch.cuda.max_memory_allocated()
    launches = exclude_seen.launches
    if launches != -(-engine.nusers // SERVE_BATCH):
        raise AssertionError(f"exclude_seen.cu launched {launches} times for "
                             f"{engine.nusers} users in batches of "
                             f"{SERVE_BATCH}")
    if idx.shape != (engine.nusers, SERVE_N) or scores.shape != idx.shape:
        raise AssertionError(f"served shapes {idx.shape}, {scores.shape}")
    if scores.dtype != np.float32 or not np.isfinite(scores).all():
        raise AssertionError("served scores are not finite float32")

    # a sample of users against a float64 ranking on the host
    sample = np.random.default_rng(SEED).choice(engine.nusers, SERVE_SAMPLE,
                                                replace=False)
    uf64 = uf[torch.as_tensor(sample, device=uf.device)].double().cpu().numpy()
    ref = uf64 @ itf.double().cpu().numpy().T
    indptr, items = seen.indptr.cpu().numpy(), seen.items.cpu().numpy()
    compared, worst = 0, 0.0
    for row, user in enumerate(sample):
        mine = items[indptr[user]:indptr[user + 1]]
        ref[row, mine] = -np.inf
        if np.isin(idx[user], mine).any():
            raise AssertionError(f"user {user}: a seen item was served")
        order = np.lexsort((np.arange(ref.shape[1]), -ref[row]))
        head = ref[row, order[:SERVE_N + 1]]
        worst = max(worst, float(np.abs(scores[user]
                                        - head[:SERVE_N]).max()))
        if np.all(head[:-1] - head[1:] > SERVE_GAP):
            if not np.array_equal(idx[user], order[:SERVE_N]):
                raise AssertionError(
                    f"user {user}: served {idx[user].tolist()}, float64 "
                    f"ranking {order[:SERVE_N].tolist()}")
            compared += 1
    if not worst <= SERVE_TOL:
        raise AssertionError(f"served scores differ from float64 by {worst}")
    if compared < SERVE_SAMPLE // 4:
        raise AssertionError(f"only {compared} of {SERVE_SAMPLE} sampled "
                             f"users have gaps above {SERVE_GAP}")
    kernel = _exclude_seen_timed(uf, itf, seen, users[:SERVE_BATCH])
    torch.cuda.empty_cache()
    _line("8 serving", t0, cli_preset="ml100k", cli_users=len(recs),
          topn=SERVE_N, users=engine.nusers, items=engine.nitems, k=K_MAIN,
          batch_users=SERVE_BATCH, seen_ratings=int(items.shape[0]),
          max_degree=seen.max_degree, pos_set_s=round(t_seen, 3),
          serve_s=round(t_serve, 4),
          users_per_s=round(engine.nusers / t_serve, 1), peak_bytes=peak,
          resident_before_bytes=resident,
          sampled_users=SERVE_SAMPLE, lists_compared=compared,
          max_abs_score_err_vs_f64=worst, exclude_seen_launches=launches,
          exclude_seen_batch_nnz=kernel["nnz"],
          exclude_seen_excluded=kernel["excluded"],
          exclude_seen_ms=round(kernel["ms"], 5),
          exclude_seen_plain_ms=round(kernel["plain_ms"], 5),
          exclude_seen_bound_ms=round(kernel["bound_ms"], 5))
    return dict(kernel, launches=launches)


def _bpr_positives(n_rows: int, n_users: int, n_items: int, seed: int,
                   zipf: bool):
    """Seeded (user, item) pairs; with ``zipf`` the items are heavy-headed,
    so that presampled candidates collide with positives often."""
    import numpy as np

    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, n_rows).astype(np.int32)
    if zipf:
        i = np.minimum(rng.zipf(1.3, n_rows) - 1, n_items - 1)
    else:
        i = rng.integers(0, n_items, n_rows)
    return u, i.astype(np.int32)


def _bpr_structures(u, i, n_users, n_items, bloom_bits, device):
    from qmf_tpu_torch.ops import bpr_ops

    return {
        "bitmap": bpr_ops.make_pos_bitmap(u, i, n_users, n_items,
                                          device=device),
        "bloom": bpr_ops.make_pos_bloom(u, i, n_users, bloom_bits,
                                        device=device),
        "set": bpr_ops.make_pos_set(u, i, n_users, device=device),
    }


def bpr_check(device: str = "cuda") -> None:
    """Phases 9a and 9b: the BPR ops on the card against the same calls on
    CPU tensors, on keys drawn once from a seeded CPU generator."""
    import numpy as np
    import torch

    from qmf_tpu_torch.ops import bpr_ops

    t0 = time.time()
    gen = torch.Generator().manual_seed(SEED)
    n_rounds = 4

    def same(name, fn):
        """fn(device) on the card and on the CPU: equal integer tensors."""
        got, want = fn(device), fn("cpu")
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if g.dtype != w.dtype or not torch.equal(g.cpu(), w):
                raise AssertionError(f"{name}: the card and the CPU differ")

    # (a) the hashes: keys 0 and 2^30 - 1 beside drawn ones, slots up to
    # 2^31 - 1; then one presample + pack of 2^20 rows per membership
    rk, ks6 = bpr_ops.draw_grouped_keys(gen, n_rounds, True)
    rk[1, 0], rk[2, 1], rk[3, 2] = 0, (1 << 30) - 1, 0
    ks3 = bpr_ops._draw_keys(gen, (3,))
    slots = torch.cat([
        torch.tensor([0, 1, 2**31 - 1], dtype=torch.int32),
        torch.randint(0, 2**31 - 1, (BPR_PACK_ROWS,), generator=gen,
                      dtype=torch.int32)])
    n_users, n_items = 50_000, 26_744  # ml20m's items: a tail word
    for r in range(n_rounds):
        same(f"_mix32 round {r}",
             lambda d: bpr_ops._mix32(rk[r].to(d), slots.to(d)))
        for n in (1, 2, n_items, 2**31 - 1):
            same(f"_cand_hash n_items={n}",
                 lambda d: bpr_ops._cand_hash(rk[r].to(d), slots.to(d), n))
    same("_word_probe", lambda d: bpr_ops._word_probe(
        rk[0].to(d), slots.to(d), (n_items + 31) // 32))
    same("_feistel_bijection", lambda d: bpr_ops._feistel_bijection(
        ks6.to(d), 37, 15))
    same("_mix_bijection", lambda d: bpr_ops._mix_bijection(
        ks3.to(d), 1 << 20, 20))
    u, i = _bpr_positives(BPR_PACK_ROWS, n_users, n_items, SEED, zipf=True)
    pos_up = torch.from_numpy(np.stack([u, i], axis=1))
    st = {d: _bpr_structures(u, i, n_users, n_items, 256, d)
          for d in (device, "cpu")}
    later_rounds = {}
    for membership in ("word", "bitmap", "bloom"):
        def pack(d, membership=membership):
            words = st[d]["bloom" if membership == "bloom" else "bitmap"]
            return bpr_ops._sample_pack_grouped_body(
                rk.to(d), ks6.to(d), pos_up.to(d), words.words,
                n_items=n_items, n_real=BPR_PACK_ROWS - 1000,
                num_neg=BPR_NEG, n_rounds=n_rounds,
                wpu=words.words_per_user, u_shift=1 + 2 * BPR_NEG,
                feistel_b=BPR_BATCH.bit_length() - 1,
                collide_cap=BPR_PACK_ROWS,
                membership=membership, indptr=st[d]["set"].indptr,
                csr_items=st[d]["set"].items,
                max_degree=st[d]["set"].max_degree)
        same(f"_sample_pack_grouped_body {membership}", pack)
        enc = pack(device)[0]
        later_rounds[membership] = int((((enc >> 1) & 3) != 0).sum())
        if not later_rounds[membership]:
            raise AssertionError(f"{membership}: no slot left round 0")
    del st, pos_up
    _line("9a bpr hashes", t0, rows=BPR_PACK_ROWS, users=n_users,
          items=n_items, slots_hashed=slots.numel(),
          memberships="word,bitmap,bloom", equal="bit for bit",
          slot0_past_round0=later_rounds)

    # (b) three grouped epochs in float64, the card against the CPU. Items
    # are uniform: a head item that fills a third of a batch makes the
    # summed bias pull (lr * rows * num_neg * bias_lambda > 2) overshoot,
    # and the iteration then amplifies the rounding it is compared to.
    t0 = time.time()
    n_users, n_items, n_pos, bs, k = 300, 500, 1 << 13, 256, 8
    u, i = _bpr_positives(n_pos, n_users, n_items, SEED + 1, zipf=False)
    pos_up = torch.from_numpy(np.stack([u, i], axis=1))
    rng = np.random.default_rng(SEED)
    init = [rng.normal(0, 0.1, s) for s in ((n_users, k), (n_items, k),
                                            (n_items,))]
    st = {d: _bpr_structures(u, i, n_users, n_items, 256, d)
          for d in (device, "cpu")}
    keys = [bpr_ops.draw_grouped_keys(gen, n_rounds, True) for _ in range(3)]
    worst = {}
    for scatter, sampler, member in (("seq", "word", "bitmap"),
                                     ("merged", "rounds", "bitmap"),
                                     ("dense", "word", "bitmap"),
                                     ("seq", "rounds", "bloom")):
        out = {}
        for d in (device, "cpu"):
            params = bpr_ops.BPRParams(*(
                torch.tensor(a, dtype=torch.float64, device=d) for a in init))
            for rk_e, ks_e in keys:
                params, over = bpr_ops.sgd_epoch_grouped_keyed(
                    params, rk_e.to(d), ks_e.to(d), pos_up.to(d),
                    st[d][member], 0.05, 0.025, 0.0025, 1.0, n_items=n_items,
                    n_real=n_pos - 100, use_biases=True, num_neg=BPR_NEG,
                    neg_rounds=n_rounds, batch_size=bs, collide_cap=n_pos,
                    pos_set=st[d]["set"] if member == "bloom" else None,
                    item_scatter=scatter, sampler=sampler)
            out[d] = ([t.cpu() for t in params], int(over))
        err = max(float((a - b).abs().max())
                  for a, b in zip(out[device][0], out["cpu"][0]))
        moved = float((out["cpu"][0][0]
                       - torch.as_tensor(init[0])).abs().max())
        if not err <= BPR_F64_TOL or out[device][1] != out["cpu"][1]:
            raise AssertionError(
                f"grouped epochs {scatter}/{sampler}/{member}: the card and "
                f"the CPU differ by {err} (bound {BPR_F64_TOL}), overflow "
                f"{out[device][1]} vs {out['cpu'][1]}")
        if not moved > 1e-3:
            raise AssertionError(f"{scatter}: the epochs moved nothing")
        worst[f"{scatter}/{sampler}/{member}"] = err
    _line("9b bpr epochs f64", t0, positives=n_pos, users=n_users,
          items=n_items, k=k, batch=bs, epochs=3, tol=BPR_F64_TOL,
          max_abs_diff_card_vs_cpu=worst)


class _EpochLog:
    """Collects the (epoch, train loss, test loss) the engines log."""

    def __init__(self):
        import logging
        import re

        outer = self
        self.rows = []
        pattern = re.compile(
            r"epoch (\d+): train loss = (\S+), test loss = (\S+) ")

        class Handler(logging.Handler):
            def emit(self, record):
                m = pattern.match(record.getMessage())
                if m:
                    outer.rows.append((int(m[1]), float(m[2]), float(m[3])))

        self.handler = Handler()
        self.logger = logging.getLogger("qmf_tpu_torch")

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def bpr_cli(cli_files: dict, device: str = "cuda") -> None:
    """Phase 9c: the bpr CLI with its defaults on phase 3's ml100k files,
    then the recommend CLI on the factor files it wrote."""
    import numpy as np

    from qmf_tpu_torch.cli import bpr as cli
    from qmf_tpu_torch.cli import recommend as recommend_cli
    from qmf_tpu_torch.data import read_dataset

    t0 = time.time()
    tmp = os.path.dirname(cli_files["user.dat"])
    paths = {n: os.path.join(tmp, "bpr_" + n) for n in
             ("user.dat", "item.dat", "recs.txt")}
    with _EpochLog() as epochs:
        rc = cli.main([
            f"--train_dataset={cli_files['train.txt']}",
            f"--test_dataset={cli_files['test.txt']}",
            f"--user_factors={paths['user.dat']}",
            f"--item_factors={paths['item.dat']}",
            f"--device={device}",
        ])
    if rc != 0:
        raise AssertionError(f"bpr CLI returned {rc}")
    losses = [tr for _, tr, _ in epochs.rows]
    if len(losses) != 10 or not np.isfinite(losses).all():
        raise AssertionError(f"bpr CLI logged losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"bpr CLI train loss did not fall: {losses}")
    test = read_dataset(cli_files["test.txt"])
    auc, u_file, _, _ = _auc_of_files(paths["user.dat"], paths["item.dat"],
                                      test, device)
    if not auc > 0.5:
        raise AssertionError(f"bpr CLI test AUC {auc} <= 0.5")
    rc = recommend_cli.main([
        f"--user_factors={paths['user.dat']}",
        f"--item_factors={paths['item.dat']}",
        f"--exclude_seen={cli_files['train.txt']}",
        f"--topn={SERVE_N}", f"--output={paths['recs.txt']}",
        f"--device={device}",
    ])
    if rc != 0:
        raise AssertionError(f"recommend CLI on BPR factors returned {rc}")
    recs = _parse_recommendations(paths["recs.txt"])
    if len(recs) != u_file.shape[0] or any(
            len(v) != SERVE_N for v in recs.values()):
        raise AssertionError("recommend CLI on BPR factors: wrong lists")
    _line("9c bpr cli", t0, preset="ml100k", users=u_file.shape[0],
          k=u_file.shape[1], epochs=len(losses),
          train_losses=[f"{x:.6g}" for x in (losses[0], losses[-1])],
          test_losses=[f"{x:.6g}" for x in (epochs.rows[0][2],
                                            epochs.rows[-1][2])],
          test_auc=auc, recommend_users=len(recs))


def _check_stream(engine, rk, ks, device: str) -> dict:
    """Rebuild the packed stream of the epoch that drew (rk, ks), decode it
    as the SGD loop does, and check every real row: a negative chosen
    before the last round is an item below n_items and no positive of its
    user. Returns counts."""
    import torch

    from qmf_tpu_torch.ops import bpr_ops

    cfg = engine.config
    num_neg, n_rounds = cfg.num_negative_samples, cfg.neg_resample_rounds
    bitmap = engine._pos_bitmap
    u_shift = 1 + 2 * num_neg
    enc, _, _ = bpr_ops._sample_pack_grouped_body(
        rk, ks, engine._grp_up, bitmap.words, n_items=engine.nitems,
        n_real=engine._n_real_pos, num_neg=num_neg, n_rounds=n_rounds,
        wpu=bitmap.words_per_user, u_shift=u_shift,
        feistel_b=engine._grp_batch.bit_length() - 1,
        collide_cap=engine._collide_cap, membership="word")
    tables = bpr_ops._slot_tables(num_neg, n_rounds, True, device)
    real = early = early_bad = last = last_pos = 0
    chunk = 1 << 22
    for s in range(0, enc.shape[0], chunk):
        ue = enc[s:s + chunk]
        row_idx = torch.arange(s, s + ue.shape[0], dtype=torch.int32,
                               device=device)
        negs, rounds = bpr_ops._decode_negatives(
            ue, row_idx, rk, tables, engine.nitems, n_rounds, True,
            bitmap.words_per_user)
        valid = ((ue & 1) == 1)[:, None]
        users = bpr_ops._shift_right_logical(ue, u_shift)[:, None].expand(
            -1, num_neg)
        in_range = negs < engine.nitems
        member = bpr_ops._is_member_bitmap(
            bitmap, users, torch.where(in_range, negs, 0))
        is_early = valid & (rounds < n_rounds - 1)
        is_last = valid & (rounds == n_rounds - 1)
        real += int(valid.sum())
        early += int(is_early.sum())
        early_bad += int((is_early & (member | ~in_range)).sum())
        last += int(is_last.sum())
        last_pos += int((is_last & member).sum())
    if real != engine._n_real_pos:
        raise AssertionError(f"stream holds {real} real rows, expected "
                             f"{engine._n_real_pos}")
    if early_bad:
        raise AssertionError(f"{early_bad} negatives chosen before the last "
                             "round are positives of their user")
    return {"slots": real * num_neg, "chosen_early": early,
            "chosen_early_positive": early_bad, "last_round": last,
            "last_round_positive": last_pos}


def bpr_scale(data, device: str = "cuda") -> dict:
    """Phase 9d: BPREngine at ml20m scale with bench.py's BPR
    configuration, through init, init_test and optimize."""
    import statistics

    import numpy as np
    import torch

    from qmf_tpu_torch import BPRConfig, MetricsConfig
    from qmf_tpu_torch.metrics import MetricsEngine
    from qmf_tpu_torch.models import BPREngine

    t0 = time.time()
    train, test = data
    me = MetricsEngine(MetricsConfig(num_test_users=3000, seed=SEED))
    me.add_test_avg_metric("auc")
    cfg = BPRConfig(nepochs=BPR_WARM + BPR_TIMED, nfactors=BPR_K,
                    num_negative_samples=BPR_NEG, batch_size=BPR_BATCH,
                    init_seed=0)
    engine = BPREngine(cfg, me, device=device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t1 = time.time()
    engine.init(train)
    t_init = time.time() - t1
    t1 = time.time()
    engine.init_test(test)
    torch.cuda.synchronize()
    t_init_test = time.time() - t1
    if not (engine._grouped and engine._pos_bitmap is not None
            and cfg.neg_sampler == "word"):
        raise AssertionError("ml20m did not take the grouped word path")
    # phase 13 trains again from here
    start = [t.clone() for t in engine.params]
    gen_state = engine._generator.get_state()
    epochs, drawn = [], []
    engine.progress_cb = lambda *row: epochs.append(row)
    draw = engine._draw_grouped_keys

    def recording_draw():
        drawn.append(draw())
        return drawn[-1]

    engine._draw_grouped_keys = recording_draw
    engine.optimize()
    engine._draw_grouped_keys = draw
    peak = torch.cuda.max_memory_allocated()
    train_losses = [tr for _, tr, _, _ in epochs]
    test_losses = [te for _, _, te, _ in epochs]
    timed = [dt for _, _, _, dt in epochs[BPR_WARM:]]
    if len(epochs) != cfg.nepochs or not np.isfinite(
            train_losses + test_losses).all():
        raise AssertionError(f"losses {train_losses} {test_losses}")
    if any(b >= a for a, b in zip(train_losses, train_losses[1:])):
        raise AssertionError(f"train loss did not fall: {train_losses}")
    _, auc = me.last("test_avg_auc")
    if not auc > 0.5:
        raise AssertionError(f"BPR test AUC {auc} <= 0.5")
    if not all(torch.isfinite(t).all() for t in engine.params):
        raise AssertionError("non-finite BPR parameters")
    stream = _check_stream(engine, *drawn[-1], device)
    epoch_s = statistics.median(timed)
    steps = engine._grp_up.shape[0] // engine._grp_batch
    _line("9d bpr ml20m", t0, users=engine.nusers, items=engine.nitems,
          positives=engine._n_real_pos, k=BPR_K, negatives=BPR_NEG,
          batch=BPR_BATCH, steps_per_epoch=steps, dtype=cfg.dtype,
          init_s=round(t_init, 3), init_stages=engine._init_stages,
          init_test_s=round(t_init_test, 3),
          warmup_epoch_s=[round(dt, 4) for _, _, _, dt in epochs[:BPR_WARM]],
          epoch_s=[round(dt, 4) for dt in timed],
          median_epoch_s=round(epoch_s, 4),
          real_triplets=engine._n_real_triplets,
          bpr_triplet_updates_per_s=round(
              engine._n_real_triplets / epoch_s, 1),
          train_losses=[f"{x:.6g}" for x in train_losses],
          test_losses=[f"{x:.6g}" for x in test_losses], test_auc=auc,
          overflow_slots=engine.overflow_slots, collide_cap=engine._collide_cap,
          bitmap_bytes=engine._pos_bitmap.words.numel() * 4,
          peak_bytes=peak, resident_before_bytes=before,
          stream_check=stream)
    return {"engine": engine, "epoch_s": epoch_s, "timed_s": timed,
            "real_triplets": engine._n_real_triplets,
            "updates_per_s": engine._n_real_triplets / epoch_s, "auc": auc,
            "start": start, "gen_state": gen_state}


def profile_bpr_epoch(engine, epoch_s: float,
                      phase: str = "9p bpr profile") -> None:
    """Phase 9p: one more epoch of phase 9d's engine under torch.profiler,
    after one unprofiled epoch timed the same way: wall ms beside device
    ms, launches, the largest kernels by device time and the host's ops by
    their own CPU time (phase 10c: of its sharded engine)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.time()

    def epoch():
        t1 = time.time()
        engine._epoch()
        torch.cuda.synchronize()
        return 1e3 * (time.time() - t1)

    wall_ms = epoch()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_wall_ms = epoch()

    def self_ms(e):
        return e.self_device_time_total / 1e3

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and self_ms(e) > 0]
    events.sort(key=self_ms, reverse=True)
    if not events:
        raise AssertionError("the profile shows no device time")
    device_ms = sum(self_ms(e) for e in events)
    launches = sum(e.count for e in events)
    top = ", ".join(f"{e.key[:60]!r}:{self_ms(e):.3f}ms/{e.count}"
                    for e in events[:8])
    # the host's side: ops by their own CPU time (profiled, so inflated)
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    host_top = ", ".join(
        f"{e.key[:40]!r}:{e.self_cpu_time_total / 1e3:.3f}ms/{e.count}"
        for e in host[:8])
    _line(phase, t0, epoch="grouped word, ml20m",
          wall_ms=round(wall_ms, 3),
          optimize_median_epoch_ms=round(1e3 * epoch_s, 3),
          profiled_wall_ms=round(profiled_wall_ms, 3),
          device_ms=round(device_ms, 3), launches=launches,
          device_share_of_wall=round(device_ms / wall_ms, 4),
          paced_by="host" if device_ms < 0.8 * wall_ms else "device",
          top=f"[{top}]", host_top=f"[{host_top}]")


def _sharded_wals_w1(mesh, train, want: list, **kw) -> dict:
    """One 3-epoch ShardedWALSEngine run on ``mesh`` against a single-device
    run from the same init (``want``: its recorder rows): every epoch's
    loss and the final factors."""
    import torch

    from qmf_tpu_torch import WALSConfig
    from qmf_tpu_torch.ops import build_solve, spd_solve
    from qmf_tpu_torch.parallel import ShardedWALSEngine

    # phase 4's configuration (phase 6's with kw)
    cfg = WALSConfig(nfactors=K_MAIN, matmul_precision="default",
                     batch_rows=8192, nepochs=3, **kw)
    engine = ShardedWALSEngine(cfg, mesh=mesh)
    t1 = time.time()
    engine.init(train)
    torch.cuda.synchronize()
    t_init = time.time() - t1
    epochs = []
    engine.progress_cb = _recorder(engine, epochs)
    spd_solve.launches = build_solve.launches = build_solve.launches_hot = 0
    mesh.reset_counts()
    engine.optimize()
    launches = {"chol_solve": spd_solve.launches,
                "build_solve": build_solve.launches,
                "build_solve_hot": build_solve.launches_hot}
    moved = dict(mesh.counts)
    half = _half_epoch_ms({"mesh": (engine, engine._solver, engine.mesh),
                           "no_mesh": (engine, engine._solver, None)})
    u_want, v_want = want[-1][3]
    u_got = engine.user_factors[: engine.nusers].cpu()
    v_got = engine.item_factors[: engine.nitems].cpu()
    bitwise = (torch.equal(u_got, u_want) and torch.equal(v_got, v_want)
               and [e[1] for e in epochs] == [e[1] for e in want])
    err = max(_normwise_err(u_got, u_want)[1],
              _normwise_err(v_got, v_want)[1])
    if not err <= 5 * F32_TOL:
        raise AssertionError(f"world-1 sharded WALS {kw} vs single device: "
                             f"normwise factor error {err}")
    return {"init_s": round(t_init, 3), "pack": engine._pack_kind,
            "init_stages": _stages(engine),
            "epoch_program": _program_kind(engine),
            "epoch_s": [round(e[2], 4) for e in epochs],
            "single_epoch_s": [round(e[2], 4) for e in want],
            "losses": [f"{e[1]:.10g}" for e in epochs],
            "bitwise_equal_to_single": bitwise, "normwise_err": err,
            "launches": launches,
            "collective_bytes_per_half_epoch":
                moved["all_gather_bytes"] // 4,
            "all_reduce_bytes_per_half_epoch":
                moved["all_reduce_bytes"] // 4,
            "collectives": moved["calls"],
            **{f"half_epoch_ms_{k}": round(v, 4) for k, v in half.items()}}


def _gloo_cuda_forms() -> dict:
    """Which collectives a gloo group runs on CUDA tensors, in a world of
    one: parallel/mesh.py hands gloo its CUDA tensors as they are."""
    import torch
    import torch.distributed as dist

    from qmf_tpu_torch.parallel import launch
    from qmf_tpu_torch.parallel.mesh import _all_gather_single as gather

    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:"
                            f"{launch.free_port()}", world_size=1, rank=0)
    forms = {}
    x = torch.ones(4, device="cuda")
    for name, call in (
            ("all_gather_single", lambda: gather(torch.empty_like(x), x)),
            ("all_gather_list", lambda: dist.all_gather([torch.empty_like(x)],
                                                        x)),
            ("all_reduce", lambda: dist.all_reduce(x.clone()))):
        try:
            call()
            torch.cuda.synchronize()
            forms[name] = "native"
        except Exception as exc:  # noqa: BLE001 - reported, not raised
            forms[name] = f"{type(exc).__name__}: {str(exc)[:80]}"
    dist.destroy_process_group()
    return forms


def sharded(data, split: dict, fused: dict, bpr: dict, cli_files: dict,
            device: str = "cuda") -> dict:
    """Phase 10: the sharded engines (qmf_tpu_torch/parallel).

    10a: ShardedWALSEngine over NCCL at world 1 on phase 4's data, split
    path and fused+hot, 3 epochs each, against phases 4 and 6. 10b: two gloo ranks sharing the card, reading files the parent
    wrote: WALS at ml20m (phase 4's configuration, 3 epochs, AUC and
    factors against phase 4's), WALS at phase 3's ml100k in float64 against
    the single-device engine within 1e-9, BPR at phase 9b's small size in
    float64, 3 epochs, within 1e-9. 10c: ShardedBPREngine over NCCL at world
    1 with phase 9d's configuration, a warm-up epoch and a timed one, then
    a profiled one. 10d:
    the wals CLI under torchrun's environment at world 1 (the sharded path),
    --solver=fused on phase 3's files. Returns the sharded launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from qmf_tpu_torch import BPRConfig, WALSConfig
    from qmf_tpu_torch.cli import wals as cli
    from qmf_tpu_torch.data import Dataset, read_dataset
    from qmf_tpu_torch.models import BPREngine, WALSEngine
    from qmf_tpu_torch.ops import build_solve, spd_solve
    from qmf_tpu_torch.parallel import ShardedBPREngine, launch, make_mesh
    from qmf_tpu_torch.parallel import multihost
    from qmf_tpu_torch.parallel.dryrun import (read_result, run_jobs,
                                               write_ratings_npz)

    train, test = data
    launches = dict.fromkeys(("chol_solve", "build_solve",
                              "build_solve_hot"), 0)
    # 10a and 10c: one NCCL group of one rank
    t0 = time.time()
    cuda = device == "cuda"
    multihost.initialize(f"127.0.0.1:{launch.free_port()}", 1, 0,
                         backend="nccl" if cuda else "gloo", device=device)
    try:
        mesh = make_mesh(device=device)
        runs = {"split": _sharded_wals_w1(mesh, train, split["epochs"]),
                "fused_hot": _sharded_wals_w1(
                    mesh, train, fused["epochs"], solver="fused",
                    hot_width=HOT_WIDTH)}
        for run in runs.values():
            for name, n in run["launches"].items():
                launches[name] += n
        if not (runs["split"]["launches"]["chol_solve"] > 0
                and runs["fused_hot"]["launches"]["build_solve_hot"] > 0):
            raise AssertionError(f"10a launched no kernel: {runs}")
        _line("10a sharded nccl w1", t0, world=1, backend=mesh.backend,
              **{f"{name}_{key}": value for name, run in runs.items()
                 for key, value in run.items()})
        torch.cuda.empty_cache()

        t0 = time.time()
        cfg = BPRConfig(nepochs=2, nfactors=BPR_K,
                        num_negative_samples=BPR_NEG, batch_size=BPR_BATCH,
                        init_seed=0)
        engine = ShardedBPREngine(cfg, mesh=mesh)
        engine.init(train)
        epochs = []
        engine.progress_cb = lambda *row: epochs.append(row)
        engine.optimize()
        epoch_s = epochs[-1][3]
        if not (engine._grouped and np.isfinite(
                [e[1] for e in epochs]).all()):
            raise AssertionError(f"10c: grouped {engine._grouped}, "
                                 f"losses {epochs}")
        rate = engine._n_real_triplets / epoch_s
        profile_bpr_epoch(engine, epoch_s, "10c sharded bpr profile")
        _line("10c sharded bpr nccl w1", t0, world=1, k=BPR_K,
              batch=BPR_BATCH, warmup_epoch_s=round(epochs[0][3], 4),
              epoch_s=round(epoch_s, 4),
              bpr_triplet_updates_per_s=round(rate, 1),
              single_device_updates_per_s=round(bpr["updates_per_s"], 1),
              train_losses=[f"{e[1]:.6g}" for e in epochs])
        t1 = time.time()
        _line("10c sharded bpr parts", t1,
              **sharded_bpr_parts(engine, mesh, epoch_s, bpr))
        del engine
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # 10b: two gloo ranks on the one card
    t0 = time.time()
    forms = _gloo_cuda_forms() if cuda else {}
    u, i = _bpr_positives(1 << 13, 300, 500, SEED + 1, zipf=False)
    small = Dataset(u, i, np.ones(len(u)))
    ml100k = read_dataset(cli_files["train.txt"])
    f64_wals = dict(dtype="float64", nepochs=3)
    f64_bpr = dict(nepochs=3, nfactors=8, batch_size=256,
                   num_negative_samples=BPR_NEG, dtype="float64")
    with tempfile.TemporaryDirectory(prefix="qmf_chip_smoke_") as tmp:
        path = {}
        for name, ds in (("ml20m", train), ("ml20m_test", test),
                         ("ml100k", ml100k), ("small", small)):
            path[name] = os.path.join(tmp, f"{name}.npz")
            write_ratings_npz(path[name], ds)
        jobs = [
            {"engine": "wals", "train": path["ml20m"],
             "test": path["ml20m_test"],
             "metrics": {"num_test_users": 3000, "seed": SEED},
             "config": dict(nfactors=K_MAIN, matmul_precision="default",
                            batch_rows=8192, nepochs=3),
             "out": os.path.join(tmp, "ml20m")},
            {"engine": "wals", "train": path["ml100k"], "config": f64_wals,
             "out": os.path.join(tmp, "ml100k")},
            {"engine": "bpr", "train": path["small"], "config": f64_bpr,
             "out": os.path.join(tmp, "small")},
        ]
        t1 = time.time()
        launch.spawn(run_jobs, 2, backend="gloo",
                     device=f"{device}:0" if cuda else device, args=(jobs,),
                     deadline_s=400)
        spawn_s = time.time() - t1
        res = {job["out"].rsplit(os.sep, 1)[-1]:
               [read_result(job["out"], r) for r in (0, 1)] for job in jobs}
    big = res["ml20m"]
    for r in (0, 1):
        if not np.array_equal(big[r]["item_factors"],
                              big[0]["item_factors"]):
            raise AssertionError("10b: the ranks' factors differ")
    # Two ranks build each row as one device does, but the build's batched
    # GEMMs see other batch counts, so cuBLAS may sum in another order; the
    # bf16 rounding of the next half-epoch's operands carries such last-bit
    # differences through the epochs. So the ranks are held to the spread
    # of two single-device builds of the same data in the same run (phase
    # 6's fused+hot against phase 4's split factors), and at least to
    # phase 4's bound on one solve.
    final = split["epochs"][-1][3]
    errs = [_normwise_err(torch.from_numpy(big[0][f"{side}_factors"]),
                          final[j])[1]
            for j, side in enumerate(("user", "item"))]
    gap = max(_normwise_err(fused["epochs"][-1][3][j], final[j])[1]
              for j in (0, 1))
    bound = max(5 * F32_TOL, 2 * gap)
    auc = float(big[0]["auc"])
    if not (max(errs) <= bound and abs(auc - split["auc"]) <= 2e-3):
        raise AssertionError(f"10b ml20m: normwise errors {errs} (bound "
                             f"{bound}), AUC {auc} vs {split['auc']}")
    single = WALSEngine(WALSConfig(**f64_wals), device=device)
    single.init(ml100k)
    single.optimize()
    bpr_single = BPREngine(BPRConfig(**f64_bpr), device=device)
    bpr_single.init(small)
    bpr_single.optimize()
    diffs = {}
    for name, want in (("ml100k", (single.user_factors, single.item_factors)),
                       ("small", bpr_single.params)):
        got = res[name][0]
        diffs[name] = max(float(np.abs(got[key] - w.cpu().numpy()).max())
                          for key, w in zip(("user_factors", "item_factors",
                                             "item_biases"), want))
    if not max(diffs.values()) <= 1e-9:
        raise AssertionError(f"10b float64: {diffs} beyond 1e-9")
    per_rank = [{k: int(res["ml20m"][r][f"{k}_launches"])
                 for k in ("chol_solve", "build_solve", "build_solve_hot")}
                for r in (0, 1)]
    for rank in per_rank:
        for name, n in rank.items():
            launches[name] += n
    if not all(rank["chol_solve"] > 0 for rank in per_rank):
        raise AssertionError(f"10b launched no chol_solve: {per_rank}")
    _line("10b sharded gloo w2", t0, world=2, backend="gloo",
          device=f"{device}:0", gloo_cuda_forms=forms,
          spawn_s=round(spawn_s, 3),
          ml20m_epoch_s=[[round(float(x), 4) for x in big[r]["epoch_s"]]
                         for r in (0, 1)],
          ml20m_single_epoch_s=[round(e[2], 4) for e in split["epochs"]],
          ml20m_launches=per_rank, ml20m_test_auc=auc,
          single_test_auc=split["auc"], ml20m_normwise_err=max(errs),
          ml20m_bitwise_equal=max(errs) == 0.0,
          fused_vs_split_normwise=gap, ml20m_bound=bound,
          ml20m_losses=[f"{float(x):.10g}" for x in big[0]["losses"]],
          collective_bytes_per_half_epoch=int(
              big[0]["collective_all_gather_bytes"]) // 6,
          f64_max_abs_diff=diffs, bpr_grouped=bool(res["small"][0]["grouped"]))

    # 10d: the CLI under torchrun's environment, one rank
    t0 = time.time()
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(launch.free_port()),
           "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}
    os.environ.update(env)
    build_solve.launches = build_solve.launches_hot = spd_solve.launches = 0
    with tempfile.TemporaryDirectory(prefix="qmf_chip_smoke_") as tmp:
        out = {n: os.path.join(tmp, n) for n in ("user.dat", "item.dat")}
        try:
            rc = cli.main([f"--train_dataset={cli_files['train.txt']}",
                           "--solver=fused", "--n_devices=1",
                           f"--device={device}",
                           f"--user_factors={out['user.dat']}",
                           f"--item_factors={out['item.dat']}"])
        finally:
            for key in env:
                os.environ.pop(key)
        cli_auc, *_ = _auc_of_files(out["user.dat"], out["item.dat"],
                                    read_dataset(cli_files["test.txt"]),
                                    device)
    # phase 3's files are phase 6's CLI data: the same widths and chunks
    n_cli = {"build_solve": build_solve.launches,
             "build_solve_hot": build_solve.launches_hot}
    expect = {k: n * WALSConfig().nepochs
              for k, n in fused["cli_expect"].items() if k in n_cli}
    for name, n in n_cli.items():
        launches[name] += n
    if rc != 0 or n_cli != expect or not sum(n_cli.values()) > 0 \
            or abs(cli_auc - fused["cli_auc"]) > 2e-3:
        raise AssertionError(f"10d: rc {rc}, launches {n_cli}, expected "
                             f"{expect}, AUC {cli_auc} vs "
                             f"{fused['cli_auc']}")
    _line("10d cli torchrun w1", t0, solver="fused", launches=n_cli,
          test_auc=cli_auc, single_device_test_auc=fused["cli_auc"])
    return launches


# Phase 11: a poll's step (s), a task's deadline (s), the fault drill's
# epoch stretch (s), and phase 4's sampled test users.
CP_POLL_S, CP_TASK_S, CP_SLEEP_S, CP_TEST_USERS = 0.5, 400.0, 1.5, 3000


def _write_ratings(path: str, dataset) -> float:
    """tools.datagen.write_ratings_parallel of ``dataset`` into ``path``;
    returns the seconds."""
    from qmf_tpu_torch.tools.datagen import write_ratings_parallel

    t0 = time.time()
    write_ratings_parallel(path, dataset.user_ids, dataset.item_ids,
                           dataset.values)
    return time.time() - t0


class _ControlPlane:
    """The three CLIs of the control plane as subprocesses, as the
    reference's workflow runs them: one wals_scheduler on a free port,
    wals_labor agents, wals_submit for tasks and --status. Each daemon runs
    in a session of its own, so :meth:`close` stops it with every worker
    it started."""

    def __init__(self, tmp: str, *flags: str):
        from qmf_tpu_torch.parallel import launch

        self.tmp, self.port = tmp, launch.free_port()
        # (process, log file) of the running daemons, and of those stopped
        self.procs, self.stopped, self.tasks = [], [], {}
        root = os.path.dirname(os.path.abspath(__file__))
        # INFO: the taskid submit was given, and a labor's worker result,
        # are read from the logs
        self.env = dict(os.environ, QMF_TPU_LOGLEVEL="INFO",
                        PYTHONPATH=os.pathsep.join(
                            p for p in (root, os.environ.get("PYTHONPATH"))
                            if p))
        self.root = root
        self._start("wals_scheduler", "--scheduler_ip=127.0.0.1",
                    f"--scheduler_port={self.port}", *flags)
        self._wait(lambda: self.status() is not None, 60, "scheduler up")

    def _start(self, cli: str, *args: str, env=None):
        n = len(self.procs) + len(self.stopped)
        log_path = os.path.join(self.tmp, f"{cli}{n}.log")
        with open(log_path, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", f"qmf_tpu_torch.cli.{cli}", *args],
                cwd=self.root, env={**self.env, **(env or {})}, stdout=out,
                stderr=subprocess.STDOUT, start_new_session=True)
        self.procs.append((proc, log_path))
        return log_path

    def _run(self, *args: str) -> subprocess.CompletedProcess:
        return subprocess.run(
            [sys.executable, "-m", "qmf_tpu_torch.cli.wals_submit", *args],
            cwd=self.root, env=self.env, capture_output=True, text=True,
            timeout=60)

    def status(self):
        """The scheduler's status_rsp (wals_submit --status), or None."""
        out = self._run("--status", "127.0.0.1", str(self.port))
        return json.loads(out.stdout) if out.returncode == 0 else None

    def _wait(self, cond, deadline: float, what: str):
        end = time.time() + deadline
        while time.time() < end:
            got = cond()
            if got:
                return got
            for proc, log_path in self.procs:
                if proc.poll() is not None:
                    raise AssertionError(f"{log_path} exited "
                                         f"{proc.returncode}: {self.tail()}")
            time.sleep(CP_POLL_S)
        raise AssertionError(f"phase 11: no {what} within {deadline} s: "
                             f"{self.tail()}")

    def labor(self, env=None) -> str:
        """Start a wals_labor and return the peer name the scheduler gives
        it (a labor that attached before it is stopped first)."""
        before = set(self.status()["labors"])
        log_path = self._start(
            "wals_labor", "--scheduler_ip=127.0.0.1",
            f"--scheduler_port={self.port}", "--reconnect_backoff=1",
            env=env)
        peers = self._wait(
            lambda: set(self.status()["labors"]) - before, 60, "labor")
        self.labor_log = log_path
        return peers.pop()

    def stop_labors(self) -> None:
        for proc, log_path in list(self.procs):
            if "wals_labor" in log_path:
                os.killpg(proc.pid, 15)
                proc.wait(30)
                self.procs.remove((proc, log_path))
                self.stopped.append((proc, log_path))
        self._wait(lambda: not self.status()["labors"], 60, "labors gone")

    def submit(self, name: str, **fields) -> int:
        """Write a task file with ``fields`` and submit it; its taskid."""
        path = os.path.join(self.tmp, f"{name}.pb")
        with open(path, "w") as f:
            for key, value in fields.items():
                f.write(f'{key} : "{value}"\n' if isinstance(value, str)
                        else f"{key} : {value}\n")
        out = self._run("127.0.0.1", str(self.port), path)
        if out.returncode != 0:
            raise AssertionError(f"wals_submit returned {out.returncode}: "
                                 f"{out.stderr[-2000:]}")
        taskid = int(out.stderr.rsplit("taskid=", 1)[1].split()[0])
        self.tasks[taskid] = path
        return taskid

    def ckpt_dir(self, taskid: int) -> str:
        """The checkpoint directory the workers of a task write."""
        from qmf_tpu_torch.distributed.taskdef import load_taskdef
        from qmf_tpu_torch.distributed.worker import default_ckpt_dir

        return default_ckpt_dir(load_taskdef(self.tasks[taskid]), taskid)

    def finished(self, taskid: int, deadline: float = CP_TASK_S) -> dict:
        """The history entry of a task once it is done, or raise."""

        def done():
            hist = [h for h in self.status()["history"]
                    if h["taskid"] == taskid]
            return hist[0] if hist else None

        entry = self._wait(done, deadline, f"end of task {taskid}")
        if entry["state"] != "done":
            raise AssertionError(f"task {taskid}: {entry} {self.tail()}")
        return entry

    def labor_result(self, taskid: int) -> dict:
        """Rank 1's result, from the labor's log line."""
        mark = f"task {taskid}: worker result "

        def line():
            with open(self.labor_log) as f:
                hits = [ln for ln in f if mark in ln]
            return hits[-1] if hits else None

        return json.loads(self._wait(line, 60, "labor result")
                          .split(mark, 1)[1])

    def tail(self) -> str:
        out = []
        for _, log_path in self.procs + self.stopped:
            with open(log_path) as f:
                out.append(f"--- {os.path.basename(log_path)}\n"
                           + f.read()[-3000:])
        return "\n".join(out)

    def close(self) -> None:
        procs = [proc for proc, _ in self.procs + self.stopped]
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, 15)
        for proc in procs:
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                pass
            try:
                os.killpg(proc.pid, 9)  # the session's workers too
            except ProcessLookupError:
                pass
            proc.wait(30)


def _worker_pid(process_id: int) -> int:
    """The pid of the running worker of rank ``process_id``, from the
    process table."""
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if b"qmf_tpu_torch.distributed.worker" in argv and \
                b"--process-id" in argv and argv[argv.index(
                    b"--process-id") + 1] == str(process_id).encode():
            return int(pid)
    return 0


def _factor_files_err(got: tuple, want: tuple) -> tuple:
    """(files byte for byte equal, normwise error) of two (user, item)
    factor file pairs."""
    import torch

    from qmf_tpu_torch.data import load_factors

    same, err = True, 0.0
    for g, w in zip(got, want):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            same &= fg.read() == fw.read()
        (gids, gfd), (wids, wfd) = load_factors(g), load_factors(w)
        if list(gids) != list(wids):
            raise AssertionError(f"{g}: ids differ from {w}")
        err = max(err, _normwise_err(torch.from_numpy(gfd.factors),
                                     torch.from_numpy(wfd.factors))[1])
    return same, err


def control_plane(data, split: dict, fused: dict, cli_files: dict,
                  tmp: str, device: str = "cuda") -> dict:
    """Phase 11: the control plane (qmf_tpu_torch/distributed) through its
    three CLIs, with the kernels in its workers. 11a: phase 4's ml20m
    split as a ratings file, one task (k = 64, 3 epochs, solver auto) on
    a scheduler with no labor, against the wals CLI on the same files.
    11b: a scheduler and one labor as two gloo ranks on cuda:0, phase 3's
    ml100k files: float32 fused, float64 auto. 11c: 11b's float64 task
    again with the labor's worker killed mid-run. 11d: one epoch under
    utils.tracing.trace. Returns the launches of each kernel, and 11a's
    ratings file, which phase 18 reads and removes. With
    ``device="cpu"`` every rank runs on the host (n_local_devices=1): a
    rehearsal, whose launch checks fail."""
    import numpy as np
    import torch

    from qmf_tpu_torch import WALSConfig
    from qmf_tpu_torch.cli import gen_uniform
    from qmf_tpu_torch.cli import wals as cli
    from qmf_tpu_torch.data import load_factors, native, read_dataset
    from qmf_tpu_torch.models import WALSEngine
    from qmf_tpu_torch.ops import spd_solve
    from qmf_tpu_torch.utils.tracing import trace

    from qmf_tpu_torch.distributed.taskdef import TaskDef
    from qmf_tpu_torch.distributed.worker import task_config

    train, test = data
    launches = {"chol_solve": 0, "build_solve": 0, "build_solve_hot": 0}
    torch.cuda.empty_cache()

    # 11a: ml20m through wals_submit, against the wals CLI
    t0 = time.time()
    files = {n: os.path.join(tmp, n) for n in (
        "ml20m.txt", "uniform.dat", "du.dat", "di.dat", "su.dat", "si.dat")}
    write_s = _write_ratings(files["ml20m.txt"], train)
    nitems = len(np.unique(train.item_ids))
    gen_uniform.main([str(nitems * K_MAIN), files["uniform.dat"],
                      f"--seed={SEED}"])
    task = dict(nepochs=3, nfactors=K_MAIN, solver="auto",
                distribution_file=files["uniform.dat"],
                train_set=files["ml20m.txt"])
    cpu = ["--n_local_devices=1"] if device == "cpu" else []
    cp = _ControlPlane(tmp, *cpu)
    try:
        entry = cp.finished(cp.submit("ml20m", **task,
                                      user_factors=files["du.dat"],
                                      item_factors=files["di.dat"]))
    finally:
        cp.close()
    res = entry["result"]
    spd_solve.launches = 0
    native.last_path.update(read=None, write=None)
    t1 = time.time()
    rc = cli.main([f"--{k}={v}" for k, v in task.items()
                   if k != "train_set"] + [
        f"--train_dataset={files['ml20m.txt']}", f"--device={device}",
        f"--user_factors={files['su.dat']}",
        f"--item_factors={files['si.dat']}"])
    cli_s, cli_launches = time.time() - t1, spd_solve.launches
    cli_io = dict(native.last_path)
    same, err = _factor_files_err((files["du.dat"], files["di.dat"]),
                                  (files["su.dat"], files["si.dat"]))
    auc = _auc_of_files(files["du.dat"], files["di.dat"], test, device,
                        CP_TEST_USERS)[0]
    n = res["launches"]["chol_solve"]
    native_io = {"read": "native", "write": "native"}
    if not (rc == 0 and n > 0 and n == cli_launches
            and res["solver"] == "kernel" and err <= 5 * F32_TOL
            and res["io"] == native_io == cli_io
            and res["pack"] == "device-packed"
            and abs(auc - split["auc"]) <= 2e-3):
        raise AssertionError(
            f"11a: rc {rc}, worker {res}, CLI launches {cli_launches}, "
            f"normwise {err}, AUC {auc} vs phase 4's {split['auc']}")
    launches["chol_solve"] += n
    _line("11a control plane ml20m", t0, ratings=len(train), k=K_MAIN,
          worker_hot_widths=res["hot_widths"],
          write_ratings_s=round(write_s, 3), task_s=round(
              entry["finished"] - entry["started"], 3),
          worker_wall_s=res["wall_s"], worker_stages=res["stages"],
          worker_init_stages=res["init_stages"], worker_pack=res["pack"],
          worker_io_path=res["io"], cli_io_path=cli_io,
          epoch_s=res["epoch_s"], phase4_epoch_s=[
              round(x, 4) for x in split["epoch_s"]],
          losses=[f"{x:.10g}" for x in res["losses"]],
          chol_solve_launches=n, cli_launches=cli_launches,
          cli_s=round(cli_s, 3), bitwise_equal_to_cli=same,
          normwise_err_vs_cli=err, test_auc=auc,
          phase4_test_auc=split["auc"], device=res["device"])
    for name, path in files.items():
        if name != "ml20m.txt":  # phase 18's ratings
            os.remove(path)
    torch.cuda.empty_cache()

    # 11b, 11c: two gloo ranks on cuda:0 (a scheduler and a labor)
    t0 = time.time()
    ml100k = {"train_set": cli_files["train.txt"]}
    out = {n: os.path.join(tmp, f"{n}.dat") for n in (
        "fu", "fi", "du", "di", "ku", "ki")}
    f64 = dict(dtype="float64", nepochs=3, solver="auto")
    cp = _ControlPlane(tmp, *(cpu or ["--backend=gloo",
                                      f"--device={device}:0"]))
    try:
        peer = cp.labor()
        runs = {}
        for name, fields, u, i in (
                ("fused", dict(solver="fused"), "fu", "fi"),
                ("f64", f64, "du", "di")):
            taskid = cp.submit(name, **ml100k, **fields,
                               user_factors=out[u], item_factors=out[i])
            runs[name] = (cp.finished(taskid)["result"],
                          cp.labor_result(taskid))
        single = WALSEngine(WALSConfig(**f64), device=device)
        single.init(read_dataset(cli_files["train.txt"]))
        single.optimize()
        want = (single.user_factors.cpu().numpy(),
                single.item_factors.cpu().numpy())

        def f64_diff(u: str, i: str) -> float:
            """Max |file - single-device factor| of a float64 task."""
            return max(float(np.abs(load_factors(out[p])[1].factors
                                    - w).max())
                       for p, w in zip((u, i), want))

        diff = f64_diff("du", "di")
        fused_auc = _auc_of_files(out["fu"], out["fi"],
                                  read_dataset(cli_files["test.txt"]),
                                  device)[0]
        rank_launches = {name: [r["launches"] for r in pair]
                         for name, pair in runs.items()}
        # each rank launches once a chunk of its share, as a single engine
        # packed for two ranks does, at the widths one device resolves
        td = TaskDef(solver="fused")
        per_epoch, widths = _path_launches(
            read_dataset(cli_files["train.txt"]), task_config(td), device,
            world=2)
        expect = {k: per_epoch[k] * td.nepochs
                  for k in ("build_solve", "build_solve_hot")}
        ok = (all(r["attempts"] == 1 and r["labors"] == [peer]
                  and r["num_processes"] == 2 and r["backend"] == "gloo"
                  for r, _ in runs.values())
              and all(r["hot_widths"] == widths for r in runs["fused"])
              and all({k: la[k] for k in expect} == expect
                      for la in rank_launches["fused"])
              and all(la["chol_solve"] > 0 for la in rank_launches["f64"])
              and abs(fused_auc - fused["cli_auc"]) <= 2e-3
              and diff <= 1e-9)
        if not ok:
            raise AssertionError(f"11b: {runs}, AUC {fused_auc} vs "
                                 f"{fused['cli_auc']}, f64 {diff}, "
                                 f"expected fused launches a rank {expect} "
                                 f"at widths {widths}")
        for name, keys in (("fused", expect), ("f64", ("chol_solve",))):
            for key in keys:
                launches[key] += sum(la[key] for la in rank_launches[name])
        _line("11b control plane gloo w2", t0, labor=peer,
              device=runs["f64"][0]["device"], fused_hot_widths=widths,
              launches_by_rank=rank_launches,
              fused_test_auc=fused_auc,
              phase6_cli_test_auc=fused["cli_auc"],
              f64_max_abs_diff_vs_single=diff,
              task_s={n: r["wall_s"] for n, (r, _) in runs.items()},
              epoch_s={n: [r["epoch_s"], r1["epoch_s"]]
                       for n, (r, r1) in runs.items()},
              stages={n: r["stages"] for n, (r, _) in runs.items()})

        # 11c: the labor again, its epochs stretched; kill its worker
        t0 = time.time()
        cp.stop_labors()
        peer = cp.labor(env={"QMF_TPU_EPOCH_SLEEP_S": str(CP_SLEEP_S)})
        taskid = cp.submit("drill", **ml100k, **f64,
                           user_factors=out["ku"], item_factors=out["ki"])

        latest = os.path.join(cp.ckpt_dir(taskid), "LATEST")

        def first_epoch():
            st = cp.status()
            return (st["labors"].get(peer, {}).get("epoch", 0) >= 1
                    and os.path.exists(latest) and _worker_pid(1))

        pid = cp._wait(first_epoch, 120, "labor's first progress frame")
        os.kill(pid, 9)
        entry = cp.finished(taskid)
    finally:
        cp.close()
    res = entry["result"]
    same, _ = _factor_files_err((out["ku"], out["ki"]), (out["du"], out["di"]))
    drill = f64_diff("ku", "ki")
    if not (res["attempts"] == 2 and 0 < len(res["losses"]) < f64["nepochs"]
            and res["labors"] == [peer] and drill <= 1e-9):
        raise AssertionError(f"11c: {entry}, max abs diff {drill}")
    launches["chol_solve"] += res["launches"]["chol_solve"]
    _line("11c fault drill", t0, killed_pid=pid, attempts=res["attempts"],
          epochs_after_resume=len(res["losses"]), nepochs=f64["nepochs"],
          f64_max_abs_diff_vs_single=drill, files_equal_to_11b=same,
          task_s=round(entry["finished"] - entry["started"], 3))

    # 11d: one ml100k epoch on the card under trace()
    t0 = time.time()
    # epochs dispatched one by one: the trace's span is wals_epoch_1
    engine = WALSEngine(WALSConfig(nepochs=1, fuse_epoch=False),
                        device=device)
    engine.init(read_dataset(cli_files["train.txt"]))
    trace_dir = os.path.join(tmp, "trace")
    spd_solve.launches = 0
    with trace(trace_dir):
        engine.optimize()
    n = spd_solve.launches
    (name,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == "wals_epoch_1"
             and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    lo, hi = (spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]) if spans \
        else (0, -1)
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "chol_solve" in e.get("name", "")]
    inside = [e for e in kernels if lo <= e["ts"] <= hi]
    # CUPTI may drop an event (23 of 24 in one run), so the trace is held
    # to holding the kernel, every event of it inside the epoch's span
    if not (len(spans) == 1 and n > 0 and 0 < len(inside) == len(kernels)):
        raise AssertionError(f"11d: {len(spans)} wals_epoch_1 spans, "
                             f"{len(inside)}/{len(kernels)} chol_solve "
                             f"kernels inside, {n} launches")
    launches["chol_solve"] += n
    _line("11d trace", t0, trace_bytes=os.path.getsize(
              os.path.join(trace_dir, name)), events=len(events),
          epoch_span_ms=round(spans[0]["dur"] / 1e3, 3),
          chol_solve_kernels_inside=len(inside), launches=n,
          chol_solve_device_ms=round(
              sum(e["dur"] for e in inside) / 1e3, 3))
    return launches, files["ml20m.txt"]


def recovery(ratings: str, tmp: str, smi: str, device: str = "cuda") -> None:
    """Phase 18: tools/recovery_cost's pair on 11a's ml20m ratings (k =
    64, 3 epochs, solver "auto"), a scheduler and one labor as two gloo
    ranks on cuda:0, epochs stretched as 11c's: run A uninterrupted, run B
    with the labor's worker killed after the first checkpoint. Removes
    ``ratings``. With ``device="cpu"`` the ranks run on the host: a
    rehearsal, whose launch check fails."""
    from qmf_tpu_torch.tools import recovery_cost

    t0 = time.time()
    out = os.path.join(tmp, "recovery")
    os.makedirs(out)
    nepochs = 3
    tasks = [recovery_cost.make_task(out, tag, 0, nepochs, K_MAIN,
                                     train=ratings)
             for tag in ("base", "kill")]
    try:
        with recovery_cost.epoch_sleep(CP_SLEEP_S):
            pair = recovery_cost.measure_pair(
                *tasks, "cpu" if device == "cpu" else f"{device}:0")
    finally:
        os.remove(ratings)
    if not (pair["attempts"] == [1, 2]
            and 0 < pair["resumed"]["epochs"] < nepochs
            and all(la["chol_solve"] > 0 for la in pair["launches"])
            and pair["b_vs_a"]["normwise"] <= 5 * F32_TOL):
        raise AssertionError(f"18: {pair}")
    _line("18 recovery cost", t0, epoch_sleep_s=CP_SLEEP_S, card=repr(smi),
          **pair)


def _event_ms(fn) -> tuple:
    """(host ms, CUDA-event ms) of one call of ``fn``, which ends in a wait
    for the device or is followed by one here."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.time()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return 1e3 * (time.time() - t0), start.elapsed_time(end)


# The port's CUDA kernels by their __global__ names (csrc/*.cu), as the
# profiler names their events. A build_solve.cu call issues one of
# build_solve_kernel (one block a row) or reduce_solve_kernel (the stream
# split over blocks, after build_partial_kernel and sum_partials_kernel),
# and hot_gemm_kernel first with the hot head.
PORT_KERNELS = ("chol_solve_kernel", "build_solve_kernel",
                "build_partial_kernel", "sum_partials_kernel",
                "reduce_solve_kernel", "hot_gemm_kernel", "gather_vec_kernel",
                "gather_warp_kernel", "gather_tile_kernel")


def _profiled_kernels(fn) -> tuple:
    """One call of ``fn`` under torch.profiler: (the events of each of
    PORT_KERNELS, every kernel event), and the change of each registered
    launch counter (kernels.read_counters) over the call."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from qmf_tpu_torch import kernels

    torch.cuda.synchronize()
    before = kernels.read_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    delta = {name: a - b for name, a, b in zip(
        kernels.counter_names(), kernels.read_counters(), before)}
    seen = dict.fromkeys(PORT_KERNELS, 0)
    total = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or "memcpy" in e.key.lower() \
                or "memset" in e.key.lower():
            continue
        total += e.count
        for name in PORT_KERNELS:
            if re.search(rf"\b{name}\b", e.key):
                seen[name] += e.count
    return seen, total, delta


def _launches_are_nodes(name: str, seen: dict, delta: dict) -> None:
    """Phase 12a: the port's kernel events one replay of a graph shows
    against what the counters add at that replay. CUPTI may drop an event
    (as 11d allows), so each event count may fall short of its counter by
    one, never exceed it; and no counter ticks for a kernel the replay did
    not run."""
    solves = delta["build_solve.launches"] + delta["build_solve.launches_hot"]
    pairs = {
        "chol_solve_kernel": (seen["chol_solve_kernel"],
                              delta["spd_solve.launches"]),
        "build_solve_kernel+reduce_solve_kernel": (
            seen["build_solve_kernel"] + seen["reduce_solve_kernel"], solves),
        "hot_gemm_kernel": (seen["hot_gemm_kernel"],
                            delta["build_solve.launches_hot"]),
        "gather": (sum(seen[f"gather_{v}_kernel"]
                       for v in ("vec", "warp", "tile")),
                   sum(n for c, n in delta.items()
                       if c.startswith("gather."))),
    }
    bad = {k: v for k, v in pairs.items() if not v[1] - 1 <= v[0] <= v[1]}
    if bad or sum(delta.values()) == 0 or \
            seen["build_partial_kernel"] > seen["reduce_solve_kernel"] + 1:
        raise AssertionError(f"12a {name}: a replay's kernel events vs its "
                             f"counters' ticks {pairs}, events {seen}")


def _wals_mode(engine, mode: str, nepochs: int, start) -> dict:
    """Phase 12a, one mode of one engine: ``nepochs`` epochs from the
    factors ``start``, dispatched eagerly ("eager", fuse_epoch=False), one
    program an epoch ("per_epoch", checkpointing on) or the whole run as
    one ("whole_run"), each graph mode from a fresh capture."""
    import torch

    from qmf_tpu_torch.ops import build_solve, graphs, spd_solve

    cfg = engine.config
    engine.load_factors(*start)
    cfg.fuse_epoch = mode != "eager"
    engine._program = None
    epochs = []
    engine.progress_cb = _recorder(engine, epochs)
    with tempfile.TemporaryDirectory(prefix="qmf_chip_smoke_") as ckpt:
        engine._ckpt_dir = ckpt if mode == "per_epoch" else None
        spd_solve.launches = build_solve.launches = 0
        build_solve.launches_hot = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        engine.optimize()
        engine._ckpt_dir = None
    del engine._fused_run  # the recorder's wrapper
    program = engine._program
    graphed = isinstance(program, graphs.EpochGraph)
    if (mode == "eager") == graphed or len(epochs) != nepochs:
        raise AssertionError(f"12a {mode}: program {program!r}, "
                             f"{len(epochs)} epochs")
    return {
        "u": engine.user_factors.clone(), "v": engine.item_factors.clone(),
        "losses": [e[1] for e in epochs],
        "launches_per_epoch": {
            "chol_solve": spd_solve.launches / nepochs,
            "build_solve": build_solve.launches / nepochs,
            "build_solve_hot": build_solve.launches_hot / nepochs},
        "epoch_s": [round(e[2], 4) for e in epochs],
        "capture_s": round(program.capture_s, 4) if graphed else None,
        "instantiate_s": (round(program.instantiate_s, 4) if graphed
                          else None),
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "auc": engine.metrics_engine.last("test_avg_auc")[1],
    }


def graph_epochs(engines: dict, nepochs: int = 3) -> None:
    """Phase 12a: the WALS epoch as a CUDA graph (fuse_epoch, ops/graphs.py)
    on phase 4's packed data, for each engine of ``engines`` (name ->
    phase 4's split engine, phase 6's fused+hot one): ``nepochs`` epochs
    from its trained factors eagerly, one replay an epoch and as a whole
    run. Both graph modes must equal the eager run bit for bit (factors and
    losses: the kernels and the library calls on the path are
    deterministic) and count its launches an epoch. Then CUDA events
    around an eager epoch and around a replay: the replay runs the epoch's
    kernels back to back, so its device ms is the epoch's busy time, and
    the idle share of an epoch is 1 - busy / wall."""
    import statistics

    import torch

    for name, engine in engines.items():
        t0 = time.time()
        cfg = engine.config
        cfg_keep = (cfg.nepochs, cfg.fuse_epoch, engine.progress_cb)
        cfg.nepochs = nepochs
        start = (engine.user_factors[: engine.nusers].clone(),
                 engine.item_factors[: engine.nitems].clone())
        runs = {mode: _wals_mode(engine, mode, nepochs, start)
                for mode in ("eager", "per_epoch", "whole_run")}
        eager = runs["eager"]
        equal = {}
        for mode in ("per_epoch", "whole_run"):
            run = runs[mode]
            equal[mode] = (torch.equal(run["u"], eager["u"])
                           and torch.equal(run["v"], eager["v"])
                           and run["losses"] == eager["losses"])
            if not equal[mode] or (run["launches_per_epoch"]
                                   != eager["launches_per_epoch"]):
                raise AssertionError(
                    f"12a {name} {mode}: equal to eager {equal[mode]}, "
                    f"launches an epoch {run['launches_per_epoch']} vs "
                    f"{eager['launches_per_epoch']}, losses "
                    f"{run['losses']} vs {eager['losses']}")
        if name == "split" and eager["launches_per_epoch"]["chol_solve"] != \
                len(engine._user_classes) + len(engine._item_classes):
            raise AssertionError(f"12a split: launches an epoch "
                                 f"{eager['launches_per_epoch']}")
        # device ms: the whole run's graph, replayed from the trained
        # factors, beside eager epochs from the same factors
        cfg.fuse_epoch = False
        graph = engine._program
        eager_ms = [_event_ms(engine._epoch) for _ in range(3)]
        replay_ms = [_event_ms(lambda: graph.replay(engine.item_factors))
                     for _ in range(3)]
        # every launch the counters add at a replay is a node of the graph:
        # one replay and one eager epoch under the profiler
        r_seen, r_total, r_delta = _profiled_kernels(
            lambda: graph.replay(engine.item_factors))
        _launches_are_nodes(name, r_seen, r_delta)
        e_seen, e_total, _ = _profiled_kernels(engine._epoch)
        if any(abs(r_seen[n] - e_seen[n]) > 1 for n in PORT_KERNELS):
            raise AssertionError(f"12a {name}: a replay's kernel events "
                                 f"{r_seen}, an eager epoch's {e_seen}")
        e_wall = statistics.median(w for w, _ in eager_ms)
        e_dev = statistics.median(d for _, d in eager_ms)
        r_wall = statistics.median(w for w, _ in replay_ms)
        busy = statistics.median(d for _, d in replay_ms)
        cfg.nepochs, cfg.fuse_epoch, engine.progress_cb = cfg_keep
        _line(f"12a graph {name}", t0, nepochs=nepochs,
              equal_to_eager=equal, test_auc={m: r["auc"]
                                               for m, r in runs.items()},
              launches_per_epoch=eager["launches_per_epoch"],
              replay_counter_ticks={c: n for c, n in r_delta.items() if n},
              replay_kernel_events={n: c for n, c in r_seen.items() if c},
              eager_kernel_events={n: c for n, c in e_seen.items() if c},
              replay_all_kernel_events=r_total,
              eager_all_kernel_events=e_total,
              **{f"{m}_{key}": r[key] for m, r in runs.items()
                 for key in ("epoch_s", "capture_s", "instantiate_s",
                             "peak_bytes")},
              eager_epoch_wall_ms=round(e_wall, 3),
              eager_epoch_event_ms=round(e_dev, 3),
              replay_wall_ms=round(r_wall, 3),
              replay_event_ms=round(busy, 3),
              eager_idle_share=round(1 - busy / e_wall, 4),
              graph_idle_share=round(1 - busy / r_wall, 4))


def _bpr_f64_graph(device: str) -> dict:
    """Phase 12b at phase 9b's size in float64: three grouped epochs on
    the same keys, the rate decaying, eagerly on the card and on the CPU
    and as a CUDA graph on the card (pass 1 and the SGD loop, one graph);
    max |difference| of the graph's parameters from each."""
    import numpy as np
    import torch

    from qmf_tpu_torch.ops import bpr_ops, graphs

    n_users, n_items, n_pos, bs, k, n_rounds = 300, 500, 1 << 13, 256, 8, 4
    u, i = _bpr_positives(n_pos, n_users, n_items, SEED + 1, zipf=False)
    pos_up = torch.from_numpy(np.stack([u, i], axis=1))
    rng = np.random.default_rng(SEED)
    init = [rng.normal(0, 0.1, s) for s in ((n_users, k), (n_items, k),
                                            (n_items,))]
    gen = torch.Generator().manual_seed(SEED + 2)
    keys = [bpr_ops.draw_grouped_keys(gen, n_rounds, True) for _ in range(3)]
    out = {}
    for run, d in (("graph", device), ("eager", device), ("cpu", "cpu")):
        member = bpr_ops.make_pos_bitmap(u, i, n_users, n_items, device=d)
        epoch = bpr_ops.grouped_epoch(
            pos_up.to(d), member, 0.025, 0.0025, 1.0, n_items, n_pos - 100,
            True, BPR_NEG, n_rounds, bs, n_pos, True, item_scatter="seq",
            sampler="word")
        if run == "graph":
            epoch = graphs.EpochGraph(epoch)
        params = [torch.tensor(a, dtype=torch.float64, device=d)
                  for a in init]
        for e, (rk, ks) in enumerate(keys):
            *params, _ = epoch(
                rk.to(d), ks.to(d),
                torch.tensor(0.05 * 0.9 ** e, dtype=torch.float64, device=d),
                *params)
        out[run] = [t.cpu() for t in params]
        if run == "graph" and epoch.replays != len(keys) - 1:
            raise AssertionError(f"12b f64: {epoch.replays} replays")
    diff = {other: max(float((a - b).abs().max())
                       for a, b in zip(out["graph"], out[other]))
            for other in ("eager", "cpu")}
    if not max(diff.values()) <= BPR_F64_TOL:
        raise AssertionError(f"12b f64: graph vs {diff} beyond "
                             f"{BPR_F64_TOL}")
    return diff


def bpr_graphs(data, bpr: dict, device: str = "cuda"):
    """Phase 12b: BPR's grouped epoch as a CUDA graph. Phase 9d's engine
    ran each epoch (pass 1 and the SGD loop) as one graph (the default on a
    card); a fresh engine of 9d's configuration runs it eagerly on the same
    keys: updates/s, wall ms and CUDA-event ms an epoch, a floor on the
    eager epoch's idle share, peak memory over two epochs of each, capture
    seconds, test AUC within 1e-3; then phase 9b's size in float64, the
    graph within 1e-9 of the eager epoch on the card and on the CPU.
    Returns 9d's engine, which phase 13 trains again."""
    import statistics

    import torch

    from qmf_tpu_torch import BPRConfig, MetricsConfig
    from qmf_tpu_torch.metrics import MetricsEngine
    from qmf_tpu_torch.models import BPREngine
    from qmf_tpu_torch.ops import graphs

    t0 = time.time()
    train, test = data
    graph_engine = bpr.pop("engine")
    program = graph_engine._program
    if not isinstance(program, graphs.EpochGraph):
        raise AssertionError(f"9d's epoch was not a graph: {program!r}")
    me = MetricsEngine(MetricsConfig(num_test_users=3000, seed=SEED))
    me.add_test_avg_metric("auc")
    cfg = BPRConfig(nepochs=BPR_WARM + BPR_TIMED, nfactors=BPR_K,
                    num_negative_samples=BPR_NEG, batch_size=BPR_BATCH,
                    init_seed=0)
    engine = BPREngine(cfg, me, device=device)
    engine.init(train)
    engine.init_test(test)
    engine._program = engine._epoch_body()  # eager on the card
    epochs = []
    engine.progress_cb = lambda *row: epochs.append(row)
    engine.optimize()
    timed = [dt for _, _, _, dt in epochs[BPR_WARM:]]
    epoch_s = statistics.median(timed)
    _, auc = me.last("test_avg_auc")
    if not abs(auc - bpr["auc"]) <= 1e-3:
        raise AssertionError(f"12b: graph AUC {bpr['auc']} vs eager {auc}")
    # two epochs of each, both engines resident, with the peak memory of
    # each pair; then the graph's replay alone (its SGD loop's device
    # time: its kernels run back to back). The eager epoch runs the graph
    # epoch's kernels, which take at most the graph epoch's event ms, so
    # its idle share is at least 1 - that / its wall (9p profiles the
    # graph's; a profile of the eager epoch's 54,000 launches takes
    # longer than the rest of the phase)
    peak = {}
    for name, eng in (("eager", engine), ("graph", graph_engine)):
        torch.cuda.reset_peak_memory_stats()
        peak[name] = [_event_ms(eng._epoch) for _ in range(2)]
        peak[name] = (peak[name], torch.cuda.max_memory_allocated())
    (eager_ms, eager_peak), (graph_ms, graph_peak) = peak["eager"], \
        peak["graph"]
    replay_ms = [_event_ms(lambda: program.replay(*program.inputs))
                 for _ in range(2)]
    del engine
    torch.cuda.empty_cache()
    f64 = _bpr_f64_graph(device)
    n = bpr["real_triplets"]
    _line("12b graph bpr", t0, k=BPR_K, batch=BPR_BATCH,
          graph_updates_per_s=round(bpr["updates_per_s"], 1),
          eager_updates_per_s=round(n / epoch_s, 1),
          graph_epoch_s=[round(x, 4) for x in bpr["timed_s"]],
          eager_epoch_s=[round(x, 4) for x in timed],
          graph_epoch_wall_ms=round(statistics.median(
              w for w, _ in graph_ms), 3),
          graph_epoch_event_ms=round(statistics.median(
              d for _, d in graph_ms), 3),
          eager_epoch_wall_ms=round(statistics.median(
              w for w, _ in eager_ms), 3),
          eager_epoch_event_ms=round(statistics.median(
              d for _, d in eager_ms), 3),
          replay_event_ms=round(statistics.median(
              d for _, d in replay_ms), 3),
          eager_idle_share_at_least=round(
              1 - statistics.median(d for _, d in graph_ms)
              / statistics.median(w for w, _ in eager_ms), 4),
          capture_s=round(program.capture_s, 4),
          record_s=round(program.record_s, 4),
          instantiate_s=round(program.instantiate_s, 4),
          graph_nodes=program.nodes,
          graph_test_auc=bpr["auc"], eager_test_auc=auc,
          graph_epochs_peak_bytes=graph_peak,
          eager_epochs_peak_bytes=eager_peak,
          f64_graph_max_abs_diff=f64, f64_tol=BPR_F64_TOL)
    return graph_engine


def class_solve_check(engine, nepochs: int = 2) -> dict:
    """Phase 13d: WALS class_solve=False (each chunk solved as it is built,
    chol_solve.cu once a chunk) on phase 4's engine and packed data,
    against class_solve=True, ``nepochs`` epochs each from phase 4's
    trained factors, eagerly (fuse_epoch=False) and as a whole run (one
    CUDA graph): factors and losses torch.equal to True's (the kernel
    solves each system alone), launches an epoch (one a chunk against one
    a class), the process's peak memory in each run and one eager epoch's
    peak above what is resident before it (its working set), epoch
    seconds, capture seconds, the replay's event ms; and the kernel
    against its plain version on one chunk of the largest user class, as
    the path hands it over. Returns the
    chol_solve launches of the class_solve=False runs."""
    import torch

    from qmf_tpu_torch.ops import als_ops, spd_solve

    t0 = time.time()
    cfg = engine.config
    keep = (cfg.nepochs, cfg.fuse_epoch, cfg.class_solve, engine.progress_cb)
    cfg.nepochs = nepochs
    start = (engine.user_factors[: engine.nusers].clone(),
             engine.item_factors[: engine.nitems].clone())
    # (rows, width, chunk rows) of every class of both sides
    shapes = [(c[1].shape[0], c[1].shape[1], b) for side in ("user", "item")
              for c, b in zip(getattr(engine, f"_{side}_classes"),
                              getattr(engine, f"_{side}_chunks"))]
    n_chunks = sum(-(-rows // b) for rows, _, b in shapes)
    n_classes = len(shapes)
    k = cfg.nfactors
    runs, replay_ms, working = {}, {}, {}
    for class_solve in (True, False):
        cfg.class_solve = class_solve
        engine._body = None
        # one eager epoch's memory above what is resident before it
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = engine._epoch_body()(engine.item_factors)
        torch.cuda.synchronize()
        working[class_solve] = torch.cuda.max_memory_allocated() - base
        del out
        for mode in ("eager", "whole_run"):
            runs[class_solve, mode] = _wals_mode(engine, mode, nepochs, start)
        graph = engine._program
        replay_ms[class_solve] = [
            _event_ms(lambda: graph.replay(engine.item_factors))[1]
            for _ in range(2)]
        del graph
        engine._program = None
        torch.cuda.empty_cache()
    launches = 0
    equal = {}
    for mode in ("eager", "whole_run"):
        split, whole = runs[False, mode], runs[True, mode]
        per_epoch = (split["launches_per_epoch"]["chol_solve"],
                     whole["launches_per_epoch"]["chol_solve"])
        if per_epoch != (n_chunks, n_classes):
            raise AssertionError(f"13d {mode}: chol_solve launches an epoch "
                                 f"{per_epoch}, expected ({n_chunks}, "
                                 f"{n_classes})")
        launches += split["launches_per_epoch"]["chol_solve"] * nepochs
        equal[mode] = (torch.equal(split["u"], whole["u"])
                       and torch.equal(split["v"], whole["v"])
                       and split["losses"] == whole["losses"])
        if not equal[mode]:
            raise AssertionError(
                f"13d {mode}: class_solve=False differs from True: "
                f"{_normwise_err(split['v'], whole['v'])}, losses "
                f"{split['losses']} vs {whole['losses']}")
    # the kernel against its plain version on a chunk of the path
    biggest = _biggest_user_class(engine)
    _, col, val, mask = engine._user_classes[biggest]
    chunk = engine._user_chunks[biggest]
    y = engine.item_factors
    a, b, _ = als_ops._build_bucket(
        y, als_ops.gramian(y), col[:chunk], val[:chunk], mask[:chunk],
        cfg.confidence_weight, cfg.regularization_lambda,
        cfg.matmul_precision)
    err, scaled = _normwise_err(spd_solve.solve_spd(a, b),
                                spd_solve.solve_spd_reference(a, b))
    if not scaled <= 5 * F32_TOL:
        raise AssertionError(f"13d chunk: kernel vs plain normwise {scaled}")
    cfg.nepochs, cfg.fuse_epoch, cfg.class_solve, engine.progress_cb = keep
    engine._body = engine._program = None
    _line("13d class_solve", t0, nepochs=nepochs, classes=n_classes,
          chunks=n_chunks, chunk_rows=chunk, chunk_max_abs_err=err,
          class_epoch_working_bytes=working[True],
          chunk_epoch_working_bytes=working[False],
          largest_class_a_bytes=max(r for r, _, _ in shapes) * k * k * 4,
          largest_chunk_a_bytes=max(min(r, b) for r, _, b in shapes)
          * k * k * 4,
          widest_chunk_entries=max(min(r, b) * d for r, d, b in shapes),
          chunk_normwise_err=scaled, equal_to_class_solve=equal,
          **{f"{'chunk' if not cs else 'class'}_{mode}_{key}": r[key]
             for (cs, mode), r in runs.items()
             for key in ("launches_per_epoch", "epoch_s", "capture_s",
                         "peak_bytes", "losses", "auc")
             if r[key] is not None},
          **{f"{'chunk' if not cs else 'class'}_replay_event_ms":
             [round(x, 3) for x in ms] for cs, ms in replay_ms.items()})
    return {"launches": launches}


# Phase 14: the most the pick of hot_width "auto" may lose to H = 0 on a
# side, and the half-epochs timed of each width.
HOT_PICK_SLACK, HOT_REPS = 1.03, 5


def hot_width_check(data, split: dict, engines: list, device: str = "cuda",
                    nepochs: int = 3) -> dict:
    """Phase 14: hot_width "auto" (ops/hot.py's rule, H100 constants) on
    phase 4's data at k = 64. The split build's widths are phase 4's
    engine's; the fused build's come from a ``nepochs`` run of solver
    "fused" at "auto", whose test AUC must be within 2e-3 of phase 4's and
    whose build_solve launches of each variant are one a chunk of a side
    at H = 0 or above. Then, for each build and side, the half-epoch
    replayed as a CUDA graph (tools/hot_micro.half_epoch_ms: CUDA events,
    the median of HOT_REPS, the widths taking turns) at H = 0, at the pick
    and at its neighbouring candidates, each beside the rule's modeled
    build ms; it fails where the pick is slower than H = 0 by more than
    HOT_PICK_SLACK. ``engines`` hold phase 4's data in its configuration
    at the widths they were packed with, and serve those widths; the other
    widths are packed here. Returns the fused run's launches."""
    import torch

    from qmf_tpu_torch import MetricsConfig, WALSConfig
    from qmf_tpu_torch.metrics import MetricsEngine
    from qmf_tpu_torch.models import WALSEngine
    from qmf_tpu_torch.ops import build_solve
    from qmf_tpu_torch.ops import hot as hot_ops
    from qmf_tpu_torch.tools import hot_micro

    t0 = time.time()
    train, test = data
    split_engine = engines[0]
    me = MetricsEngine(MetricsConfig(num_test_users=3000, seed=SEED))
    me.add_test_avg_metric("auc")
    cfg = WALSConfig(nfactors=K_MAIN, nepochs=nepochs,
                     matmul_precision="default", batch_rows=8192,
                     solver="fused")
    fused = WALSEngine(cfg, me, device=device)
    fused.init(train)
    fused.init_test(test)
    expect = {k: n * nepochs for k, n in _engine_launches(fused).items()}
    build_solve.launches = build_solve.launches_hot = 0
    fused.optimize()
    launches = {"chol_solve": 0, "build_solve": build_solve.launches,
                "build_solve_hot": build_solve.launches_hot}
    auc = me.last("test_avg_auc")[1]
    if launches != expect or not abs(auc - split["auc"]) <= 2e-3:
        raise AssertionError(f"14: fused at auto widths {fused.hot_widths}: "
                             f"launches {launches}, expected {expect}; AUC "
                             f"{auc} vs phase 4's {split['auc']}")
    picks = {"split": dict(split_engine.hot_widths),
             "fused": dict(fused.hot_widths)}
    seconds = {"fused_run": time.time() - t0}
    demand = hot_micro.side_demand(train)
    widths = {}
    for side in hot_micro.SIDES:
        cands = hot_micro.candidates(*demand[side])
        near = {0}
        for pick in (p[side] for p in picks.values()):
            i = cands.index(pick)
            near.update(cands[max(i - 1, 0):i + 2])
        widths[side] = sorted(near)
    pool = {side: {} for side in hot_micro.SIDES}
    for engine in engines + [fused]:
        for side, h in engine.hot_widths.items():
            pool[side].setdefault(h, engine)
    missing = {side: [h for h in widths[side] if h not in pool[side]]
               for side in hot_micro.SIDES}
    seconds["demand"] = time.time() - t0 - sum(seconds.values())
    if any(missing.values()):
        for side, at in hot_micro.engines_at(train, cfg, missing,
                                             device).items():
            pool[side].update(at)
    seconds["pack"] = time.time() - t0 - sum(seconds.values())
    y = {"user": split_engine.item_factors,
         "item": split_engine.user_factors[: split_engine.nusers]}
    table, vs_h0, vs_fastest = {}, {}, {}
    for build in hot_micro.SOLVERS:
        for side in hot_micro.SIDES:
            ms = hot_micro.half_epoch_ms(
                {h: pool[side][h] for h in widths[side]}, side, build,
                y[side], HOT_REPS)
            pick = picks[build][side]
            name = f"{build}_{side}"
            table[name] = {h: (round(t, 4), round(hot_ops.modeled_ms(
                *demand[side], K_MAIN, h), 4)) for h, t in ms.items()}
            vs_h0[name] = round(ms[pick] / ms[0], 4)
            vs_fastest[name] = round(ms[pick] / min(ms.values()), 4)
            if not ms[pick] <= HOT_PICK_SLACK * ms[0]:
                raise AssertionError(
                    f"14 {name}: auto's pick H={pick} takes {ms[pick]} ms, "
                    f"H=0 {ms[0]} ms (more than {HOT_PICK_SLACK}x): {table}")
    del pool, fused
    torch.cuda.empty_cache()
    seconds["timing"] = time.time() - t0 - sum(seconds.values())
    _line("14 hot width", t0, picks=picks, widths_timed=widths,
          widths_packed_here=missing,
          seconds={k: round(v, 3) for k, v in seconds.items()},
          half_epoch_ms_and_model_ms=table, pick_over_h0=vs_h0,
          pick_over_fastest=vs_fastest, fused_launches=launches,
          fused_test_auc=auc, phase4_test_auc=split["auc"])
    return launches


# Phase 15: the metric lines tools/bench.py prints at its defaults.
BENCH_METRICS = ("ml20m_wals_epoch_time_k64_torch",
                 "ml20m_bpr_updates_per_s_torch")


def decomposition(engine) -> tuple:
    """Phase 15b: tools/epoch_decomp.decompose on phase 4's split engine
    (its packed data at "auto"'s widths, no new init): the replayed epoch
    and each side's build (with and without the hot head) and solve, each
    captured and replayed as a CUDA graph, every part finite and positive,
    and chol_solve's launches in it. Returns the phase's seconds and the
    parts."""
    import math

    from qmf_tpu_torch.ops import spd_solve
    from qmf_tpu_torch.tools import epoch_decomp

    t0 = time.time()
    spd_solve.launches = 0
    parts = epoch_decomp.decompose(engine)
    launches = spd_solve.launches
    ms = {k: v for k, v in parts.items() if k.endswith("_ms")}
    if _finite_positive(ms) or parts["mode"] != "split" \
            or not launches > 0:
        raise AssertionError(f"15b: parts {parts}, chol_solve launches "
                             f"{launches}")
    for ln in epoch_decomp.report(parts).splitlines():
        print("  15b", ln, file=sys.stderr, flush=True)
    _line("15b epoch decomposition", t0, solver=parts["solver"],
          hot_widths=parts["hot_widths"],
          epoch_ms_each=[round(x, 3) for x in parts["epoch_ms_each"]],
          **{k: round(v, 3) for k, v in ms.items()},
          chol_solve_launches=launches)
    return time.time() - t0, parts


def bench_tool(smi: str) -> float:
    """Phase 15a: ``python -m qmf_tpu_torch.tools.bench`` once, as a
    subprocess, at its defaults (ml20m, k = 64, 7 epochs, then BPR at k =
    30) with one spread round (QMF_BENCH_SPREAD_ROUNDS=1: a noisy host
    costs no 30 s sleeps); it loads the kernels this run built. Its two
    metric lines: finite values, a finite WALS loss, and the card's name
    and power limit as phase 0's nvidia-smi line gives them. Its ``#``
    lines go to stderr. Returns the phase's seconds."""
    import math
    import re

    t0 = time.time()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("QMF_BENCH_")}
    env["QMF_BENCH_SPREAD_ROUNDS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "qmf_tpu_torch.tools.bench"],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=900)
    notes = [ln for ln in proc.stderr.splitlines() if ln.startswith("#")]
    for ln in notes:
        print("  15a", ln, file=sys.stderr, flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"15a: tools.bench exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    metrics = {}
    for ln in proc.stdout.splitlines():
        obj = json.loads(ln)  # the tool's stdout holds its metric lines
        metrics[obj["metric"]] = obj
    name, _, power = smi.rpartition(",")
    device = {"name": name.strip(),
              "power_limit_w": float(power.strip().split()[0])}
    wals, bpr = (metrics.get(m) for m in BENCH_METRICS)
    if sorted(metrics) != sorted(BENCH_METRICS) or any(
            not (math.isfinite(m["value"]) and m["value"] > 0)
            or m["device"] != device for m in (wals, bpr)) \
            or not math.isfinite(wals["loss"]):
        raise AssertionError(f"15a: metric lines {metrics}, card {device}")
    busy = [float(x) for ln in notes
            for x in re.findall(r"busy ([0-9.]+)% of the wall", ln)]
    _line("15a bench", t0, card=repr(device["name"]),
          power_limit_w=device["power_limit_w"],
          wals_epoch_s=wals["value"], wals_spread=wals["spread"],
          wals_epochs_s=wals["epochs_s"], wals_loss=wals["loss"],
          solver=wals["solver"], hot_widths=wals["hot_widths"],
          bpr_updates_per_s=bpr["value"], bpr_spread=bpr["spread"],
          bpr_epochs_s=bpr["epochs_s"], bpr_path=bpr["path"],
          vs_baseline=[wals["vs_baseline"], bpr["vs_baseline"]],
          profiled_busy_pct_wals_bpr=busy)
    return time.time() - t0


# Phase 16: replays of a part in build_attrib and samples of a part in
# bpr_decomp (the tools' REPS is 5). Fewer keep the phase under 90 s, most
# of which goes to capturing the BPR epochs' graphs (52k-208k nodes).
ATTRIB_REPS, BPR_DECOMP_REPS = 2, 2
# 16b's engines whose split_check runs: its deterministic graphs hold about
# three times the nodes of the default capture, and at batch 8,192 (208k
# nodes by default) two of them would take longer than the rest of phase 16
SPLIT_CHECKED = ("9d", "bloom")


def _finite_positive(ms: dict) -> dict:
    """The entries of ``ms`` that are not finite and positive."""
    import math

    return {k: v for k, v in ms.items()
            if not (math.isfinite(v) and v > 0)}


def build_attribution(engines: dict, decomp: dict) -> dict:
    """Phase 16a: tools/build_attrib.attribute on phase 4's engine (at
    "auto"'s widths) and on the H = 0 engine of phases 5-7, both holding
    phase 4's factors (no new init): each side's width classes on the
    split build and build_solve.cu, with and without the hot head where H
    > 0, each class a CUDA graph; every class's ms finite and positive,
    each side's sums printed beside 15b's parts ``decomp``, and
    build_solve.cu's launches (both variants) in the phase on its line, not
    in the kernels line (the probe is not the main path). Returns the
    phase's seconds."""
    import torch

    from qmf_tpu_torch.ops import build_solve
    from qmf_tpu_torch.tools import build_attrib

    t0 = time.time()
    build_solve.launches = build_solve.launches_hot = 0
    for name, engine in engines.items():
        t1 = time.time()
        got = build_attrib.attribute(engine, ATTRIB_REPS)
        for side, part in got["sides"].items():
            for r in part["classes"]:
                bad = _finite_positive({k: v for k, v in r.items()
                                        if k.endswith("_ms")})
                if bad:
                    raise AssertionError(f"16a {name} {side}: class {r}")
        text = build_attrib.report(got, decomp if name == "auto" else None)
        for ln in text.splitlines():
            print("  16a", name, ln, file=sys.stderr, flush=True)
        sums = {f"{side}_{p}_ms": round(ms, 3)
                for side, part in got["sides"].items()
                for p, ms in part["sums_ms"].items()}
        beside = {k: round(v, 3) for k, v in decomp.items()
                  if k.startswith(("user_", "item_")) and k.endswith("_ms")} \
            if name == "auto" else None
        classes = {side: [(r["D"], r["N"], round(r["split_ms"], 3),
                           round(r["fused_ms"], 3))
                          for r in part["classes"]]
                   for side, part in got["sides"].items()}
        _line(f"16a build attribution {name}", t1,
              hot_widths=got["hot_widths"], **sums, fifteen_b=beside,
              classes_d_n_split_fused_ms=classes)
        del got
        torch.cuda.empty_cache()
    launches = {"build_solve": build_solve.launches,
                "build_solve_hot": build_solve.launches_hot}
    if not launches["build_solve"] > 0:
        raise AssertionError(f"16a: build_solve.cu launches {launches}")
    _line("16a build_solve.cu launches", t0, **launches)
    return time.time() - t0


def bpr_decomposition(engine, device: str = "cuda") -> tuple:
    """Phase 16b, between 12b and 13: tools/bpr_decomp on phase 9d's
    engine as 12b returns it (batch 32,768, word sampler, its epoch graph
    captured), then on two fresh engines of 9d's data (bpr_decomp.init_like
    9d's engine), batch 8,192 and the Bloom filter with the CSR check
    (bitmap_budget_mb=0): decompose's parts (the replayed epoch, pass 1
    and the SGD loop timed in turns, pass 1's stages, the bench step's
    host parts), every one finite and positive; and on the engines of
    SPLIT_CHECKED, split_check: pass 1 and the loop, each its own CUDA
    graph, against a graph of the engine's epoch program, every replay
    under torch.use_deterministic_algorithms, torch.equal. Phase 13 trains
    9d's engine again from its start. Returns the phase's seconds and 9d's
    epoch, pass 1 and loop ms (phase 10c prints them beside its own)."""
    import torch

    from qmf_tpu_torch.models import BPREngine
    from qmf_tpu_torch.tools import bpr_decomp

    t0 = time.time()
    nine_d = {}

    def fresh(batch, bloom):
        eng = BPREngine(bpr_decomp.bpr_config(batch, bloom), device=device)
        bpr_decomp.init_like(eng, engine)
        return eng

    for name, make in (("9d", lambda: engine),
                       ("batch8192", lambda: fresh(8192, False)),
                       ("bloom", lambda: fresh(BPR_BATCH, True))):
        t1 = time.time()
        eng = make()
        torch.cuda.synchronize()
        init_s = time.time() - t1
        parts = bpr_decomp.decompose(eng, BPR_DECOMP_REPS)
        decompose_s = time.time() - t1 - init_s
        ms = {k: v for k, v in parts.items()
              if k.endswith("_ms") and k != "stages_ms"}
        ms.update({f"stage_{k}": v for k, v in parts["stages_ms"].items()})
        ms.update({f"updates_per_s_{k}": v
                   for k, v in parts["updates_per_s"].items()})
        check = None
        if name in SPLIT_CHECKED:
            check = bpr_decomp.split_check(eng)
            check["seconds"] = round(time.time() - t1 - init_s
                                     - decompose_s, 3)
        want = {"bloom": "bloom"}.get(name, "word")
        if _finite_positive(ms) or parts["membership"] != want \
                or not (check is None or check["equal"]):
            raise AssertionError(f"16b {name}: parts {parts}, split check "
                                 f"{check}")
        for ln in bpr_decomp.report(parts).splitlines():
            print("  16b", name, ln, file=sys.stderr, flush=True)
        _line(f"16b bpr decomposition {name}", t1,
              init_like_s=round(init_s, 3) if name != "9d" else None,
              decompose_s=round(decompose_s, 3),
              batch=parts["batch"], membership=parts["membership"],
              collide_cap=parts["collide_cap"], nodes=parts["nodes"],
              real_triplets=parts["real_triplets"],
              **{k: [round(x, 3) for x in v] for k, v in parts.items()
                 if k.endswith("_each")},
              **{k: round(v, 3) for k, v in ms.items()},
              split_check=check)
        if name == "9d":
            nine_d = {k: parts[f"{k}_ms"] for k in ("epoch", "pass1", "sgd")}
        del parts
        if eng is not engine:
            del eng
        torch.cuda.empty_cache()
    return time.time() - t0, nine_d


# Phases 17 and 10c: tools/bpr_grouped_micro's steps and rounds (its
# defaults), and the node count of phase 9d's epoch graph: 52,177, which
# the loop's split into step helpers keeps, and the stamp kernels at entry
# and exit of the epoch's three parts (utils/tracing.py part)
MICRO_STEPS, MICRO_REPS = 100, 5
EPOCH_NODES_9D = 52177 + 6


def _micro_ms(parts: dict) -> dict:
    """Every ms a step of a tools/bpr_grouped_micro run, by name."""
    ms = {}
    for v, r in parts["variants"].items():
        ms[v] = r["ms_per_step"]
        ms.update({f"{v}_{i}": m for i, m in enumerate(r["ms_per_step_each"])})
    return ms


def grouped_micro(engine, device: str = "cuda") -> float:
    """Phase 17, right after 16b and before 13: tools/bpr_grouped_micro on
    phase 9d's engine as 16b leaves it (batch 32,768, word sampler): first
    ``engine`` mode, the JAX probe's seven variants on the first
    MICRO_STEPS steps of the engine's pass 1 stream, then ``synthetic``
    mode at the JAX probe's defaults (its six variants, batch 32,768, 100
    steps); each variant's steps captured as a CUDA graph and all replayed
    in turns, MICRO_REPS rounds, every ms finite and positive; in each mode
    ``base`` held to the production loop on the same steps
    (bpr_ops._sgd_epoch_scan_grouped_body) under
    torch.use_deterministic_algorithms, torch.equal; 9d's epoch graph's
    nodes against 52,177 and its parts' 6 stamps. One line a mode (the
    table on stderr); returns the phase's seconds."""
    import torch

    from qmf_tpu_torch.tools import bpr_grouped_micro as micro

    t0 = time.time()
    nodes = getattr(engine._program, "nodes", None)
    if nodes != EPOCH_NODES_9D:
        raise AssertionError(f"17: 9d's epoch graph has {nodes} nodes, "
                             f"expected {EPOCH_NODES_9D}")
    for mode in ("engine", "synthetic"):
        t1 = time.time()
        if mode == "engine":
            inp = micro.engine_inputs(engine, MICRO_STEPS)
            variants = micro.JAX_VARIANTS
        else:
            inp = micro.synthetic_inputs(device=device)
            variants = micro.DEFAULT_VARIANTS
        with _deterministic():
            check = micro.production_check(inp)
        parts = micro.measure(inp, variants, MICRO_REPS)
        bound = parts["bound"]
        if _finite_positive({**_micro_ms(parts),
                             "bound": bound["bound_ms_per_step"]}) \
                or not check["equal"]:
            raise AssertionError(f"17 {mode}: parts {parts}, base against "
                                 f"the production loop {check}")
        for ln in micro.report(parts).splitlines():
            print("  17", mode, ln, file=sys.stderr, flush=True)
        r = parts["variants"]
        _line(f"17 grouped step {mode}", t1, batch=parts["batch"],
              steps=parts["steps"], sampler=parts["sampler"],
              item_scatter=parts["item_scatter"],
              ms_per_step={v: round(x["ms_per_step"], 4)
                           for v, x in r.items()},
              minus_base_ms={v: round(x["minus_base_ms"], 4)
                             for v, x in r.items()},
              nodes_per_step={v: x["nodes_per_step"] for v, x in r.items()},
              base_ms_per_step_each=[round(m, 4) for m in
                                     r["base"]["ms_per_step_each"]],
              bound_ms_per_step=round(bound["bound_ms_per_step"], 5),
              bound_mb_per_step=round(bound["bytes_per_step"] / 1e6, 3),
              all_rows_mb_per_step=round(
                  bound["all_rows_bytes_per_step"] / 1e6, 3),
              distinct_users_items_per_step=[
                  round(bound["distinct_users_per_step"], 1),
                  round(bound["distinct_items_per_step"], 1)],
              share_of_bound=round(bound["share"], 4),
              updates_per_s=round(parts["updates_per_s"], 1),
              base_equals_production=check["equal"],
              epoch_nodes=nodes if mode == "engine" else None,
              pr16_epoch_nodes=EPOCH_NODES_9D if mode == "engine" else None)
        del inp, parts
        torch.cuda.empty_cache()
    return time.time() - t0


def sharded_bpr_parts(engine, mesh, epoch_s: float, bpr: dict) -> dict:
    """Phase 10c's parts of ShardedBPREngine at world 1 over NCCL:
    tools/bpr_decomp.decompose on it (its replayed epoch, pass 1 and the
    SGD loop timed in turns, pass 1's stages, the bench step's host parts),
    then tools/bpr_grouped_micro's ``base``, ``mesh`` and ``collective`` on
    the first MICRO_STEPS steps of its pass 1 stream, over its mesh; every
    ms finite and positive. Returns the two sums, pass 1 + loop and
    collective x the epoch's steps, beside 10c's epoch (replayed, and
    optimize's timed epoch ``epoch_s``) and 9d's (16b's replay, and 9d's
    timed epoch)."""
    import torch

    from qmf_tpu_torch.tools import bpr_decomp
    from qmf_tpu_torch.tools import bpr_grouped_micro as micro

    parts = bpr_decomp.decompose(engine, BPR_DECOMP_REPS)
    torch.cuda.empty_cache()
    inp = micro.engine_inputs(engine, MICRO_STEPS)
    step = micro.measure(inp, ("base", "mesh", "collective"), MICRO_REPS,
                         mesh=mesh)
    del inp
    torch.cuda.empty_cache()
    ms = {k: v for k, v in parts.items()
          if k.endswith("_ms") and k != "stages_ms"}
    ms.update({f"stage_{k}": v for k, v in parts["stages_ms"].items()})
    ms.update(_micro_ms(step))
    if _finite_positive(ms):
        raise AssertionError(f"10c parts: {parts}, steps {step}")
    for ln in micro.report(step).splitlines():
        print("  10c", ln, file=sys.stderr, flush=True)
    steps = engine._grp_up.shape[0] // engine._grp_batch
    r = step["variants"]
    return {
        "nodes": parts["nodes"],
        **{f"{k}_ms": round(parts[f"{k}_ms"], 3)
           for k in ("epoch", "pass1", "sgd", "host_epoch")},
        "pass1_plus_sgd_ms": round(parts["pass1_ms"] + parts["sgd_ms"], 3),
        **{f"{k}_ms_each": [round(x, 3) for x in parts[f"{k}_ms_each"]]
           for k in ("epoch", "pass1", "sgd")},
        "steps": steps,
        "step_ms": {v: round(x["ms_per_step"], 4) for v, x in r.items()},
        "collective_times_steps_ms": round(
            r["collective"]["ms_per_step"] * steps, 3),
        "mesh_minus_base_times_steps_ms": round(
            r["mesh"]["minus_base_ms"] * steps, 3),
        "epoch_10c_timed_ms": round(1e3 * epoch_s, 3),
        "epoch_9d_parts_ms": {k: round(v, 3)
                              for k, v in bpr.get("decomp", {}).items()},
        "epoch_9d_timed_ms": round(1e3 * bpr["epoch_s"], 3),
    }


@contextlib.contextmanager
def _deterministic():
    """torch.use_deterministic_algorithms for a comparison: index_add_ then
    sums the rows a step adds to one place in a fixed order (a sort),
    where its default atomics add them in the order the card runs them, so
    an eager epoch and a replay of the same work can be held to each other
    bit for bit."""
    import torch

    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _compact_nonzero(mask, cap):
    """Phase 13a's reference for bpr_ops._compact: the first ``cap`` set
    positions through torch.nonzero (whose shape waits for the device) and
    the count beyond ``cap``, as the presampler compacted before its buffer
    had a fixed size."""
    import torch

    cidx = torch.nonzero(mask).squeeze(1)[:cap].to(torch.int32)
    return cidx, torch.clamp(mask.sum(dtype=torch.int32) - cap, min=0)


def _program_forms(body, draws, start, calls: int,
                   check_calls: int | None = None) -> dict:
    """Phase 13: one epoch of ``body`` from the parameters ``start`` on the
    draws ``draws()`` (a new tuple each call, its step counter at 0):
    ``calls`` calls of ``body`` make the epoch (graphs.run_steps: one for an
    epoch program, the steps for a step program). In the default mode, for
    the times: eagerly, as an EpochGraph (its first call: the warm-up, the
    capture and the epoch's other steps as replays), and replayed from
    ``start`` again; host ms and CUDA-event ms of each. Then under
    _deterministic(), with a graph of its own, the eager run (for an epoch
    program, the warm-up of the graph's first call) against the replay
    over ``check_calls`` calls (the epoch's unless given): every output
    torch.equal, or raise."""
    import torch

    from qmf_tpu_torch.ops import graphs

    def run(program, params, n):
        return graphs.run_steps(program, (*draws(), *params), n)

    def fresh():
        return [t.clone() for t in start]

    def reset(graph):
        for static, t in zip(graph.inputs[-3:], start):
            static.copy_(t)
        return graph.inputs[-3:]

    eager = _event_ms(lambda: run(body, fresh(), calls))
    graph = graphs.EpochGraph(body)
    torch.cuda.reset_peak_memory_stats()
    first = _event_ms(lambda: run(graph, fresh(), calls))
    peak = torch.cuda.max_memory_allocated()
    replay = _event_ms(lambda: run(graph, reset(graph), calls))
    out = {"eager_wall_ms": round(eager[0], 3),
           "eager_event_ms": round(eager[1], 3),
           "first_call_wall_ms": round(first[0], 3),
           "replay_wall_ms": round(replay[0], 3),
           "replay_event_ms": round(replay[1], 3),
           "capture_s": round(graph.capture_s, 4),
           "instantiate_s": round(graph.instantiate_s, 4),
           "graph_nodes": graph.nodes, "graph_calls": graph.replays + 1,
           "first_call_peak_bytes": peak}
    del graph
    n = check_calls or calls
    with _deterministic():
        times = [time.time()]
        graph = graphs.EpochGraph(body)
        if n == 1:
            # the first call's warm-up is the eager call of body
            want = [t.clone() for t in run(graph, fresh(), n)]
        else:
            want = run(body, fresh(), n)
            run(graph, fresh(), n)
        torch.cuda.synchronize()
        times.append(time.time())
        got = run(graph, reset(graph), n)
        torch.cuda.synchronize()
        times.append(time.time())
        equal = [torch.equal(a, b) for a, b in zip(got, want)]
        if not all(equal):
            raise AssertionError(f"a replay differs from the eager run "
                                 f"(outputs equal: {equal})")
        out.update(deterministic_equal_to_eager=True, deterministic_calls=n,
                   deterministic_graph_nodes=graph.nodes,
                   deterministic_capture_s=round(graph.capture_s, 3),
                   deterministic_s=[round(b - a, 3)
                                    for a, b in zip(times, times[1:])])
    del graph
    torch.cuda.empty_cache()
    return out


def _bpr_form(engine, program, bpr: dict) -> dict:
    """Phase 13a: phase 9d's engine trained again from its start, its
    generator's first state and the first rate, with ``program`` as its
    epoch program: 9d's epochs (one warm-up, three timed), then two more
    epochs each between CUDA events."""
    import statistics

    import torch

    from qmf_tpu_torch.ops import bpr_ops

    engine.params = bpr_ops.BPRParams(*(t.clone() for t in bpr["start"]))
    engine.learning_rate = engine.config.init_learning_rate
    engine._generator.set_state(bpr["gen_state"])
    engine.overflow_slots = 0
    engine._program = program
    epochs = []
    engine.progress_cb = lambda *row: epochs.append(row)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine.optimize()
    peak = torch.cuda.max_memory_allocated()
    auc = engine.metrics_engine.last("test_avg_auc")[1]
    ms = [_event_ms(engine._epoch) for _ in range(2)]
    epoch_s = statistics.median(dt for _, _, _, dt in epochs[BPR_WARM:])
    return {"epoch_s": [round(dt, 4) for _, _, _, dt in epochs],
            "updates_per_s": round(bpr["real_triplets"] / epoch_s, 1),
            "wall_ms": round(statistics.median(w for w, _ in ms), 3),
            "event_ms": round(statistics.median(d for _, d in ms), 3),
            "test_auc": auc, "peak_bytes": peak}


def bpr_programs(engine, bpr: dict) -> None:
    """Phase 13a-c: BPR's epochs as one program each, on phase 9d's engine
    and its ml20m data (nothing read or packed again).

    (a) The grouped epoch (word, 9d's configuration), pass 1 included, as
    one graph, beside 12b's form (pass 1 eager, the SGD loop a graph) and
    the eager epoch, each trained again from 9d's start on 9d's keys:
    updates/s, wall and event ms an epoch, the idle share against the
    graph's busy time, capture seconds and nodes, peak memory, AUC within
    1e-3 of 9d's. Then the ``rounds`` sampler on one set of keys: pass 1's
    packed stream and overflow count torch.equal to the pass 1 that
    compacts through torch.nonzero, and the epoch eager, captured and
    replayed (_program_forms).
    (b) The packed legacy epoch (grouped_epoch=False, batch 32,768),
    (c) the in-step legacy epoch (batch 24,576, not a power of two), each
    through _program_forms on one epoch's draws, (c) on the epoch's first
    INSTEP_STEPS steps; for (c) also a graph of INSTEP_WHOLE_STEPS steps,
    the form it did not take: its capture seconds and nodes beside the
    one-step graph's."""
    import numpy as np
    import torch

    from qmf_tpu_torch.ops import bpr_ops, graphs

    t0 = time.time()
    cfg = engine.config
    member = engine._pos_bitmap
    n_real = bpr["real_triplets"]
    # (a) the three forms of the word epoch
    pack = dict(n_items=engine.nitems, n_real=engine._n_real_pos,
                num_neg=BPR_NEG, n_rounds=cfg.neg_resample_rounds,
                wpu=member.words_per_user, u_shift=1 + 2 * BPR_NEG,
                feistel_b=engine._grp_batch.bit_length() - 1,
                collide_cap=engine._collide_cap)
    loop = graphs.EpochGraph(bpr_ops.grouped_sgd(
        member, cfg.user_lambda, cfg.item_lambda, cfg.bias_lambda,
        cfg.use_biases, engine._grp_batch, BPR_NEG, engine.nitems,
        cfg.neg_resample_rounds, cfg.item_scatter, cfg.neg_sampler))

    def loop_graph(rk, ks, lr, uf, itf, ib):
        enc, p, over = bpr_ops._sample_pack_grouped_body(
            rk, ks, engine._grp_up, member.words, membership="word", **pack)
        return (*loop(enc, p, rk, lr, uf, itf, ib), over)

    whole = graphs.EpochGraph(engine._epoch_body())
    forms = {"whole_graph": _bpr_form(engine, whole, bpr),
             "loop_graph": _bpr_form(engine, loop_graph, bpr),
             "eager": _bpr_form(engine, engine._epoch_body(), bpr)}
    busy = forms["whole_graph"]["event_ms"]
    for name, form in forms.items():
        form["idle_share"] = round(1 - busy / form["wall_ms"], 4)
        if not abs(form["test_auc"] - bpr["auc"]) <= 1e-3:
            raise AssertionError(f"13a {name}: AUC {form['test_auc']} vs "
                                 f"9d's {bpr['auc']}")
    _line("13a whole grouped epoch", t0, k=BPR_K, batch=BPR_BATCH,
          sampler="word", real_triplets=n_real, ninth_d_auc=bpr["auc"],
          whole_capture_s=round(whole.capture_s, 4),
          whole_record_s=round(whole.record_s, 4),
          whole_instantiate_s=round(whole.instantiate_s, 4),
          whole_nodes=whole.nodes, loop_capture_s=round(loop.capture_s, 4),
          loop_nodes=loop.nodes,
          **{f"{name}_{k}": v for name, form in forms.items()
             for k, v in form.items()})
    del whole, loop, forms
    engine._program = None

    # (a) rounds: the fixed collision buffer at ml20m
    t0 = time.time()
    rounds = bpr_ops.grouped_epoch(
        engine._grp_up, member, cfg.user_lambda, cfg.item_lambda,
        cfg.bias_lambda, engine.nitems, engine._n_real_pos, cfg.use_biases,
        BPR_NEG, cfg.neg_resample_rounds, engine._grp_batch,
        engine._collide_cap, True, item_scatter=cfg.item_scatter,
        sampler="rounds")
    gen = torch.Generator(device=engine.device).manual_seed(SEED)
    rk, ks = bpr_ops.draw_grouped_keys(gen, cfg.neg_resample_rounds, True)
    lr = torch.full((), cfg.init_learning_rate, device=engine.device)
    fixed = bpr_ops._sample_pack_grouped_body(
        rk, ks, engine._grp_up, member.words, membership="bitmap", **pack)
    compact = bpr_ops._compact
    bpr_ops._compact = _compact_nonzero
    try:
        ref = bpr_ops._sample_pack_grouped_body(
            rk, ks, engine._grp_up, member.words, membership="bitmap",
            **pack)
    finally:
        bpr_ops._compact = compact
    if not all(torch.equal(a, b) for a, b in zip(fixed, ref)):
        raise AssertionError("13a rounds: pass 1 on the fixed buffer differs "
                             "from the nonzero compaction's")
    colliders = int(ref[2]) + engine._collide_cap  # valid when it overflows
    pass1_s = time.time() - t0
    forms = _program_forms(rounds, lambda: (rk, ks, lr), bpr["start"], 1)
    _line("13a rounds", t0, collide_cap=engine._collide_cap,
          pass1_s=round(pass1_s, 3),
          n_overflow=int(fixed[2]),
          overflowed_colliders=colliders if int(ref[2]) else None,
          pass1_equal_to_nonzero=True,
          eager_updates_per_s=round(n_real / forms["eager_wall_ms"] * 1e3, 1),
          replay_updates_per_s=round(
              n_real / forms["replay_wall_ms"] * 1e3, 1), **forms)
    del fixed, ref, rounds

    # (b) and (c): the legacy epochs on the same positives
    cfg.grouped_epoch = False
    for phase, batch in (("13b packed legacy", BPR_BATCH),
                         ("13c in-step legacy", BPR_INSTEP_BATCH)):
        t0 = time.time()
        cfg.batch_size = batch
        engine._tri_users = engine._tri_items = engine._tri_weights = None
        torch.cuda.empty_cache()
        engine._build_triplet_stream()
        torch.cuda.synchronize()
        stream_s = time.time() - t0
        engine._program = None
        packed = engine._legacy_packed()
        if packed != (batch == BPR_BATCH):
            raise AssertionError(f"{phase}: packed path {packed}")
        body = engine._epoch_body()
        draw, cands = engine._draw_legacy()
        rows = engine._tri_users.shape[0]
        if packed:
            calls, n_tri = 1, engine._n_real_triplets

            def draws():
                return draw, cands, lr
        else:
            calls = min(INSTEP_STEPS, cands.shape[0])
            # the real triplets among the prefix's rows of the stream
            n_tri = int((engine._tri_weights[draw[: calls * batch].long()]
                         > 0).sum())

            def draws():
                return (torch.zeros((), dtype=torch.int64,
                                    device=engine.device), draw, cands, lr)
        t1 = time.time()
        forms = _program_forms(body, draws, bpr["start"], calls)
        forms_s = time.time() - t1
        extra = {}
        if not packed:
            # the form not taken: one graph of INSTEP_WHOLE_STEPS steps
            def prefix(*inputs):
                for _ in range(INSTEP_WHOLE_STEPS):
                    out = body(*inputs)
                return out

            g = graphs.EpochGraph(prefix)
            g(*draws(), *(t.clone() for t in bpr["start"]))
            extra = {"whole_form_steps": INSTEP_WHOLE_STEPS,
                     "whole_form_capture_s": round(g.capture_s, 4),
                     "whole_form_nodes": g.nodes,
                     "whole_form_nodes_per_step": g.nodes / INSTEP_WHOLE_STEPS,
                     "whole_form_epoch_nodes_est": round(
                         g.nodes * (rows // batch) / INSTEP_WHOLE_STEPS),
                     "whole_form_epoch_capture_s_est": round(
                         g.capture_s * (rows // batch) / INSTEP_WHOLE_STEPS,
                         2)}
            del g
        _line(phase, t0, batch=batch, stream_rows=rows,
              epoch_steps=rows // batch, steps_run=rows // batch if packed
              else calls, real_triplets=n_tri, stream_s=round(stream_s, 3),
              forms_s=round(forms_s, 3),
              eager_updates_per_s=round(n_tri / forms["eager_wall_ms"] * 1e3,
                                        1),
              replay_updates_per_s=round(
                  n_tri / forms["replay_wall_ms"] * 1e3, 1),
              **forms, **extra)
        del body, draw, cands
    if not np.isfinite(float(engine.params[0].abs().max())):
        raise AssertionError("13: non-finite parameters")


def main() -> int:
    import torch

    t_start = time.time()
    smi = card()
    build()
    timing = kernel_check()
    with tempfile.TemporaryDirectory(prefix="qmf_chip_smoke_") as tmp:
        cli_files = cli_path(out_dir=tmp)  # phase 8 serves from its files
        data, t_data = ml20m_data()
        main_path = model_scale(data, t_data)
        split_engine = main_path.pop("engine")
        profile_split_user(split_engine)
        # phases 5-7 time the kernels on phase 4's data at H = 0
        h0_engine = unsplit_engine(split_engine, data)
        fused_timing = fused_kernel_check(h0_engine)
        torch.cuda.empty_cache()
        fused = fused_path(data, main_path, h0_engine)
        fused_engine = fused.pop("engine")
        gathers = gather_check(h0_engine)
        serve = serving(cli_files, data, split_engine)
        graph_epochs({"split": split_engine, "fused_hot": fused_engine})
        class_solve = class_solve_check(split_engine)
        hot = hot_width_check(data, main_path,
                              [split_engine, h0_engine, fused_engine])
        phase15_s, decomp = decomposition(split_engine)
        attrib_s = build_attribution(
            {"auto": split_engine, "h0": h0_engine}
            if h0_engine is not split_engine else {"auto": split_engine},
            decomp)
        del split_engine, fused_engine, h0_engine
        torch.cuda.empty_cache()
        phase15_s += bench_tool(smi)
        print(f"phase 15 total: ok seconds={phase15_s:.1f}", flush=True)
        bpr_check()
        bpr_cli(cli_files)
        bpr = bpr_scale(data)
        profile_bpr_epoch(bpr["engine"], bpr["epoch_s"])
        bpr_engine = bpr_graphs(data, bpr)
        decomp_s, bpr["decomp"] = bpr_decomposition(bpr_engine)
        phase16_s = attrib_s + decomp_s
        print(f"phase 16 total: ok seconds={phase16_s:.1f}", flush=True)
        print(f"phase 17 total: ok seconds={grouped_micro(bpr_engine):.1f}",
              flush=True)
        bpr_programs(bpr_engine, bpr)
        del bpr_engine
        torch.cuda.empty_cache()
        t0 = time.time()
        _line("10 sharded launches", t0,
              **sharded(data, main_path, fused, bpr, cli_files))
        torch.cuda.empty_cache()
        t0 = time.time()
        launches, ml20m_txt = control_plane(data, main_path, fused,
                                            cli_files, tmp)
        _line("11 control plane launches", t0, **launches)
        recovery(ml20m_txt, tmp, smi)
    print(f"phase total: ok seconds={time.time() - t_start:.1f}", flush=True)
    source = "qmf_tpu_torch/csrc/build_solve.cu"
    # build_solve without the hot head runs on the sides where hot_width
    # "auto" resolves 0: phase 6's CLI and phase 14's fused run
    unsplit = fused["cli_launches"]["build_solve"] + hot["build_solve"]
    if not unsplit > 0:
        raise AssertionError("no path launched build_solve without the hot "
                             "head: auto resolved every side above 0")

    def gather_entry(name, replaces, shape):
        at = gathers[shape]
        return {
            "name": f"gather_{name}",
            "route": "cuda",
            "source": "qmf_tpu_torch/csrc/gather.cu",
            "replaces": replaces,
            "launches": gathers["launches"][name],
            "max_abs_err": 0.0,  # torch.equal held in phase 7
            "ms": at[name],
            "plain_ms": at["plain_fill" if name == "fill" else "plain"],
            "bound_ms": at["bound"],
            "bound_by": "bytes",
            "library_ms": at["index_select"],
        }

    print(json.dumps({"kernels": [{
        "name": "chol_solve",
        "route": "cuda",
        "source": "qmf_tpu_torch/csrc/chol_solve.cu",
        "replaces": "qmf_tpu/ops/pallas_solve.py:155",
        "launches": main_path["launches"] + class_solve["launches"],
        "max_abs_err": main_path["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }, {
        "name": "chol_solve_t",
        "route": "cuda",
        "source": "qmf_tpu_torch/csrc/chol_solve.cu",
        "replaces": "qmf_tpu/ops/pallas_solve.py:136",
        "launches": gathers["launches"]["chol_solve_t"],
        "max_abs_err": timing["t"]["max_abs_err"],
        "ms": timing["t"]["ms"],
        "plain_ms": timing["t"]["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["t"]["library_ms"],
    }, {
        "name": "build_solve",
        "route": "cuda",
        "source": source,
        "replaces": "qmf_tpu/ops/pallas_solve.py:502",
        "launches": unsplit,
        "max_abs_err": fused_timing["max_abs_err"],
        "ms": fused_timing["ms"],
        "plain_ms": fused_timing["plain_ms"],
        "bound_ms": fused_timing["bound_ms"],
        "bound_by": fused_timing["bound_by"],
        "library_ms": None,
    }, {
        "name": "build_solve_hot",
        "route": "cuda",
        "source": source,
        "replaces": "qmf_tpu/ops/pallas_solve.py:534",
        "launches": fused["launches"],
        "max_abs_err": fused["max_abs_err"],
        "ms": fused["ms"],
        "plain_ms": fused["plain_ms"],
        "bound_ms": fused["bound_ms"],
        "bound_by": fused["bound_by"],
        "library_ms": None,
    }, {
        "name": "exclude_seen",
        "route": "cuda",
        "source": "qmf_tpu_torch/csrc/exclude_seen.cu",
        "replaces": None,  # qmf_tpu masks seen items with plain jnp
        "launches": serve["launches"],
        "max_abs_err": 0.0,  # torch.equal held in phase 8
        "ms": serve["ms"],
        "plain_ms": serve["plain_ms"],
        "bound_ms": serve["bound_ms"],
        "bound_by": serve["bound_by"],
        "library_ms": None,
    }, gather_entry("vec", "benchmarks/gather_micro.py:73", "micro"),
        gather_entry("warp", "benchmarks/gather_micro.py:99", "micro"),
        gather_entry("tile", "benchmarks/gather_micro.py:99", "micro"),
        gather_entry("fill", "benchmarks/vmem_gather_micro.py:72", "vmem"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
