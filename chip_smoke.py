#!/usr/bin/env python3
"""Smoke run of the PyTorch port (qmf_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one NVIDIA H100 (sm_90a),
PyTorch built for CUDA and nvcc. It imports no jax. Phases, one line each:

0. the card: name and power limit (nvidia-smi), torch and CUDA versions;
1. build the CUDA kernels from csrc/ (nvcc, sm_90a);
2. the kernel against its plain PyTorch version, f32 and f64, both layouts,
   k in {1, 8, 16, 30, 31, 33, 64, 65, 128, the library's max k} x B in
   {1, 13, systems per block + 1, 4097 (k <= 128)}; non-SPD rows give NaN,
   beside SPD rows of their block; then the kernel, its plain version and
   torch.linalg.solve timed at the ml20m user side's shape (B = 138,493,
   k = 64), with the bound and the systems per block;
3. the CLI main path at ml100k scale with CLI defaults (k = 30): launch
   count, factor files, test AUC, and the factors against a plain-cholesky
   run on the card;
4. the WALSEngine at ml20m scale and k = 64, 3 epochs: epoch times and
   losses, AUC, launch count (and launches per epoch), peak memory; then
   the kernel against the plain version on that run's largest width class;
   then (4p) the split path's user half-epoch under torch.profiler: device
   ms, chol_solve_kernel's time, the largest kernels by device time;
5. the build+solve kernel against its plain version, bf16 and f32 streams,
   without and with the hot head, k in {8, 30, 64} x D in {8, 320, 512} x
   N in {1, 13, 300}, plus wide streams split over blocks, (N, D) in
   {(1, 4096), (8, 32768)}; then the kernel, its plain version and the
   split path's build + chol_solve timed on phase 4's largest user class
   and on its widest item class;
6. solver="fused": the CLI at ml100k (the variant without the hot head),
   then WALSEngine at ml20m, k = 64, with hot_width = 1024 on phase 4's
   data, 3 epochs: epoch times against phase 4's, losses, AUC within 2e-3
   of phase 4's, launch counts, peak memory; then the hot variant against
   its plain version on that run's largest user class, checked and timed;
   then each item class of the fused+hot path, and the user and item
   half-epochs of the split, fused and fused+hot paths, timed in turns.

Then a JSON line describing each kernel (times, launches, errors, and the
bound: the larger of the bytes it must move over 3.35 TB/s and its
operations over the peak rate of their type), and as the last line
``{"ok": true, "device": {...}}``. Any failure raises, and the exit code is
not 0. There is no CPU path: without a CUDA device it fails at phase 0.
"""

from __future__ import annotations

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
    """Phase 1: compile the kernels from the checkout's sources."""
    from qmf_tpu_torch import kernels

    t0 = time.time()
    kernels.load()
    for ln in kernels.build_log.splitlines():
        if "registers" in ln or "spill" in ln:
            print("  ptxas:", ln.strip(), flush=True)
    _line("1 build", t0, lib=os.path.relpath(kernels.LIB_PATH))


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
    """Phase 2: kernel vs plain on the card, then both and the library's
    batched solve timed. ``batches`` above 128 run only up to k = 128; each
    k also runs one block's systems + 1, and each dtype its largest k."""
    import torch

    from qmf_tpu_torch import kernels
    from qmf_tpu_torch.ops import spd_solve

    t0 = time.time()
    dev = torch.device("cuda")
    dtypes = (torch.float32, torch.float64)
    max_k = {dt: kernels.chol_solve_max_k(dt) for dt in dtypes}
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    cases = 0
    for k in sorted(set(ks) | set(max_k.values())):
        k_dtypes = [dt for dt in dtypes if k <= max_k[dt]]
        k_batches = {bsz for bsz in batches if bsz <= 128 or k <= 128}
        k_batches |= {kernels.chol_solve_limits(dt, k).systems_per_block + 1
                      for dt in k_dtypes}
        for bsz in sorted(k_batches):
            a64, b64 = _spd_np(bsz, k, seed=1000 * k + bsz)
            for dtype in k_dtypes:
                a = torch.as_tensor(a64, dtype=dtype, device=dev)
                b = torch.as_tensor(b64, dtype=dtype, device=dev)
                want = spd_solve.solve_spd_reference(a, b)
                for layout in ("nat", "t"):
                    got = spd_solve.solve_spd(a, b, layout=layout)
                    torch.cuda.synchronize()
                    err, scaled = _normwise_err(got, want)
                    tol = F32_TOL if dtype == torch.float32 else F64_TOL
                    if not scaled <= tol:
                        raise AssertionError(
                            f"k={k} B={bsz} {dtype} {layout}: normwise "
                            f"error {scaled} > {tol} (max abs {err})")
                    worst[dtype] = max(worst[dtype], err)
                    cases += 1
    # non-SPD rows: non-finite in both versions, the others of their
    # block untouched
    per_block = kernels.chol_solve_limits(torch.float32, 30).systems_per_block
    n_nan = per_block + 8
    nan_rows = (2, 5, per_block + 6)
    a64, b64 = _spd_np(n_nan, 30, seed=7)
    a64[list(nan_rows)] *= -1.0
    for dtype in (torch.float32, torch.float64):
        a = torch.as_tensor(a64, dtype=dtype, device=dev)
        b = torch.as_tensor(b64, dtype=dtype, device=dev)
        for x in (spd_solve.solve_spd(a, b),
                  spd_solve.solve_spd_reference(a, b)):
            bad = ~torch.isfinite(x).all(dim=1)
            if bad.tolist() != [i in nan_rows for i in range(n_nan)]:
                raise AssertionError(f"non-SPD rows: {bad.tolist()}")

    # timing at the ml20m user side's shape, on well-conditioned systems
    g = torch.Generator(device=dev).manual_seed(SEED)
    m = torch.randn(ML20M_USERS, K_MAIN, K_MAIN, generator=g, device=dev)
    a = torch.baddbmm(torch.eye(K_MAIN, device=dev), m, m.transpose(1, 2),
                      alpha=1.0 / K_MAIN)
    del m
    b = torch.randn(ML20M_USERS, K_MAIN, generator=g, device=dev)
    ms = _time_ms(lambda: spd_solve.solve_spd(a, b))
    t_ms = _time_ms(lambda: spd_solve.solve_spd(a, b, layout="t"))
    plain_ms = _time_ms(lambda: spd_solve.solve_spd_reference(a, b))
    library_ms = _time_ms(lambda: torch.linalg.solve(a, b))
    big_err, scaled = _normwise_err(spd_solve.solve_spd(a, b),
                                    spd_solve.solve_spd_reference(a, b))
    if not scaled <= F32_TOL:
        raise AssertionError(f"B={ML20M_USERS} k=64 f32: err {big_err}")
    del a, b
    torch.cuda.empty_cache()
    bound_ms, bound_by = _chol_bound(ML20M_USERS, K_MAIN, 4)
    limits = kernels.chol_solve_limits(torch.float32, K_MAIN)
    _line("2 kernel", t0, cases=cases,
          max_abs_err_f32=worst[torch.float32],
          max_abs_err_f64=worst[torch.float64],
          max_k_f32=max_k[torch.float32], max_k_f64=max_k[torch.float64],
          timed_shape=f"({ML20M_USERS},{K_MAIN},{K_MAIN})f32",
          systems_per_block=limits.systems_per_block,
          system_bytes=limits.system_bytes,
          kernel_ms=ms, kernel_t_layout_ms=t_ms, plain_ms=plain_ms,
          linalg_solve_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
          timed_max_abs_err=big_err)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err_f32": worst[torch.float32]}


def _split(users, items, values, seed=SEED):
    """10% of the ratings, picked by a seeded RNG, held out as test."""
    import numpy as np

    from qmf_tpu_torch.data import Dataset

    test = np.random.default_rng(seed).random(len(users)) < 0.1
    return (Dataset(users[~test], items[~test], values[~test]),
            Dataset(users[test], items[test], values[test]))


def _n_classes(dataset, cfg) -> int:
    """Width classes of both sides, packed as WALSEngine.init packs them."""
    from qmf_tpu_torch.data import IdIndex
    from qmf_tpu_torch.ops.packing import pack_width_classes

    _, rows = IdIndex.from_sorted_ids_with_lookup(dataset.user_ids)
    _, cols = IdIndex.from_sorted_ids_with_lookup(dataset.item_ids)
    return sum(
        len(pack_width_classes(r, c, dataset.values, int(r.max()) + 1,
                               cfg.batch_rows, width_grid=cfg.width_grid,
                               max_classes=cfg.max_width_classes))
        for r, c in ((rows, cols), (cols, rows))
    )


def _auc_of_files(user_path, item_path, test, device):
    """Test AUC of saved factor files, over every test user."""
    import numpy as np
    import torch

    from qmf_tpu_torch.data import IdIndex, load_factors
    from qmf_tpu_torch.metrics import AUC
    from qmf_tpu_torch.models.engine import Engine

    (uids, ufd), (iids, ifd) = load_factors(user_path), load_factors(item_path)
    users, labels = Engine.init_avg_test_data(
        test, IdIndex(uids), IdIndex(iids))
    u = torch.as_tensor(ufd.factors[users], device=device)
    v = torch.as_tensor(ifd.factors, device=device)
    return AUC().compute(labels, u @ v.T), ufd.factors, ifd.factors, (
        np.asarray(uids), np.asarray(iids))


def cli_path(preset: str = "ml100k", device: str = "cuda") -> None:
    """Phase 3: the CLI with its defaults, through the kernel."""
    import numpy as np
    import torch

    from benchmarks.datagen import PRESETS, generate, write_ratings
    from qmf_tpu_torch import WALSConfig
    from qmf_tpu_torch.cli import wals as cli
    from qmf_tpu_torch.models import WALSEngine
    from qmf_tpu_torch.ops import spd_solve

    t0 = time.time()
    train, test = _split(*generate(**PRESETS[preset], seed=SEED))
    cfg = WALSConfig()  # the CLI's defaults
    expect = _n_classes(train, cfg) * cfg.nepochs
    with tempfile.TemporaryDirectory(prefix="qmf_chip_smoke_") as tmp:
        paths = {n: os.path.join(tmp, n) for n in
                 ("train.txt", "test.txt", "user.dat", "item.dat")}
        for name, ds in (("train.txt", train), ("test.txt", test)):
            write_ratings(paths[name], ds.user_ids, ds.item_ids, ds.values)
        spd_solve.launches = 0
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
    torch.cuda.empty_cache()
    _line("3 cli", t0, preset=preset, ratings=len(train),
          launches=launches, expected=expect, test_auc=auc,
          max_abs_factor_diff_vs_cholesky=diff)


def ml20m_data(preset: str = "ml20m"):
    """The (train, test) split phases 4 and 6 share, and its seconds."""
    from benchmarks.datagen import PRESETS, generate

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
    epochs = []
    engine.progress_cb = lambda e, loss, dt: epochs.append((e, loss, dt))
    n_classes = len(engine._user_classes) + len(engine._item_classes)
    spd_solve.launches = 0
    engine.optimize()
    launches = spd_solve.launches
    peak = torch.cuda.max_memory_allocated()
    losses = [loss for _, loss, _ in epochs]
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
          ratings=len(train), k=K_MAIN, data_s=round(t_data, 3),
          init_s=round(t_init, 3),
          epoch_s=[round(dt, 4) for _, _, dt in epochs],
          losses=[f"{x:.10g}" for x in losses], test_auc=auc,
          classes=n_classes, launches=launches,
          launches_per_epoch=launches / nepochs, peak_bytes=peak,
          class_rows=a.shape[0], class_max_abs_err=err, class_normwise_err=scaled,
          class_max_abs_x=scale)
    return {"launches": launches, "max_abs_err": err, "engine": engine,
            "auc": auc, "epoch_s": [dt for _, _, dt in epochs]}


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


def _n_chunks(dataset, cfg) -> int:
    """Build chunks of both sides, packed as WALSEngine.init packs them
    without the hot split: one fused launch each."""
    from qmf_tpu_torch.data import IdIndex
    from qmf_tpu_torch.ops.packing import chunks_for_classes, pack_width_classes

    _, rows = IdIndex.from_sorted_ids_with_lookup(dataset.user_ids)
    _, cols = IdIndex.from_sorted_ids_with_lookup(dataset.item_ids)
    total = 0
    for r, c in ((rows, cols), (cols, rows)):
        classes = pack_width_classes(
            r, c, dataset.values, int(r.max()) + 1, cfg.batch_rows,
            width_grid=cfg.width_grid, max_classes=cfg.max_width_classes)
        total += sum(-(-cls.shape[0] // ch) for cls, ch in
                     zip(classes, chunks_for_classes(classes, cfg.batch_rows)))
    return total


def _cli_fused(preset: str = "ml100k", device: str = "cuda") -> tuple:
    """The CLI with --solver=fused (hot_width "auto" is 0): the variant
    without the hot head. Returns (launches, test AUC)."""
    from benchmarks.datagen import PRESETS, generate, write_ratings
    from qmf_tpu_torch import WALSConfig
    from qmf_tpu_torch.cli import wals as cli
    from qmf_tpu_torch.ops import build_solve, spd_solve

    train, test = _split(*generate(**PRESETS[preset], seed=SEED))
    cfg = WALSConfig(solver="fused")
    expect = _n_chunks(train, cfg) * cfg.nepochs
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
    if counts != (expect, 0, 0):
        raise AssertionError(f"CLI --solver=fused launches (build_solve, "
                             f"build_solve_hot, chol_solve) = {counts}, "
                             f"expected ({expect}, 0, 0)")
    if not auc > 0.5:
        raise AssertionError(f"CLI --solver=fused test AUC {auc} <= 0.5")
    return counts[0], auc


def _half_epoch_ms(paths: dict) -> dict:
    """Median ms of the user and item half-epochs (als_ops._solve_side on
    an engine's classes and trained factors) of each path, name ->
    (engine, solver), the paths taking turns."""
    from qmf_tpu_torch.ops import als_ops

    fns = {}
    for name, (engine, solver) in paths.items():
        cfg = engine.config
        for side in ("user", "item"):
            classes, chunks, hot, y, n = _side(engine, side)
            fns[f"{name}_{side}"] = (
                lambda y=y, c=classes, ch=chunks, n=n, hot=hot, s=solver,
                cfg=cfg: als_ops._solve_side(
                    y, c, ch, n, cfg.confidence_weight,
                    cfg.regularization_lambda, s, cfg.matmul_precision, hot))
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
    """Phase 6: solver="fused" through the CLI (ml100k, no hot head), then
    WALSEngine at ml20m, k = 64, hot_width = 1024, on phase 4's data; then
    its item classes, and the half-epochs of the split path and the fused
    path without the hot head (both on phase 4's engine) and with it."""
    import numpy as np
    import torch

    from qmf_tpu_torch import MetricsConfig, WALSConfig
    from qmf_tpu_torch.metrics import MetricsEngine
    from qmf_tpu_torch.models import WALSEngine
    from qmf_tpu_torch.ops import build_solve, spd_solve

    t0 = time.time()
    cli_launches, cli_auc = _cli_fused(device=device)
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
    engine.progress_cb = lambda e, loss, dt: epochs.append((e, loss, dt))
    chunks = sum(-(-c[1].shape[0] // ch) for c, ch in zip(
        engine._user_classes + engine._item_classes,
        engine._user_chunks + engine._item_chunks))
    build_solve.launches = build_solve.launches_hot = 0
    spd_solve.launches = 0
    engine.optimize()
    counts = (build_solve.launches, build_solve.launches_hot,
              spd_solve.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [loss for _, loss, _ in epochs]
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
    half = _half_epoch_ms({"split": (split_engine, "kernel"),
                           "fused": (split_engine, "fused"),
                           "fused_hot": (engine, "fused")})
    _line("6 fused", t0, cli_preset="ml100k", cli_launches=cli_launches,
          cli_test_auc=cli_auc, users=engine.nusers, items=engine.nitems,
          k=K_MAIN, hot_width=HOT_WIDTH, init_s=round(t_init, 3),
          epoch_s=[round(dt, 4) for _, _, dt in epochs],
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
            "max_abs_err": err, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound_ms, "bound_by": bound_by}


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


def main() -> int:
    import torch

    card()
    build()
    timing = kernel_check()
    cli_path()
    data, t_data = ml20m_data()
    main_path = model_scale(data, t_data)
    split_engine = main_path.pop("engine")
    profile_split_user(split_engine)
    fused_timing = fused_kernel_check(split_engine)
    torch.cuda.empty_cache()
    fused = fused_path(data, main_path, split_engine)
    source = "qmf_tpu_torch/csrc/build_solve.cu"
    print(json.dumps({"kernels": [{
        "name": "chol_solve",
        "route": "cuda",
        "source": "qmf_tpu_torch/csrc/chol_solve.cu",
        "replaces": "qmf_tpu/ops/pallas_solve.py:155",
        "launches": main_path["launches"],
        "max_abs_err": main_path["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }, {
        "name": "build_solve",
        "route": "cuda",
        "source": source,
        "replaces": "qmf_tpu/ops/pallas_solve.py:502",
        "launches": fused["cli_launches"],
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
