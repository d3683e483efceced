#!/usr/bin/env python3
"""Smoke run of the PyTorch port (qmf_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one NVIDIA H100 (sm_90a),
PyTorch built for CUDA and nvcc. It imports no jax. Phases, one line each:

0. the card: name and power limit (nvidia-smi), torch and CUDA versions;
1. build the CUDA kernels from csrc/ (nvcc, sm_90a);
2. the kernel against its plain PyTorch version, f32 and f64, both layouts,
   k in {8, 16, 30, 64, 128} x B in {1, 13, 4097}; non-SPD rows give NaN;
   then both timed at the ml20m user side's shape (B = 138,493, k = 64);
3. the CLI main path at ml100k scale with CLI defaults (k = 30): launch
   count, factor files, test AUC, and the factors against a plain-cholesky
   run on the card;
4. the WALSEngine at ml20m scale and k = 64, 3 epochs: epoch times and
   losses, AUC, launch count, peak memory; then the kernel against the
   plain version on that run's largest width class.

Then a JSON line describing each kernel, and as the last line
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


def kernel_check(ks=(8, 16, 30, 64, 128), batches=(1, 13, 4097)) -> dict:
    """Phase 2: kernel vs plain on the card, then both timed."""
    import torch

    from qmf_tpu_torch.ops import spd_solve

    t0 = time.time()
    dev = torch.device("cuda")
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    cases = 0
    for k in ks:
        for bsz in batches:
            a64, b64 = _spd_np(bsz, k, seed=1000 * k + bsz)
            for dtype in (torch.float32, torch.float64):
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
    # non-SPD rows: non-finite in both versions, the others untouched
    a64, b64 = _spd_np(8, 30, seed=7)
    a64[[2, 5]] *= -1.0
    for dtype in (torch.float32, torch.float64):
        a = torch.as_tensor(a64, dtype=dtype, device=dev)
        b = torch.as_tensor(b64, dtype=dtype, device=dev)
        for x in (spd_solve.solve_spd(a, b),
                  spd_solve.solve_spd_reference(a, b)):
            bad = ~torch.isfinite(x).all(dim=1)
            if bad.tolist() != [i in (2, 5) for i in range(8)]:
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
    big_err, scaled = _normwise_err(spd_solve.solve_spd(a, b),
                                    spd_solve.solve_spd_reference(a, b))
    if not scaled <= F32_TOL:
        raise AssertionError(f"B={ML20M_USERS} k=64 f32: err {big_err}")
    del a, b
    torch.cuda.empty_cache()
    _line("2 kernel", t0, cases=cases,
          max_abs_err_f32=worst[torch.float32],
          max_abs_err_f64=worst[torch.float64],
          timed_shape=f"({ML20M_USERS},{K_MAIN},{K_MAIN})f32",
          kernel_ms=ms, kernel_t_layout_ms=t_ms, plain_ms=plain_ms, timed_max_abs_err=big_err)
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err_f32": worst[torch.float32]}


def _split(users, items, values, seed=SEED):
    """10% of the ratings, picked by a seeded RNG, held out as test."""
    import numpy as np

    from qmf_tpu.data.dataset import Dataset

    test = np.random.default_rng(seed).random(len(users)) < 0.1
    return (Dataset(users[~test], items[~test], values[~test]),
            Dataset(users[test], items[test], values[test]))


def _n_classes(dataset, cfg) -> int:
    """Width classes of both sides, packed as WALSEngine.init packs them."""
    from qmf_tpu.data.id_index import IdIndex
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

    from qmf_tpu.data import load_factors
    from qmf_tpu.data.id_index import IdIndex
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


def model_scale(preset: str = "ml20m", device: str = "cuda",
                nepochs: int = 3) -> dict:
    """Phase 4: WALSEngine at ml20m scale, k = 64, through the kernel."""
    import numpy as np
    import torch

    from benchmarks.datagen import PRESETS, generate
    from qmf_tpu.config import MetricsConfig
    from qmf_tpu_torch import WALSConfig
    from qmf_tpu_torch.metrics import MetricsEngine
    from qmf_tpu_torch.models import WALSEngine
    from qmf_tpu_torch.ops import als_ops, spd_solve

    t0 = time.time()
    train, test = _split(*generate(**PRESETS[preset], seed=SEED))
    t_data = time.time() - t0
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
          classes=n_classes, launches=launches, peak_bytes=peak,
          class_rows=a.shape[0], class_max_abs_err=err, class_normwise_err=scaled,
          class_max_abs_x=scale)
    return {"launches": launches, "max_abs_err": err}


def main() -> int:
    import torch

    card()
    build()
    timing = kernel_check()
    cli_path()
    main_path = model_scale()
    print(json.dumps({"kernels": [{
        "name": "chol_solve",
        "route": "cuda",
        "source": "qmf_tpu_torch/csrc/chol_solve.cu",
        "replaces": "qmf_tpu/ops/pallas_solve.py:155",
        "launches": main_path["launches"],
        "max_abs_err": main_path["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
