"""Fit the hot/cold build cost model of ops/hot.py on a CUDA card.

    python -m qmf_tpu_torch.tools.hot_micro [--reps 7] [--k 64] [--check_k 30]

The port's counterpart of benchmarks/hot_micro.py, which fitted qmf_tpu's
constants on a TPU. Data: tools.datagen's ml20m preset (seed 42) less
chip_smoke.py's 10% test hold-out, so the training split of its phases 4
and 14; WALSConfig(nfactors=k, matmul_precision="default",
batch_rows=8192), the hot weights stored in bf16.

For each side and each H of {0, 256, ..., 8192}, up to the rule's W budget
(2 x n_rows x H x 2 bytes <= 2 GiB, and H <= the fixed side's columns), an
engine packs the side with H forced. For each build (split: solver
"kernel", als_ops._build_bucket; fused: csrc/build_solve.cu) the side's
half-epoch
(``als_ops._solve_side``, against the other side's factors after one split
half-epoch from the seeded start) is captured as a CUDA graph, as the
engine runs its epochs (fuse_epoch), and its replays are timed with CUDA
events, the H values of a side taking turns: the median of ``--reps``.

Then, for each build, over both sides' points at k, least squares of qmf_tpu's
regressors (ops/hot.py ``cost_terms``), with one intercept for each side
(the solve, the scatter and the loss, which H does not change):

    t(H) = t0[side] + c * (nnz - coverage(H)) / fill
           + n_rows * H * (k^2 + k) * 2 / F

which gives c (ns for each modeled row) and F (FLOP/s). It prints every
point beside the fit, the residuals, and for each build and side the rule's
pick with each build's (c, F) beside the fastest measured H; then the same
picks at ``--check_k`` (the CLIs' k = 30) beside the times measured there,
with no second fit. The card's name and power limit come first, and the
last line is one JSON object with all of it. There is no CPU path.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from qmf_tpu_torch.ops import als_ops, graphs
from qmf_tpu_torch.ops import hot as hot_ops
from qmf_tpu_torch.tools.gather_micro import card_line, median_ms

SEED = 42
SOLVERS = {"split": "kernel", "fused": "fused"}  # a solver of each build
SIDES = ("user", "item")


def ml20m_train():
    """The ml20m preset, seed 42, less chip_smoke.py's 10% test hold-out."""
    from qmf_tpu_torch.tools.datagen import PRESETS, generate

    from qmf_tpu_torch.data import Dataset

    users, items, values = generate(**PRESETS["ml20m"], seed=SEED)
    test = np.random.default_rng(SEED).random(len(users)) < 0.1
    return Dataset(users[~test], items[~test], values[~test])


def side_demand(dataset) -> dict:
    """side -> (the fixed side's column degrees, rows the side builds), as
    WALSEngine.init hands them to the rule."""
    _, rows = np.unique(dataset.user_ids, return_inverse=True)
    _, cols = np.unique(dataset.item_ids, return_inverse=True)
    deg_u, deg_i = np.bincount(rows), np.bincount(cols)
    return {"user": (deg_i, int((deg_u > 0).sum())),
            "item": (deg_u, int((deg_i > 0).sum()))}


def candidates(col_degrees: np.ndarray, n_rows: int,
               store_bytes: int = 2) -> list:
    """0 and the rule's candidate widths up to where it stops: H beyond the
    fixed side's columns or W past its budget."""
    out = [0]
    for h in hot_ops._AUTO_CANDIDATES:
        if (h > len(col_degrees)
                or 2 * n_rows * h * store_bytes > hot_ops._W_BUDGET_BYTES):
            break
        out.append(h)
    return out


def forced_engine(dataset, config, widths: dict, device="cuda"):
    """A WALSEngine on ``dataset`` whose sides take ``widths`` (side -> H)
    in place of what ``config.hot_width`` resolves to."""
    from qmf_tpu_torch.models import WALSEngine

    class Forced(WALSEngine):
        def _resolve_hot_width(self, col_degrees, n_build_rows):
            return next(order)  # init resolves the user side first

    order = iter(widths[side] for side in SIDES)
    engine = Forced(config, device=device)
    engine.init(dataset)
    return engine


def engines_at(dataset, config, widths: dict, device="cuda") -> dict:
    """side -> {H: engine packed with H on that side} for the widths of
    ``widths`` (side -> list of H), as few engines as the longer list:
    engine j holds the j-th width of each side (0 past a list's end)."""
    out = {side: {} for side in SIDES}
    for j in range(max(len(w) for w in widths.values())):
        pair = {side: widths[side][j] if j < len(widths[side]) else 0
                for side in SIDES}
        engine = forced_engine(dataset, config, pair, device)
        for side in SIDES:
            if j < len(widths[side]):
                out[side][pair[side]] = engine
    return out


def side_arrays(engine, side: str) -> tuple:
    """(classes, chunks, hot state, rows) of one side of an engine."""
    return (getattr(engine, f"_{side}_classes"),
            getattr(engine, f"_{side}_chunks"),
            getattr(engine, f"_{side}_hot"),
            engine.nusers if side == "user" else engine.nitems)


def half_epoch_ms(engines: dict, side: str, build: str, y: torch.Tensor,
                  reps: int) -> dict:
    """H -> median ms of the side's half-epoch replayed as a CUDA graph,
    for each engine of ``engines`` (H -> engine), the H values taking
    turns. ``y`` is the fixed side's factors."""
    fns = {}
    for h, engine in engines.items():
        cfg = engine.config
        classes, chunks, hot, n = side_arrays(engine, side)
        graph = graphs.EpochGraph(
            lambda y, c=classes, ch=chunks, hot=hot, n=n, cfg=cfg:
            als_ops._solve_side(y, c, ch, n, cfg.confidence_weight,
                                cfg.regularization_lambda, SOLVERS[build],
                                cfg.matmul_precision, hot))
        graph(y)  # the warm-up and the capture
        fns[h] = lambda g=graph: g.replay(y)
    ms = median_ms(fns, y.device, rounds=reps, calls=1)
    del fns
    torch.cuda.empty_cache()
    return ms


def fit(points: list, k: int, demand: dict) -> dict:
    """Least squares of t(H) = t0[side] + c rows(H) + flops(H) / F over
    ``points`` [(side, H, ms)]: {"ns_per_row", "flops", "t0_ms",
    "residual_ms", "rms_ms"}."""
    x, t = [], []
    for side, h, ms in points:
        rows, flops = hot_ops.cost_terms(*demand[side], k, h)
        x.append([side == "user", side == "item", rows, flops])
        t.append(ms * 1e-3)
    x, t = np.asarray(x, np.float64), np.asarray(t)
    scale = np.abs(x).max(axis=0)
    scale[scale == 0] = 1.0
    theta = np.linalg.lstsq(x / scale, t, rcond=None)[0] / scale
    resid = (x @ theta - t) * 1e3
    return {"ns_per_row": float(theta[2] * 1e9),
            "flops": float(1.0 / theta[3]) if theta[3] > 0 else float("inf"),
            "t0_ms": {"user": float(theta[0] * 1e3),
                      "item": float(theta[1] * 1e3)},
            "residual_ms": [round(float(r), 4) for r in resid],
            "rms_ms": float(np.sqrt(np.mean(resid ** 2)))}


def model_ms(f: dict, side: str, demand: dict, k: int, h: int) -> float:
    """The fitted model's half-epoch ms of one side at H."""
    rows, flops = hot_ops.cost_terms(*demand[side], k, h)
    return f["t0_ms"][side] + 1e3 * (rows * f["ns_per_row"] * 1e-9
                                     + flops / f["flops"])


def pick(demand: dict, side: str, k: int, ns: float, flops: float) -> int:
    """The rule's H for one side with constants (ns, flops), bf16 store."""
    return hot_ops.auto_hot_width(*demand[side], k, store_bytes=2,
                                  gather_ns_per_row=ns, gemm_flops=flops)


def measure(dataset, demand: dict, k: int, reps: int) -> dict:
    """build -> side -> {H: median ms} at k, every candidate H."""
    from qmf_tpu_torch import WALSConfig

    cfg = WALSConfig(nfactors=k, matmul_precision="default",
                     batch_rows=8192)
    widths = {side: candidates(*demand[side]) for side in SIDES}
    engines = engines_at(dataset, cfg, widths)
    base = engines["user"][0]
    # the fixed sides: the seeded item start, and the users one split
    # half-epoch makes of it
    y = {"user": base.item_factors}
    y["item"] = als_ops._solve_side(
        base.item_factors, *side_arrays(base, "user")[:2], base.nusers,
        cfg.confidence_weight, cfg.regularization_lambda, "kernel",
        cfg.matmul_precision, None)[0]
    out = {build: {side: half_epoch_ms(engines[side], side, build, y[side],
                                       reps)
                   for side in SIDES} for build in SOLVERS}
    del engines, base, y
    torch.cuda.empty_cache()
    return out


def picks(demand: dict, k: int, times: dict, costs: dict) -> dict:
    """build -> side -> the rule's pick under each build's constants, the
    fastest measured H, and their ms."""
    out = {}
    for build, sides in times.items():
        out[build] = {}
        for side, ms in sides.items():
            best = min(ms, key=ms.get)
            row = {"fastest_h": best, "fastest_ms": round(ms[best], 4),
                   "h0_ms": round(ms[0], 4)}
            for name, (ns, flops) in costs.items():
                h = pick(demand, side, k, ns, flops)
                row[f"pick_{name}_constants"] = h
                row[f"pick_{name}_constants_ms"] = (
                    round(ms[h], 4) if h in ms else None)
            out[build][side] = row
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=7)
    p.add_argument("--k", type=int, default=64)
    p.add_argument("--check_k", type=int, default=30)
    args = p.parse_args(argv)
    if args.reps < 5:
        p.error("--reps must be at least 5")
    if not torch.cuda.is_available():
        print("hot_micro: no CUDA device; the fit is a measurement of the "
              "card", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}", flush=True)
    dataset = ml20m_train()
    demand = side_demand(dataset)
    result = {"card": card, "reps": args.reps, "k": args.k,
              "ratings": len(dataset),
              "rows": {s: demand[s][1] for s in SIDES}}
    times = measure(dataset, demand, args.k, args.reps)
    fits = {}
    for build, sides in times.items():
        points = [(side, h, ms) for side, hs in sides.items()
                  for h, ms in hs.items()]
        fits[build] = fit(points, args.k, demand)
        f = fits[build]
        print(f"fit {build} k={args.k}: c={f['ns_per_row']:.4f} ns/row "
              f"F={f['flops'] / 1e12:.3f} TFLOP/s t0={f['t0_ms']} ms "
              f"rms={f['rms_ms']:.4f} ms", flush=True)
        for (side, h, ms), r in zip(points, f["residual_ms"]):
            print(f"  {build} {side} H={h}: measured {ms:.4f} ms, model "
                  f"{model_ms(f, side, demand, args.k, h):.4f} ms, "
                  f"residual {r:+.4f} ms", flush=True)
    costs = {b: (f["ns_per_row"], f["flops"]) for b, f in fits.items()}
    result["times_ms"] = {b: {s: {str(h): round(t, 4) for h, t in hs.items()}
                              for s, hs in sides.items()}
                          for b, sides in times.items()}
    result["fit"] = fits
    result["picks"] = picks(demand, args.k, times, costs)
    for build, sides in result["picks"].items():
        print(f"picks k={args.k} {build}: {sides}", flush=True)
    if args.check_k:
        check = measure(dataset, demand, args.check_k, args.reps)
        result["check_k"] = args.check_k
        result["check_times_ms"] = {
            b: {s: {str(h): round(t, 4) for h, t in hs.items()}
                for s, hs in sides.items()} for b, sides in check.items()}
        result["check_picks"] = picks(demand, args.check_k, check, costs)
        for build, sides in result["check_picks"].items():
            print(f"picks k={args.check_k} {build}: {sides}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
