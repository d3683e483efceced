"""Where a WALS epoch's time goes, at the production defaults, on a card.

    python -m qmf_tpu_torch.tools.epoch_decomp [hot_width] [--solver=auto]
        [--device=cuda]

The port's counterpart of benchmarks/epoch_decomp.py. One engine at ml20m
(``tools.datagen``, seed 42), k = 64, with the defaults (device pack,
``solver="auto"``, precision "default", batch_rows 8192) and ``hot_width``
"auto" (the default), "0" or an int forced on both sides. It times:

- the full epoch: the engine's epoch program (a replay of the captured
  CUDA graph on a card), the median of REPS;
- for each side, the build with the hot GEMMs: ``als_ops._build_chunked``
  for each width class with the class's hot state, (A, b) materialized
  (the counterpart of qmf_tpu's ``_scan_class_build``); the hot tables
  are made inside it, the Gramian outside;
- for each side with a hot head, the same build with the head off on the
  same cold stream (it isolates the hot GEMMs; it is not an unsplit
  build);
- for each side, the solve of the materialized (A, b) by the engine's
  resolved solver, one call a class as the engine makes it (the
  counterpart of ``_solve_dispatch``);
- the remainder: the epoch less the sum of the above, which is the
  Gramian, the scatter, the loss and the launch gaps.

Under solver "fused" the build and the solve are one kernel
(csrc/build_solve.cu): each side's ``_fused_class`` calls are timed with
and without the hot head in place of the separate build and solve, and
the output says so.

On a card each part is captured as a CUDA graph, as the epoch is, and
its replays are timed with CUDA events around REPS replays after one
warm-up: the mean a replay (the host's clock around eager calls on the
CPU). The epoch is the median of REPS single replays. The engine takes the
warm-up epoch's factors and every part runs against them. The card's name and power
limit come first and a JSON line of the parts comes last. Without a CUDA
device and without ``--device=cpu`` it exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from qmf_tpu_torch.ops import als_ops, graphs

REPS = 5
SIDES = ("user", "item")


def _timed_ms(fn, device: torch.device, reps: int) -> float:
    """Mean ms of one call of ``fn`` over ``reps`` calls back to back,
    after one warm-up call: CUDA events on a card, the host's clock on the
    CPU."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def _replayable(fn, device: torch.device):
    """``fn`` as the epoch runs it: on a card captured as a CUDA graph
    (graphs.EpochGraph: its first call the warm-up and the capture) and
    replayed, so that the part is paced by the device as the replayed epoch
    is, not by the host's launches; on the CPU ``fn`` itself. ``fn`` reads
    its tensors where they lie; the graph's one input is a placeholder."""
    if device.type != "cuda":
        return fn
    token = torch.zeros(1, device=device)
    graph = graphs.EpochGraph(lambda _: fn())
    graph(token)
    return lambda: graph.replay(token)


def _part_ms(fn, device: torch.device, reps: int) -> float:
    """Mean ms of one replay of ``fn`` captured (:func:`_replayable`)."""
    return _timed_ms(_replayable(fn, device), device, reps)


def _epoch_ms(engine, reps: int) -> list:
    """``reps`` samples of one call of the engine's epoch program on its
    item factors, in ms, after one warm-up call (on a card the capture),
    whose factors the engine takes."""
    program = engine._epoch_program()
    u, v, _ = program(engine.item_factors)
    engine._own(u, v)
    v = engine.item_factors
    return [_timed_ms(lambda: program(v), engine.device, 1)
            for _ in range(reps)]


def side_state(engine, side: str) -> tuple:
    """(classes, chunks, hot state, the fixed side's factors, rows of the
    fixed side) of one side."""
    if side == "user":
        return (engine._user_classes, engine._user_chunks, engine._user_hot,
                engine.item_factors, engine.nitems)
    return (engine._item_classes, engine._item_chunks, engine._item_hot,
            engine.user_factors, engine.nusers)


def _hot_tables(hot, y, precision: str, upcast: bool) -> tuple:
    """(per-class hot arrays, y_hot, Z) of a side as ``_solve_side`` makes
    them; Nones without a hot state. ``upcast`` as the split build runs."""
    if hot is None:
        return None, None, None
    hot_ids, hot_classes = hot
    y_hot, z = als_ops.hot_tables(y[hot_ids], precision)
    if upcast:
        y_hot, z = y_hot.to(y.dtype), z.to(y.dtype)
    return hot_classes, y_hot, z


def split_setup(engine, side: str, hot: bool = True, yty=None) -> tuple:
    """What the split build of one side shares between its classes, against
    the engine's current factors: (the fixed side's real rows, their
    Gramian (computed here if ``yty`` is None), the side's per-class hot
    arrays, y_hot, Z), the hot tables upcast as the split build runs them,
    or Nones without a hot head (``hot`` False: the cold stream alone)."""
    _, _, hot_state, y, n_fixed = side_state(engine, side)
    y = y[:n_fixed]
    if yty is None:
        yty = als_ops.gramian(y)
    return (y, yty, *_hot_tables(hot_state if hot else None, y,
                                 engine.config.matmul_precision, True))


def split_class(engine, side: str, i: int, setup: tuple) -> tuple:
    """Width class ``i`` of one side through the split build
    (``als_ops._build_chunked`` with the class's hot state from ``setup``,
    :func:`split_setup`): (A, b), materialized."""
    cfg = engine.config
    classes, chunks = side_state(engine, side)[:2]
    y, yty, hot_classes, y_hot, z = setup
    _, col, val, mask = classes[i]
    a, b, _ = als_ops._build_chunked(
        y, yty, col, val, mask, cfg.confidence_weight,
        cfg.regularization_lambda, cfg.matmul_precision, chunks[i],
        None if hot_classes is None else hot_classes[i], y_hot, z)
    return a, b


def side_build(engine, side: str, hot: bool = True, yty=None) -> list:
    """The split build of one side against the engine's current factors:
    [(A, b)] a width class, A and b materialized, with the class's hot
    state (``hot``) or on the cold stream alone. ``yty`` is the fixed
    side's Gramian (computed here if None)."""
    setup = split_setup(engine, side, hot, yty)
    return [split_class(engine, side, i, setup)
            for i in range(len(side_state(engine, side)[0]))]


def side_solve(engine, systems: list) -> list:
    """The engine's resolved solver on each class's (A, b): [x]."""
    return [als_ops._solve_dispatch(a, b, engine._solver)
            for a, b in systems]


def fused_setup(engine, side: str, hot: bool = True, yty=None) -> tuple:
    """What solver "fused" shares between one side's classes: (the fixed
    side in the stream's dtype, YtY + lambda I, the side's per-class hot
    arrays, y_hot), the hot arrays None without a hot head (``hot``
    False)."""
    cfg = engine.config
    _, _, hot_state, y, n_fixed = side_state(engine, side)
    y = y[:n_fixed]
    if yty is None:
        yty = als_ops.gramian(y)
    k = y.shape[1]
    ytyl = yty + cfg.regularization_lambda * torch.eye(
        k, dtype=y.dtype, device=y.device)
    y_s = (y.to(torch.bfloat16) if cfg.matmul_precision == "default"
           and y.dtype == torch.float32 else y)
    hot_classes, y_hot, _ = _hot_tables(hot_state if hot else None, y,
                                        cfg.matmul_precision, False)
    return y_s, ytyl, hot_classes, y_hot


def fused_class(engine, side: str, i: int, setup: tuple) -> tuple:
    """Width class ``i`` of one side under solver "fused":
    ``als_ops._fused_class`` (gather, build, factor and solve in
    build_solve.cu a chunk) with the class's hot head from ``setup``
    (:func:`fused_setup`): (x, row loss)."""
    cfg = engine.config
    classes, chunks = side_state(engine, side)[:2]
    y_s, ytyl, hot_classes, y_hot = setup
    _, col, val, mask = classes[i]
    return als_ops._fused_class(
        y_s, ytyl, col, val, mask, cfg.confidence_weight,
        cfg.regularization_lambda, chunks[i],
        None if hot_classes is None else hot_classes[i], y_hot)


def side_fused(engine, side: str, hot: bool = True, yty=None) -> list:
    """Solver "fused" on one side: each class's ``_fused_class`` (gather,
    build, factor and solve in build_solve.cu a chunk), with the class's
    hot head (``hot``) or on the cold stream alone: [(x, row loss)]."""
    setup = fused_setup(engine, side, hot, yty)
    return [fused_class(engine, side, i, setup)
            for i in range(len(side_state(engine, side)[0]))]


def decompose(engine, reps: int = REPS) -> dict:
    """The parts of one epoch of an initialized engine, in ms (see the
    module's docstring): ``epoch_ms`` (median) and ``epoch_ms_each``; per
    side ``{side}_build_hot_ms`` (``{side}_build_ms`` without a hot head),
    ``{side}_build_cold_ms`` (with one) and ``{side}_solve_ms``, or under
    "fused" ``{side}_build_solve_hot_ms`` / ``{side}_build_solve_ms`` and
    ``{side}_build_solve_cold_ms``; ``remainder_ms``; and ``solver``,
    ``hot_widths``, ``rows`` a side, ``mode`` ("split" or "fused"). The
    engine keeps the factors of the warm-up epoch; every side is timed
    against them."""
    device = engine.device
    fused = engine._solver == "fused"
    each = _epoch_ms(engine, reps)
    out = {"solver": engine._solver, "mode": "fused" if fused else "split",
           "hot_widths": dict(engine.hot_widths),
           "rows": {"user": engine.nusers, "item": engine.nitems},
           "epoch_ms": statistics.median(each), "epoch_ms_each": each}
    build = side_fused if fused else side_build
    name = "build_solve" if fused else "build"
    parts = 0.0
    for side in SIDES:
        _, _, hot_state, y, n_fixed = side_state(engine, side)
        yty = als_ops.gramian(y[:n_fixed])
        suffix = "" if hot_state is None else "_hot"
        ms = _part_ms(lambda: build(engine, side, True, yty), device, reps)
        out[f"{side}_{name}{suffix}_ms"] = ms
        parts += ms
        if hot_state is not None:
            out[f"{side}_{name}_cold_ms"] = _part_ms(
                lambda: build(engine, side, False, yty), device, reps)
        if not fused:
            systems = side_build(engine, side, True, yty)
            ms = _part_ms(lambda: side_solve(engine, systems), device, reps)
            out[f"{side}_solve_ms"] = ms
            parts += ms
            del systems
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out["remainder_ms"] = out["epoch_ms"] - parts
    return out


def report(parts: dict) -> str:
    """The parts as lines of text."""
    lines = [f"solver {parts['solver']} ({parts['mode']}), hot widths "
             f"{parts['hot_widths']}, rows {parts['rows']}",
             f"FULL epoch (program): {parts['epoch_ms']:.3f} ms (median of "
             f"{[round(x, 3) for x in parts['epoch_ms_each']]})"]
    for key, ms in parts.items():
        if key.startswith(SIDES) and key.endswith("_ms"):
            lines.append(f"{key[:-3]}: {ms:.3f} ms")
    if parts["mode"] == "fused":
        lines.append("(solver fused: build and solve are one kernel, "
                     "build_solve.cu; timed together a side)")
    lines.append(f"remainder (Gramian, scatter, loss, gaps): "
                 f"{parts['remainder_ms']:.3f} ms")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("hot_width", nargs="?", default="auto",
                    help='"auto" (default), "0", or an int on both sides')
    ap.add_argument("--solver", default="auto")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("epoch_decomp: no CUDA device; --device=cpu times the plain "
              "versions on the host's clock", file=sys.stderr)
        return 2
    from qmf_tpu_torch import WALSConfig
    from qmf_tpu_torch.models import WALSEngine
    from qmf_tpu_torch.tools.bench import card_info, load_data

    if device.type == "cuda":
        print(f"card: {card_info()['line']}", flush=True)
    _, dataset = load_data("ml20m")
    hot_width = args.hot_width if args.hot_width == "auto" \
        else int(args.hot_width)
    cfg = WALSConfig(nepochs=1, nfactors=64, init_seed=0,
                     matmul_precision="default", batch_rows=8192,
                     hot_width=hot_width, solver=args.solver)
    engine = WALSEngine(cfg, device=device)
    t0 = time.perf_counter()
    engine.init(dataset)
    print(f"init {time.perf_counter() - t0:.1f}s solver={engine._solver}",
          flush=True)
    parts = decompose(engine)
    print(report(parts), flush=True)
    print(json.dumps(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
