"""The WALS build's time by width class, on a card.

    python -m qmf_tpu_torch.tools.build_attrib [--hot_width=auto]
        [--preset=ml20m] [--device=cuda]

The port's counterpart of benchmarks/build_attrib.py, whose ``per_class``
timed qmf_tpu's ``_scan_class_build`` class by class. One ``WALSEngine`` on
the preset (``tools.datagen``, seed 42, all ratings) at k = 64 with the
defaults tools/epoch_decomp.py uses (device pack, precision "default",
``batch_rows`` 8192) at the widths ``--hot_width`` resolves to, and, where
they are not 0, the same data packed again at H = 0 on both sides
(tools/hot_micro.forced_engine) holding the first engine's factors.

:func:`attribute` gives, for each side and each width class: D, N,
``chunk_b`` and the chunks, the padded elements N·D and the side's H;
``split_ms``, the class's ``als_ops._build_chunked`` with its hot state,
(A, b) materialized (tools/epoch_decomp.py ``split_class``: the
counterpart of qmf_tpu's ``_scan_class_build``); ``fused_ms``, the class's
``als_ops._fused_class`` (build_solve.cu a chunk; ``fused_class``); where
H > 0 each again on the cold stream alone (``split_cold_ms``,
``fused_cold_ms``); ns per padded element; and the class's operations
(2·N·D·k² for A, plus 2·N·H·(k² + k) for the hot head's two GEMMs on the
paths that run them) with the TFLOP/s each path reaches. Per side, each
path's sum over the classes. The hot tables and the Gramian are made once a
side, outside the classes' times.

On a card each class's part is captured as a CUDA graph and replayed
(tools/epoch_decomp.py ``_part_ms``: CUDA events around ``reps`` replays
after one warm-up). ``main`` prints beside each engine's sums
``epoch_decomp.decompose``'s side parts on the same engine. The card's name
and power limit come first and a JSON line last. Without a CUDA device and
without ``--device=cpu`` it exits nonzero; ``--device=cpu`` runs the plain
versions on the host's clock.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from qmf_tpu_torch.ops import als_ops
from qmf_tpu_torch.tools import epoch_decomp
from qmf_tpu_torch.tools.epoch_decomp import SIDES, _part_ms, side_state

REPS = 5
PATHS = ("split", "split_cold", "fused", "fused_cold")


def wals_config(hot_width="auto"):
    """tools/epoch_decomp.py's configuration at ``hot_width``."""
    from qmf_tpu_torch import WALSConfig

    return WALSConfig(nepochs=1, nfactors=64, init_seed=0,
                      matmul_precision="default", batch_rows=8192,
                      hot_width=hot_width)


def h0_engine(engine, dataset, device):
    """``engine``'s configuration and factors on ``dataset`` packed with
    H = 0 on both sides; ``engine`` itself where its widths are 0."""
    from qmf_tpu_torch.tools import hot_micro

    if not any(engine.hot_widths.values()):
        return engine
    h0 = hot_micro.forced_engine(dataset, engine.config,
                                 {"user": 0, "item": 0}, device)
    h0.load_factors(engine.user_factors, engine.item_factors)
    return h0


def class_flops(n: int, d: int, k: int, h: int) -> dict:
    """Operations of one class's build on each path: 2·N·D·k² for A from
    the stream, and on the paths with the hot head 2·N·H·(k² + k) for its
    two GEMMs (w_a Z and w_b y_hot)."""
    cold = 2 * n * d * k * k
    hot = cold + 2 * n * h * (k * k + k)
    return {"split": hot, "split_cold": cold, "fused": hot,
            "fused_cold": cold}


def attribute(engine, reps: int = REPS) -> dict:
    """Each side's width classes, timed by path (see the module's
    docstring): ``{"hot_widths", "k", "sides": {side: {"classes": [...],
    "sums_ms": {path: ms}}}}``, the classes in the engine's order."""
    device = engine.device
    k = engine.config.nfactors
    out = {"hot_widths": dict(engine.hot_widths), "k": k, "sides": {}}
    for side in SIDES:
        classes, chunks, hot_state, y, n_fixed = side_state(engine, side)
        h = engine.hot_widths[side] if hot_state is not None else 0
        yty = als_ops.gramian(y[:n_fixed])
        setups = {"split": epoch_decomp.split_setup(engine, side, True, yty),
                  "fused": epoch_decomp.fused_setup(engine, side, True, yty)}
        if hot_state is not None:
            setups["split_cold"] = epoch_decomp.split_setup(
                engine, side, False, yty)
            setups["fused_cold"] = epoch_decomp.fused_setup(
                engine, side, False, yty)
        rows = []
        for i, ((_, col, _, _), chunk_b) in enumerate(zip(classes, chunks)):
            n, d = col.shape
            row = {"D": d, "N": n, "chunk_b": chunk_b,
                   "chunks": len(als_ops._chunks(n, chunk_b)),
                   "elements": n * d, "H": h}
            flops = class_flops(n, d, k, h)
            for path in PATHS:
                if path not in setups:
                    continue
                run = (epoch_decomp.fused_class if path.startswith("fused")
                       else epoch_decomp.split_class)
                ms = _part_ms(lambda: run(engine, side, i, setups[path]),
                              device, reps)
                row[f"{path}_ms"] = ms
                row[f"{path}_ns_per_element"] = ms * 1e6 / max(n * d, 1)
                row[f"{path}_flops"] = flops[path]
                row[f"{path}_tflops"] = flops[path] / ms * 1e-9
            rows.append(row)
        del setups
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out["sides"][side] = {
            "classes": rows,
            "sums_ms": {p: sum(r[f"{p}_ms"] for r in rows) for p in PATHS
                        if rows and f"{p}_ms" in rows[0]}}
    return out


def report(attrib: dict, decomp: dict | None = None) -> str:
    """The classes as lines of text, each side's sums last, beside
    ``decomp`` (epoch_decomp.decompose's parts of the same engine)."""
    lines = [f"hot widths {attrib['hot_widths']}, k {attrib['k']}"]
    for side, got in attrib["sides"].items():
        lines.append(f"{side} side (H = {attrib['hot_widths'][side]}):")
        for r in sorted(got["classes"], key=lambda r: (r["D"], r["N"])):
            paths = ", ".join(
                f"{p} {r[f'{p}_ms']:.3f} ms ({r[f'{p}_ns_per_element']:.3f} "
                f"ns/el, {r[f'{p}_tflops']:.2f} TF/s)"
                for p in PATHS if f"{p}_ms" in r)
            lines.append(f"  D={r['D']:6d} N={r['N']:6d} chunk="
                         f"{r['chunk_b']} x{r['chunks']} elems="
                         f"{r['elements'] / 1e6:.2f}M: {paths}")
        sums = ", ".join(f"{p} {ms:.3f}" for p, ms in got["sums_ms"].items())
        lines.append(f"  sum of classes (ms): {sums}")
        if decomp is not None:
            mine = {key: round(ms, 3) for key, ms in decomp.items()
                    if key.startswith(f"{side}_") and key.endswith("_ms")}
            lines.append(f"  epoch_decomp ({decomp['mode']}): {mine}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hot_width", default="auto",
                    help='"auto" (default), "0", or an int on both sides')
    ap.add_argument("--preset", default="ml20m")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("build_attrib: no CUDA device; --device=cpu times the plain "
              "versions on the host's clock", file=sys.stderr)
        return 2
    from qmf_tpu_torch.models import WALSEngine
    from qmf_tpu_torch.tools.bench import card_info, load_data

    card = None
    if device.type == "cuda":
        card = card_info()
        print(f"card: {card['line']}", flush=True)
    _, dataset = load_data(args.preset)
    hot_width = args.hot_width if args.hot_width == "auto" \
        else int(args.hot_width)
    engine = WALSEngine(wals_config(hot_width), device=device)
    t0 = time.perf_counter()
    engine.init(dataset)
    print(f"init {time.perf_counter() - t0:.1f}s hot widths "
          f"{engine.hot_widths}", flush=True)
    runs = []
    for eng in dict.fromkeys([engine, h0_engine(engine, dataset, device)]):
        attrib = attribute(eng)
        decomp = epoch_decomp.decompose(eng)
        print(report(attrib, decomp), flush=True)
        runs.append({"attribution": attrib, "decomposition": decomp})
    print(json.dumps({"preset": args.preset, "device": str(device),
                      "card": card, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
