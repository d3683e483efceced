"""Headline benchmarks of the port on a CUDA card: the ml20m WALS epoch
time (k = 64) and BPR real triplet updates a second (k = 30, 3 negatives).

    python -m qmf_tpu_torch.tools.bench [--device=cuda]

The port's counterpart of the repo's root ``bench.py``, whose protocol,
knobs and reference-baseline harness it copies (the root file drives
qmf_tpu on a TPU and is not imported). Prints one JSON line a metric on
stdout:

    {"metric": "ml20m_wals_epoch_time_k64_torch", "value": <s>, "unit": "s",
     "vs_baseline": ..., "device": {"name": ..., "power_limit_w": ...},
     "spread": ..., "epochs_s": [...], "loss": ..., "solver": ...,
     "hot_widths": {...}}
    {"metric": "ml20m_bpr_updates_per_s_torch", "value": <updates/s>,
     "unit": "updates/s", ..., "path": "grouped" | "stream"}

The names end in ``_torch`` so that no reader mixes them with the root
bench's TPU numbers. Everything else goes to stderr as ``#`` lines.

Knobs: the root bench's environment variables, names and defaults kept:
QMF_BENCH_PRESET (ml20m), _NFACTORS (64), _EPOCHS (7), _SPREAD_THRESHOLD
(0.15), _SPREAD_ROUNDS (4), _SPREAD_SLEEP_S (30), _PRECISION (default),
_BASELINE_REPS (3), _BPR_NFACTORS (30), _BPR_NUM_NEG (3), _BPR_BATCH
(32768), _WIDTH_GRID, _SOLVER, _MAX_CLASSES, _BATCH_ROWS (8192),
_SKIP_BPR ("1" skips BPR), _BPR_ITEM_SCATTER.

Protocol. The data is ``tools.datagen``'s preset (seed 42; the port's copy
of benchmarks/datagen.py) in memory.
WALS runs the engine's defaults (``solver="auto"``, ``hot_width="auto"``,
``fuse_epoch``: on a card each epoch is a replay of a captured CUDA graph):
``init``, one warm-up epoch (the capture; its seconds printed as the root
bench prints compile seconds), then steady epochs on the host's clock,
each ending in the loss read, the device sync. The spread guard is the
root bench's: rounds of QMF_BENCH_EPOCHS epochs, re-measured after a sleep
while (max - min) / median exceeds the threshold, the round of lowest
spread reported. BPR: ``init``, one warm-up epoch (the capture), then
steady epochs each ending in a scalar read of the user factors;
updates/s = real triplets / median epoch. After each engine's rounds one
more epoch runs under torch.profiler (not in the metric): the device's
busy share of its wall, the five kernels with the most device time, and
the peak memory since the timing began.

The FLOP estimate is the root bench's: 2 padded k^2 + 2 padded k + (U + I)
(k^3 / 3 + 2 k^2), padded being the width classes' padded entries (at a hot
width above 0 the cold stream's: the hot GEMMs are not counted, as there),
over the H100 SXM's dense bf16 peak (989 TFLOP/s) and, since the split
build multiplies in f32 (TF32 off), also its fp32 peak (67 TFLOP/s).

Reference baseline: the root bench's harness (benchmarks/reference_harness
/build.sh builds the reference C++ ``wals`` and ``bpr`` from ``REF``, the
reference's source; each is timed single-core at 2 epochs less 1 epoch,
median of QMF_BENCH_BASELINE_REPS, extrapolated by a perfect 16x thread
scaling). It runs only with ``REF`` set, writing its build, the ratings
file and its factor files under qmf_tpu_torch/_build/, and caches its
numbers in qmf_tpu_torch/_build/baseline_measured.json with the host's
name. ``vs_baseline`` is null unless the reference was timed on this host;
a ``#`` line says why.

``--device=cpu`` (for tests) runs the same steps on the CPU and prints no
metric line: one ``# cpu rehearsal: {json}`` line instead, so that no CPU
number appears under a device metric's name. Without a CUDA device and
without ``--device=cpu`` it exits nonzero; it never falls back.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
BUILD_DIR = os.path.join(PKG, "_build")
BASELINE_FILE = os.path.join(BUILD_DIR, "baseline_measured.json")
SEED = 42  # the datagen seed, as the root bench's data
# H100 SXM peaks (NVIDIA's data sheet): dense bf16 on the tensor cores,
# fp32 outside them
BF16_PEAK_FLOPS, FP32_PEAK_FLOPS = 989e12, 67e12
ASSUMED_REF_THREAD_SCALING = 16.0
TOP_KERNELS = 5


@dataclasses.dataclass
class Knobs:
    """The root bench's environment knobs (bench.py:36-60)."""

    preset: str = "ml20m"
    nfactors: int = 64
    epochs: int = 7
    spread_threshold: float = 0.15
    spread_rounds: int = 4
    spread_sleep_s: float = 30.0
    precision: str = "default"
    baseline_reps: int = 3
    bpr_nfactors: int = 30
    bpr_num_neg: int = 3
    bpr_batch: int = 32768
    width_grid: str = ""
    solver: str = ""
    max_classes: str = ""
    batch_rows: int = 8192
    skip_bpr: bool = False
    bpr_item_scatter: str = ""

    @classmethod
    def from_env(cls, env=None) -> "Knobs":
        env = os.environ if env is None else env

        def get(name, cast, default):
            raw = env.get(f"QMF_BENCH_{name.upper()}", "")
            return cast(raw) if raw != "" else default

        kw = {f.name: get(f.name, type(f.default), f.default)
              for f in dataclasses.fields(cls) if f.name != "skip_bpr"}
        return cls(**kw, skip_bpr=env.get("QMF_BENCH_SKIP_BPR", "") == "1")


def measure_steady(step, label: str, epochs: int, threshold: float,
                   rounds: int, sleep_s: float, clock=time.perf_counter,
                   sleep=time.sleep) -> dict:
    """Time ``epochs`` calls of ``step()`` (which must end in a wait for the
    device) a round, with the root bench's contention guard
    (bench.py:149-201): spread = (max - min) / median; above ``threshold``
    sleep ``sleep_s`` and measure again, up to ``rounds`` rounds, then take
    the round of lowest spread. Prints each round and the choice on stderr.
    Returns {"median", "spread", "times" (the round taken), "round" (its
    number, from 1), "rounds" (rounds taken)}."""
    best = None  # (spread, median, times, round)
    rnd = 0
    for rnd in range(1, rounds + 1):
        times = []
        for _ in range(epochs):
            t0 = clock()
            step()
            times.append(clock() - t0)
        med = float(np.median(times))
        spread = (max(times) - min(times)) / med if med > 0 else 0.0
        print(f"# {label} round {rnd}: {[f'{t:.4f}' for t in times]} "
              f"median {med:.4f}s min {min(times):.4f}s spread "
              f"{spread * 100:.1f}%", file=sys.stderr, flush=True)
        if best is None or spread < best[0]:
            best = (spread, med, times, rnd)
        if spread <= threshold:
            break
        if rnd < rounds:
            print(f"# {label}: spread {spread * 100:.1f}% > "
                  f"{threshold * 100:.0f}% (likely card/host contention); "
                  f"re-measuring in {sleep_s:.0f}s", file=sys.stderr,
                  flush=True)
            sleep(sleep_s)
    spread, med, times, chosen = best
    if spread > threshold:
        print(f"# {label}: WARNING all {rounds} rounds exceeded the "
              f"{threshold * 100:.0f}% spread threshold; reporting the "
              f"lowest-spread round (spread {spread * 100:.1f}%)",
              file=sys.stderr, flush=True)
    print(f"# {label} final: round {chosen} median {med:.4f}s min "
          f"{min(times):.4f}s spread {spread * 100:.1f}%", file=sys.stderr,
          flush=True)
    return {"median": med, "spread": spread, "times": times,
            "round": chosen, "rounds": rnd}


def epoch_flops(engine) -> tuple:
    """(FLOPs, padded entries) of one WALS epoch by the root bench's
    estimate (bench.py:323-331): per side the A build (2 padded k^2) and
    the b build (2 padded k), and a Cholesky solve a row ((U + I)
    (k^3 / 3 + 2 k^2)); ``padded`` is the width classes' col_idx entries
    of both sides."""
    padded = sum(int(c[1].numel()) for classes in (engine._user_classes,
                                                    engine._item_classes)
                 for c in classes)
    k = engine.config.nfactors
    n_rows = engine.nusers + engine.nitems
    flops = 2 * padded * k * k + 2 * padded * k + n_rows * (
        k**3 / 3 + 2 * k * k
    )
    return flops, padded


def card_info() -> dict:
    """{"name", "power_limit_w"} as nvidia-smi gives them."""
    from qmf_tpu_torch.tools.gather_micro import card_line

    line = card_line()
    name, _, power = line.rpartition(",")
    return {"name": name.strip(),
            "power_limit_w": float(power.strip().split()[0]),
            "line": line}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counts() -> dict:
    from qmf_tpu_torch import kernels

    return dict(zip(kernels.counter_names(), kernels.read_counters()))


def profile_epoch(fn, device: torch.device, top: int = TOP_KERNELS) -> dict:
    """One call of ``fn`` (an epoch) under torch.profiler: its wall ms, and
    on a card the device ms (the self time of every device event: kernels,
    copies), the busy share (device ms over wall ms) and the ``top`` events
    by device time; on the CPU the ``top`` host ops by their own CPU
    time, and no device numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    on_card = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    _sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    if on_card:
        def ms(e):
            return e.self_device_time_total / 1e3
        events = [e for e in events
                  if e.device_type == DeviceType.CUDA and ms(e) > 0]
    else:
        def ms(e):
            return e.self_cpu_time_total / 1e3
        events = [e for e in events if e.device_type == DeviceType.CPU]
    events = sorted(events, key=ms, reverse=True)
    out = {"wall_ms": wall_ms,
           "top": [[e.key[:80], round(ms(e), 4), e.count]
                   for e in events[:top]]}
    if on_card:
        if not events:
            raise AssertionError("the profile shows no device time")
        device_ms = sum(ms(e) for e in events)
        out.update(clock="device", device_ms=device_ms,
                   busy_share=device_ms / wall_ms,
                   device_events=sum(e.count for e in events))
    else:
        out.update(clock="host", device_ms=None, busy_share=None)
    return out


def _print_profile(label: str, prof: dict) -> None:
    if prof["clock"] == "device":
        print(f"# {label} profiled epoch: wall {prof['wall_ms']:.3f} ms, "
              f"device {prof['device_ms']:.3f} ms in "
              f"{prof['device_events']} events, busy "
              f"{prof['busy_share'] * 100:.2f}% of the wall",
              file=sys.stderr)
        what = "kernels by device ms"
    else:
        print(f"# {label} profiled epoch: wall {prof['wall_ms']:.3f} ms "
              f"(host clock, cpu; no device)", file=sys.stderr)
        what = "host ops by self cpu ms"
    for name, ms, n in prof["top"]:
        print(f"# {label}   top {what}: {ms:.4f} ms / {n} calls  {name}",
              file=sys.stderr)
    sys.stderr.flush()


def _peak_bytes(device: torch.device):
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)


def _reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


# --- the reference baseline (bench.py:63-147, 243-256) ----------------------
def _timed_reps(args, reps: int) -> tuple:
    """Median wall seconds of 1-epoch and 2-epoch runs over ``reps``."""
    w1s, w2s = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        subprocess.run(args + ["-nepochs=1"], check=True, capture_output=True)
        w1s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        subprocess.run(args + ["-nepochs=2"], check=True, capture_output=True)
        w2s.append(time.perf_counter() - t0)
    return statistics.median(w1s), statistics.median(w2s)


def _build_reference(out_dir: str) -> str:
    """Build the reference binaries into ``out_dir``/ref_build through the
    root bench's harness (REF names the reference's source); their bin/."""
    build = os.path.join(REPO, "benchmarks", "reference_harness", "build.sh")
    out = os.path.join(out_dir, "ref_build")
    subprocess.run([build], check=True, capture_output=True,
                   env={**os.environ, "OUT": out})
    return os.path.join(out, "bin")


def _measure_reference(train_path: str, knobs: Knobs, out_dir: str) -> dict:
    """Build + time the reference wals single-core on the same data
    (bench.py:63-91): epoch = t(2 epochs) - t(1 epoch)."""
    bin_dir = _build_reference(out_dir)
    args = [
        os.path.join(bin_dir, "wals"),
        f"-nfactors={knobs.nfactors}",
        "-nthreads=1",
        f"-train_dataset={train_path}",
        f"-user_factors={os.path.join(out_dir, 'ref_bench_u.dat')}",
        f"-item_factors={os.path.join(out_dir, 'ref_bench_i.dat')}",
    ]
    w1, w2 = _timed_reps(args, knobs.baseline_reps)
    epoch_1core = max(w2 - w1, 1e-9)
    return {
        "preset": knobs.preset,
        "nfactors": knobs.nfactors,
        "reps": knobs.baseline_reps,
        "ref_wall_1epoch_s": w1,
        "ref_wall_2epoch_s": w2,
        "ref_epoch_1core_s": epoch_1core,
        "ref_epoch_16core_extrapolated_s": epoch_1core
        / ASSUMED_REF_THREAD_SCALING,
    }


def _measure_reference_bpr(train_path: str, n_triplets: int, knobs: Knobs,
                           out_dir: str) -> dict:
    """Build + time the reference bpr single-core on the same data
    (bench.py:108-146): updates/s counts one SGD update a (positive,
    sampled negative) pair, n_positives x num_negative_samples an epoch."""
    bin_dir = _build_reference(out_dir)
    args = [
        os.path.join(bin_dir, "bpr"),
        f"-nfactors={knobs.bpr_nfactors}",
        f"-num_negative_samples={knobs.bpr_num_neg}",
        "-num_hogwild_threads=1",
        f"-train_dataset={train_path}",
        f"-user_factors={os.path.join(out_dir, 'ref_bpr_u.dat')}",
        f"-item_factors={os.path.join(out_dir, 'ref_bpr_i.dat')}",
    ]
    w1, w2 = _timed_reps(args, knobs.baseline_reps)
    epoch_1core = max(w2 - w1, 1e-9)
    ups_1core = n_triplets / epoch_1core
    return {
        "preset": knobs.preset,
        "nfactors": knobs.bpr_nfactors,
        "num_negative_samples": knobs.bpr_num_neg,
        "n_triplets_per_epoch": n_triplets,
        "reps": knobs.baseline_reps,
        "ref_wall_1epoch_s": w1,
        "ref_wall_2epoch_s": w2,
        "ref_epoch_1core_s": epoch_1core,
        "ref_updates_per_s_1core": ups_1core,
        "ref_updates_per_s_16core_extrapolated": ups_1core
        * ASSUMED_REF_THREAD_SCALING,
    }


def get_baseline(key: str, measure, host: str | None = None,
                 cache_file: str = BASELINE_FILE) -> tuple:
    """(the cached or measured reference numbers, or {}, and the reason
    when there are none for this host). ``measure()`` runs only when the
    cache holds nothing for ``key`` and ``REF`` names the reference's
    source; an entry is used only if it was timed on ``host`` (this
    host's name by default)."""
    host = socket.gethostname() if host is None else host
    cache = {}
    if os.path.exists(cache_file):
        with open(cache_file) as f:
            cache = json.load(f)
    entry = cache.get(key)
    if entry is None:
        if not os.environ.get("REF"):
            return {}, ("REF is unset: no reference source to build "
                        "(benchmarks/reference_harness/build.sh)")
        try:
            entry = {**measure(), "host": host}
        except (OSError, subprocess.CalledProcessError) as e:
            return {}, f"the reference measurement failed: {e}"
        cache[key] = entry
        os.makedirs(os.path.dirname(cache_file), exist_ok=True)
        with open(cache_file, "w") as f:
            json.dump(cache, f, indent=2)
    if entry.get("host") != host:
        return {}, (f"the cached reference was timed on host "
                    f"{entry.get('host')!r}, not on this one ({host!r})")
    return entry, None


class _Reference:
    """The reference baseline's inputs, made at its first use: the ratings
    file under qmf_tpu_torch/_build/bench/ (written only when the
    reference is to be timed)."""

    def __init__(self, knobs: Knobs, data):
        self.knobs, self.data = knobs, data
        self.out_dir = os.path.join(BUILD_DIR, "bench")
        self._path = None

    def train_path(self) -> str:
        if self._path is None:
            from qmf_tpu_torch.tools.datagen import write_ratings

            os.makedirs(self.out_dir, exist_ok=True)
            self._path = os.path.join(self.out_dir,
                                      f"{self.knobs.preset}.txt")
            write_ratings(self._path, *self.data)
        return self._path

    def vs(self, key: str, measure, ours: float, field: str,
           faster_is_lower: bool):
        """vs_baseline (>1 = faster than the reference) or None, and the
        reason printed on a ``#`` line."""
        base, why = get_baseline(key, measure)
        ref = base.get(field)
        if not ref:
            print(f"# vs_baseline null: {why}", file=sys.stderr, flush=True)
            return None
        print(f"# reference ({key}): {base}", file=sys.stderr, flush=True)
        return ref / ours if faster_is_lower else ours / ref


# --- the two benchmarks -----------------------------------------------------
def bench_wals(dataset, knobs: Knobs, device: torch.device,
               ref: _Reference | None) -> dict:
    """The WALS epoch (bench.py:271-360). Returns the metric's record."""
    from qmf_tpu_torch import WALSConfig
    from qmf_tpu_torch.models import WALSEngine

    cfg = WALSConfig(
        nepochs=1,
        nfactors=knobs.nfactors,
        regularization_lambda=0.05,
        confidence_weight=40.0,
        init_seed=0,
        batch_rows=knobs.batch_rows,
        matmul_precision=knobs.precision,
        **({"width_grid": knobs.width_grid} if knobs.width_grid else {}),
        **({"solver": knobs.solver} if knobs.solver else {}),
        **({"max_width_classes": int(knobs.max_classes)}
           if knobs.max_classes else {}),
    )
    engine = WALSEngine(cfg, device=device)
    t0 = time.perf_counter()
    engine.init(dataset)
    _sync(device)
    print(f"# wals init ({engine._pack_kind}): "
          f"{time.perf_counter() - t0:.3f}s, stages "
          f"{ {k: round(v, 4) for k, v in engine._init_stages.items()} }; "
          f"solver {engine._solver}, hot widths {engine.hot_widths}",
          file=sys.stderr, flush=True)
    losses = []
    t0 = time.perf_counter()
    losses.append(engine._fused_epoch())
    program = engine._program
    kind = (f"cuda graph, capture {program.capture_s:.4f}s"
            if hasattr(program, "capture_s")
            else f"eager ({'; '.join(engine._eager_reasons)})")
    print(f"# wals warm-up epoch (incl. capture): "
          f"{time.perf_counter() - t0:.3f}s; epoch program: {kind}",
          file=sys.stderr, flush=True)

    def step():
        # float(loss) inside _fused_epoch waits for the device
        losses.append(engine._fused_epoch())

    _reset_peak(device)
    before = _counts()
    steady = measure_steady(step, "wals steady", knobs.epochs,
                            knobs.spread_threshold, knobs.spread_rounds,
                            knobs.spread_sleep_s)
    n_epochs = len(losses) - 1
    launches = {name: (n - before[name]) / n_epochs
                for name, n in _counts().items() if n != before[name]}
    peak = _peak_bytes(device)
    epoch_s = steady["median"]
    loss = losses[-1]
    print(f"# final loss: {loss:.6f}; kernel launches an epoch "
          f"{launches}; peak memory since the timing began {peak}",
          file=sys.stderr, flush=True)
    flops, padded = epoch_flops(engine)
    eff = flops / epoch_s
    if device.type == "cuda":
        print(f"# est. epoch FLOPs {flops / 1e9:.1f} GF ({padded} padded "
              f"entries), effective {eff / 1e12:.3f} TFLOP/s: "
              f"{eff / BF16_PEAK_FLOPS * 100:.2f}% of the H100 SXM's dense "
              f"bf16 peak (989 TFLOP/s), {eff / FP32_PEAK_FLOPS * 100:.2f}% "
              f"of its fp32 peak (67 TFLOP/s)", file=sys.stderr, flush=True)
    else:
        print(f"# est. epoch FLOPs {flops / 1e9:.3f} GF ({padded} padded "
              f"entries; no peak share on the cpu)", file=sys.stderr,
              flush=True)
    prof = profile_epoch(step, device)
    _print_profile("wals", prof)
    vs = None
    if ref is not None:
        vs = ref.vs(f"{knobs.preset}_k{knobs.nfactors}",
                    lambda: _measure_reference(ref.train_path(), knobs,
                                               ref.out_dir),
                    epoch_s, "ref_epoch_16core_extrapolated_s", True)
    return {"value": epoch_s, "unit": "s", "vs_baseline": vs,
            "spread": steady["spread"], "epochs_s": steady["times"],
            "round": steady["round"], "loss": loss,
            "solver": engine._solver, "hot_widths": dict(engine.hot_widths),
            "losses": losses, "flops": flops, "padded": padded,
            "launches_per_epoch": launches, "peak_bytes": peak,
            "profile": prof}


def bench_bpr(dataset, knobs: Knobs, device: torch.device,
              ref: _Reference | None) -> dict:
    """BPR real triplet updates a second (bench.py:363-428)."""
    from qmf_tpu_torch import BPRConfig
    from qmf_tpu_torch.models import BPREngine

    cfg = BPRConfig(
        nepochs=1,
        nfactors=knobs.bpr_nfactors,
        num_negative_samples=knobs.bpr_num_neg,
        batch_size=knobs.bpr_batch,
        init_seed=0,
        **({"item_scatter": knobs.bpr_item_scatter}
           if knobs.bpr_item_scatter else {}),
    )
    eng = BPREngine(cfg, device=device)
    t0 = time.perf_counter()
    eng.init(dataset)
    _sync(device)
    path = "grouped" if eng._grouped else "stream"
    n_real = int(eng._n_real_triplets)
    print(f"# bpr init ({path} path): {time.perf_counter() - t0:.3f}s, "
          f"{n_real} real triplets an epoch", file=sys.stderr, flush=True)

    def step():
        eng._epoch()
        # a scalar read of the factors: the device sync
        return float(eng.params.user_factors[0, 0])

    t0 = time.perf_counter()
    step()
    print(f"# bpr warm-up epoch (incl. capture): "
          f"{time.perf_counter() - t0:.3f}s; epoch program: "
          f"{type(eng._program).__name__} {eng._eager_reasons or ''}",
          file=sys.stderr, flush=True)
    _reset_peak(device)
    steady = measure_steady(step, "bpr steady", knobs.epochs,
                            knobs.spread_threshold, knobs.spread_rounds,
                            knobs.spread_sleep_s)
    peak = _peak_bytes(device)
    epoch_s = steady["median"]
    ups = n_real / epoch_s
    print(f"# bpr: {n_real / 1e6:.3f}M real triplets / {epoch_s:.4f}s -> "
          f"{ups / 1e6:.3f}M updates/s; peak memory since the timing began "
          f"{peak}", file=sys.stderr, flush=True)
    finite = bool(torch.isfinite(eng.params.user_factors).all())
    prof = profile_epoch(step, device)
    _print_profile("bpr", prof)
    vs = None
    if ref is not None:
        key = (f"{knobs.preset}_bpr_k{knobs.bpr_nfactors}_n{knobs.bpr_num_neg}"
               if knobs.bpr_num_neg != 3
               else f"{knobs.preset}_bpr_k{knobs.bpr_nfactors}")
        vs = ref.vs(key, lambda: _measure_reference_bpr(
            ref.train_path(), n_real, knobs, ref.out_dir), ups,
            "ref_updates_per_s_16core_extrapolated", False)
    return {"value": ups, "unit": "updates/s", "vs_baseline": vs,
            "spread": steady["spread"], "epochs_s": steady["times"],
            "round": steady["round"], "path": path,
            "n_real_triplets": n_real, "factors_finite": finite,
            "peak_bytes": peak, "profile": prof}


# the fields of a metric line besides metric and device
_WALS_FIELDS = ("value", "unit", "vs_baseline", "spread", "epochs_s", "loss",
                "solver", "hot_widths")
_BPR_FIELDS = ("value", "unit", "vs_baseline", "spread", "epochs_s", "path")


def load_data(preset: str):
    """tools.datagen's preset (seed 42) as arrays and a Dataset."""
    from qmf_tpu_torch.tools.datagen import PRESETS, generate

    from qmf_tpu_torch.data import Dataset

    users, items, values = generate(**PRESETS[preset], seed=SEED)
    return (users, items, values), Dataset(users, items, values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cuda:N; cpu rehearses the steps "
                         "and prints no metric")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        print("bench: no CUDA device (torch.cuda.is_available() is False); "
              "the metrics are the card's. --device=cpu rehearses the "
              "steps without a metric", file=sys.stderr)
        return 2
    if device.type not in ("cuda", "cpu"):
        ap.error(f"--device {args.device}: cuda, cuda:N or cpu")
    knobs = Knobs.from_env()
    print(f"# knobs: {dataclasses.asdict(knobs)}", file=sys.stderr)
    card = None
    if on_card:
        from qmf_tpu_torch import kernels

        card = card_info()
        print(f"# card: {card['line']}; torch {torch.__version__}, cuda "
              f"{torch.version.cuda}", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        kernels.load()
        print(f"# kernels built or loaded: {time.perf_counter() - t0:.3f}s",
              file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    arrays, dataset = load_data(knobs.preset)
    print(f"# data ({knobs.preset}, seed {SEED}, in memory): {len(dataset)} "
          f"ratings, {time.perf_counter() - t0:.3f}s", file=sys.stderr,
          flush=True)
    if not on_card:
        print("# reference baseline: not timed on the cpu rehearsal",
              file=sys.stderr)
    ref = _Reference(knobs, arrays) if on_card else None
    results = {"wals": bench_wals(dataset, knobs, device, ref)}
    if not np.isfinite(results["wals"]["loss"]):
        raise FloatingPointError(f"non-finite WALS loss "
                                 f"{results['wals']['loss']}")
    if on_card:
        _emit(f"{knobs.preset}_wals_epoch_time_k{knobs.nfactors}_torch",
              results["wals"], _WALS_FIELDS, card)
    if on_card:
        torch.cuda.empty_cache()
    if not knobs.skip_bpr:
        results["bpr"] = bench_bpr(dataset, knobs, device, ref)
        if not results["bpr"]["factors_finite"]:
            raise FloatingPointError("non-finite BPR factors")
        if on_card:
            _emit(f"{knobs.preset}_bpr_updates_per_s_torch", results["bpr"],
                  _BPR_FIELDS, card)
    if not on_card:
        print("# cpu rehearsal: " + json.dumps(results), flush=True)
    return 0


def _emit(metric: str, record: dict, fields: tuple, card: dict) -> None:
    print(json.dumps({"metric": metric,
                      **{f: record[f] for f in fields},
                      "device": {"name": card["name"],
                                 "power_limit_w": card["power_limit_w"]}}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
