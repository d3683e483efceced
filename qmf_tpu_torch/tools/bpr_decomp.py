"""Where a grouped BPR epoch's time goes, on a card.

    python -m qmf_tpu_torch.tools.bpr_decomp [batch ...] [--bloom]
        [--preset=ml20m] [--device=cuda]

The port's counterpart of benchmarks/bpr_stage_decomp.py (pass 1 against
the SGD loop) and of the stages of benchmarks/bpr_presample_micro.py. For
each batch (default 32,768 and 8,192) one ``BPREngine`` on the preset
(``tools.datagen``, seed 42, all ratings, as tools/bench.py loads them;
after the first, :func:`init_like` the first: the same index and positive
set) at the bench's BPR configuration: k = 30, 3 negatives, 4 rounds, the default
``neg_sampler="word"``; ``--bloom`` sets ``bitmap_budget_mb=0``, which
gives the blocked Bloom filter with the exact CSR check where the default
budget gives the exact bitmap. :func:`decompose` times, in ms:

- ``epoch_ms``: the engine's own epoch program (a replay of its CUDA
  graph on a card);
- ``pass1_ms``: pass 1 alone (bpr_ops.grouped_parts' ``pass1``, which is
  ``_sample_pack_grouped_body`` with the epoch's arguments), as a graph of
  its own;
- ``sgd_ms``: the SGD loop alone (``grouped_parts``' ``sgd``) on that pass
  1's output, as a graph of its own.

  These three are timed in turns, one call of each a round, ``reps``
  rounds, each the median of its rounds: the card's epoch sits at one of
  two levels from one call to another, and the parts of one round were
  timed at the same time. ``pass1_sgd_minus_epoch_ms_each`` is pass 1 plus
  the loop less the epoch, round by round;
- ``stages_ms``: prefixes of pass 1, each a graph: ``shuffle`` (the
  Feistel bijection, the row gather and the encoding), ``member0`` (adds
  round 0's candidate hash and membership test at full stream width),
  ``compact`` (adds ``_compact`` into the ``collide_cap`` buffer),
  ``rounds`` (adds the later rounds on the buffer), ``full`` (the whole
  pass 1 under the compacted sampler) and, on the exact bitmap, ``word``
  (pass 1 under the word sampler). On the Bloom engine the membership test
  is the filter's and the later rounds start with the CSR check. The stages
  call the bpr_ops helpers pass 1 calls; each returns (enc, p) with what it
  computed folded into enc, so that nothing it computes is dead;
- the host parts of the bench's own step (tools/bench.py: ``eng._epoch()``
  then ``float(uf[0, 0])``), on the host's clock, ``reps`` rounds, each a
  step timed by its parts then the bench's step timed whole, each the
  median of its rounds: ``draws_ms`` (the keys and the rate tensor),
  ``launch_ms`` (the program call until it returns: the input copies and
  the graph's launch), ``wait_ms`` (from there to the end of the scalar
  read), ``parted_step_ms`` (their sum, step by step) and
  ``host_epoch_ms`` (the bench's step); beside them
  ``pipelined_epoch_ms``, ``reps`` steps back to back with one read at the
  end, divided by ``reps``.

On a card each part is captured as a CUDA graph and replayed
(tools/epoch_decomp.py ``_replayable``), and a replay is timed between
CUDA events; the stages are each the mean of ``reps`` replays
(``_part_ms``). :func:`split_check` holds pass 1 then the SGD loop, each
its own program, against the engine's epoch program, on one set of keys,
bit for bit. The card's name and power limit come first and a JSON line of
the parts comes last. Without a CUDA device and without ``--device=cpu`` it exits nonzero;
``--device=cpu`` runs the plain versions on the host's clock.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import sys
import time

import numpy as np
import torch

from qmf_tpu_torch.ops import bpr_ops, graphs
from qmf_tpu_torch.tools.bench import _sync
from qmf_tpu_torch.tools.epoch_decomp import _part_ms, _replayable

REPS = 5
SEED = 42
BATCHES = (32768, 8192)
STAGES = ("shuffle", "member0", "compact", "rounds", "full", "word")


def bpr_config(batch: int, bloom: bool = False, **kw):
    """tools/bench.py's BPR configuration at ``batch``; ``bloom`` takes
    the Bloom filter with the CSR check (no bitmap budget)."""
    from qmf_tpu_torch import BPRConfig

    return BPRConfig(nepochs=1, nfactors=30, num_negative_samples=3,
                     batch_size=batch, neg_resample_rounds=4, init_seed=0,
                     **({"bitmap_budget_mb": 0} if bloom else {}), **kw)


def draw_keys(engine, seed: int = SEED) -> tuple:
    """(rk, ks) for the engine's configuration from a generator of its own
    (``ks`` None without a shuffle), so the engine's draws stay as they
    were."""
    cfg = engine.config
    gen = torch.Generator(device=engine.device).manual_seed(seed)
    return bpr_ops.draw_grouped_keys(gen, cfg.neg_resample_rounds,
                                     cfg.shuffle_training_set)


def stage_names(engine) -> tuple:
    """The stages of the engine's membership: no ``word`` on the Bloom
    filter."""
    return STAGES if engine._pos_bloom is None else STAGES[:-1]


def stage_fn(engine, pack: dict, stage: str):
    """``stage``'s prefix of pass 1 as ``fn(rk, ks) -> (enc, p)``, on the
    engine's stream and membership; ``pack`` is grouped_parts' ``pack``."""
    bloom = engine._pos_bloom is not None
    member = engine._membership()
    up = engine._grp_up
    n_items, num_neg = pack["n_items"], pack["num_neg"]
    n_rounds, cap = pack["n_rounds"], pack["collide_cap"]
    if stage in ("full", "word"):
        kw = dict(pack, membership="word" if stage == "word"
                  else "bloom" if bloom else "bitmap")

        def whole(rk, ks):
            return bpr_ops._sample_pack_grouped_body(
                rk, ks, up, member.words, **kw)[:2]

        return whole
    first = functools.partial(
        bpr_ops._is_member_bloom if bloom else bpr_ops._is_member_bitmap,
        member)

    def prefix(rk, ks):
        u, p, valid = bpr_ops._shuffled_rows(ks, up, pack["n_real"],
                                             pack["feistel_b"])
        enc = bpr_ops._encode(u, valid, pack["u_shift"])
        if stage == "shuffle":
            return enc, p
        slots = bpr_ops._slot_users(u, num_neg)
        member0 = bpr_ops._first_round(first, rk, slots, n_items)
        if stage == "member0":
            return enc | member0.reshape(-1, num_neg)[:, 0], p
        cidx, _ = bpr_ops._compact(member0, cap)
        if stage == "compact":
            return enc | (cidx.sum() & 1), p
        if bloom:
            chosen = bpr_ops._resample_exact(engine._pos_set, rk, cidx,
                                             slots, n_items, n_rounds)
        else:
            chosen = bpr_ops._resample_bitmap(member, rk, cidx, slots,
                                              n_items, n_rounds)
        return enc | (chosen.sum() & 1), p

    return prefix


def init_like(engine, other) -> None:
    """``engine.init`` on the data of ``other`` (an initialized engine on
    the same device), taking its index and positive set, the stages that
    depend on the data alone (~8 s at ml20m), and building the rest for
    ``engine``'s configuration as ``init`` builds it: the membership
    structure, the stream, the eval set and the parameters."""
    from qmf_tpu_torch.models.bpr import _stage_marker

    if engine.params is not None:
        raise RuntimeError("engine was already initialized with train data")
    if other.params is None or other.device != engine.device:
        raise ValueError(f"init_like needs an initialized engine on "
                         f"{engine.device}")
    stages = engine._init_stages = {}
    mark = _stage_marker(stages)
    engine.user_index, engine.item_index = other.user_index, other.item_index
    engine._data_users, engine._data_items = (other._data_users,
                                              other._data_items)
    engine._pos_set = other._pos_set
    # make_pos_set's lexsorted deduplicated pairs, read back from the CSR
    indptr = engine._pos_set.indptr.cpu().numpy()
    sorted_u = np.repeat(np.arange(engine.nusers, dtype=np.int32),
                         np.diff(indptr))
    sorted_i = engine._pos_set.items.cpu().numpy()
    mark("pos_set")
    engine._init_from_positives(sorted_u, sorted_i, mark)


def _call_ms(fn, device: torch.device) -> float:
    """ms of one call of ``fn``: CUDA events on a card, the host's clock on
    the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t0)


def _in_turns(fns: dict, device: torch.device, reps: int) -> dict:
    """``{name: [ms, ...]}``: after one warm-up call of each of ``fns``,
    ``reps`` rounds of one timed call of each in turn."""
    for fn in fns.values():
        fn()
    out = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            out[name].append(_call_ms(fn, device))
    return out


def host_parts(engine, reps: int) -> dict:
    """The bench's step on the host's clock (see the module's docstring),
    medians of ``reps`` rounds, in ms."""
    device = engine.device
    program = engine._epoch_program()

    def read():
        return float(engine.params.user_factors[0, 0])

    read()
    names = ("draws", "launch", "wait", "parted_step", "host_epoch")
    each = {name: [] for name in names}
    for _ in range(reps):
        t0 = time.perf_counter()
        inputs = engine._grouped_inputs()
        t1 = time.perf_counter()
        *params, _ = program(*inputs, *engine.params)
        t2 = time.perf_counter()
        engine.params = bpr_ops.BPRParams(*params)
        read()
        t3 = time.perf_counter()
        engine._epoch()
        read()
        t4 = time.perf_counter()
        for name, a, b in zip(names, (t0, t1, t2, t0, t3),
                              (t1, t2, t3, t3, t4)):
            each[name].append(1e3 * (b - a))
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        engine._epoch()
    read()
    pipelined = 1e3 * (time.perf_counter() - t0) / reps
    out = {f"{name}_ms": statistics.median(v) for name, v in each.items()}
    out.update({f"{name}_ms_each": v for name, v in each.items()
                if name in ("parted_step", "host_epoch")})
    out["pipelined_epoch_ms"] = pipelined
    return out


def decompose(engine, reps: int = REPS) -> dict:
    """The parts of one grouped epoch of an initialized engine, in ms (see
    the module's docstring), with ``batch``, ``membership`` (pass 1's:
    word, bitmap or bloom), ``collide_cap``, ``nodes`` (the epoch graph's,
    None off a card), ``real_triplets`` and ``updates_per_s`` over
    ``epoch_ms`` and over ``host_epoch_ms``. The engine trains on: every
    epoch program call is an epoch."""
    if not engine._grouped:
        raise ValueError("bpr_decomp times the grouped epoch; this engine "
                         "took the triplet stream")
    device = engine.device
    parts = bpr_ops.grouped_parts(*engine._grouped_args())
    program = engine._epoch_program()
    inputs = engine._grouped_inputs()

    def epoch():
        *params, _ = program(*inputs, *engine.params)
        engine.params = bpr_ops.BPRParams(*params)

    epoch()  # on a card the capture, if the engine has run no epoch
    rk, ks = draw_keys(engine)
    enc, p, _ = parts.pass1(rk, ks)
    lr = engine._rate()
    params = [t.clone() for t in engine.params]
    each = _in_turns({
        "epoch": epoch,
        "pass1": _replayable(lambda: parts.pass1(rk, ks), device),
        "sgd": _replayable(lambda: parts.sgd(enc, p, rk, lr, *params),
                           device)}, device, reps)
    del enc, p, params
    out = {"batch": engine._grp_batch,
           "membership": parts.pack["membership"],
           "collide_cap": engine._collide_cap,
           "nodes": getattr(program, "nodes", None),
           "real_triplets": int(engine._n_real_triplets)}
    for name, ms in each.items():
        out[f"{name}_ms"] = statistics.median(ms)
        out[f"{name}_ms_each"] = ms
    out["pass1_sgd_minus_epoch_ms_each"] = [
        a + b - c for a, b, c in zip(each["pass1"], each["sgd"],
                                     each["epoch"])]
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["stages_ms"] = {}
    for stage in stage_names(engine):
        fn = stage_fn(engine, parts.pack, stage)
        out["stages_ms"][stage] = _part_ms(lambda: fn(rk, ks), device, reps)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out.update(host_parts(engine, reps))
    n = out["real_triplets"]
    out["updates_per_s"] = {"epoch": n / out["epoch_ms"] * 1e3,
                            "host_epoch": n / out["host_epoch_ms"] * 1e3}
    return out


def split_check(engine, seed: int = SEED) -> dict:
    """Under ``torch.use_deterministic_algorithms(True)`` (index_add_ then
    sums a step's rows in a fixed order), pass 1 then the SGD loop, each
    its own program as :func:`decompose` times them, against the engine's
    epoch program, made afresh as ``_epoch_program`` makes it
    (graphs.epoch_program of ``_epoch_body``): each program called twice
    on the same keys from the engine's current parameters, on a card the
    capture of its CUDA graph and then a replay, whose outputs are held to
    one another: ``{"equal": every parameter and the overflow count
    torch.equal, "max_abs_diff": ..., "n_overflow": ..., "nodes": each
    graph's, None off a card}``. The engine's parameters and program are
    left as they were."""
    device = engine.device
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        parts = bpr_ops.grouped_parts(*engine._grouped_args())
        rk, ks = draw_keys(engine, seed)
        if ks is None:
            ks = bpr_ops.no_keys(6, device)
        lr = engine._rate()
        start = [t.clone() for t in engine.params]
        nodes = {}

        def replayed(name, fn, inputs):
            # two calls of fn's program on inputs(): the second's outputs
            program, _ = graphs.epoch_program(name, fn, device, engine.mesh)
            for _ in range(2):
                out = program(*inputs())
            nodes[name] = getattr(program, "nodes", None)
            return [t.clone() for t in out]

        def fresh(*head):
            return lambda: (*head, *(t.clone() for t in start))

        enc, p, over = replayed("pass 1", parts.pass1, lambda: (rk, ks))
        got = [*replayed("SGD loop", parts.sgd, fresh(enc, p, rk, lr)),
               over]
        del enc, p
        want = replayed("BPR grouped epoch", engine._epoch_body(),
                        fresh(rk, ks, lr))
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        diff = max(float((a.double() - b.double()).abs().max())
                   for a, b in zip(got, want))
    finally:
        torch.use_deterministic_algorithms(was)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"equal": equal, "max_abs_diff": diff,
            "n_overflow": int(want[-1]), "nodes": nodes}


def report(parts: dict) -> str:
    """The parts as lines of text."""
    ms = parts["stages_ms"]
    return "\n".join([
        f"batch {parts['batch']}, membership {parts['membership']}, "
        f"collide_cap {parts['collide_cap']}, graph nodes {parts['nodes']}",
        "epoch (program) / pass 1 / SGD loop, in turns: "
        f"{parts['epoch_ms']:.3f} / {parts['pass1_ms']:.3f} / "
        f"{parts['sgd_ms']:.3f} ms (medians; rounds "
        + "; ".join(f"{e:.3f} / {a:.3f} / {b:.3f}" for e, a, b in zip(
            parts["epoch_ms_each"], parts["pass1_ms_each"],
            parts["sgd_ms_each"])) + ")",
        "pass 1 by stage (prefixes): " + ", ".join(
            f"{k} {v:.3f}" for k, v in ms.items()) + " ms",
        f"host step: draws {parts['draws_ms']:.3f}, launch "
        f"{parts['launch_ms']:.3f}, wait {parts['wait_ms']:.3f}, sum "
        f"{parts['parted_step_ms']:.3f}; bench step "
        f"{parts['host_epoch_ms']:.3f} ms, pipelined "
        f"{parts['pipelined_epoch_ms']:.3f} ms",
        f"updates/s: {parts['updates_per_s']['epoch'] / 1e6:.3f}M (program)"
        f", {parts['updates_per_s']['host_epoch'] / 1e6:.3f}M (host step)",
    ])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="*", type=int, default=list(BATCHES))
    ap.add_argument("--bloom", action="store_true",
                    help="bitmap_budget_mb=0: the Bloom filter and CSR check")
    ap.add_argument("--preset", default="ml20m")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bpr_decomp: no CUDA device; --device=cpu times the plain "
              "versions on the host's clock", file=sys.stderr)
        return 2
    from qmf_tpu_torch.models import BPREngine
    from qmf_tpu_torch.tools.bench import card_info, load_data

    card = None
    if device.type == "cuda":
        card = card_info()
        print(f"card: {card['line']}", flush=True)
    _, dataset = load_data(args.preset)
    runs, first = [], None
    for batch in args.batch:
        engine = BPREngine(bpr_config(batch, args.bloom), device=device)
        t0 = time.perf_counter()
        if first is None:
            engine.init(dataset)
        else:  # the index and positive set are the first engine's
            init_like(engine, first)
        _sync(device)
        print(f"init {time.perf_counter() - t0:.1f}s batch={batch}",
              flush=True)
        parts = decompose(engine)
        print(report(parts), flush=True)
        runs.append(parts)
        engine._program = None  # frees its graph's memory pool
        first = first or engine
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"preset": args.preset, "bloom": args.bloom,
                      "device": str(device), "card": card, "runs": runs}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
