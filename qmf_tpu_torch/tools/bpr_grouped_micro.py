"""Where a grouped BPR step's time goes, on a card: its gathers, its
arithmetic and its scatters.

    python -m qmf_tpu_torch.tools.bpr_grouped_micro [variant ...]
        [--batch B] [--steps S] [--inputs synthetic|engine]
        [--preset ml20m] [--reps R] [--device cuda]

The port's counterpart of benchmarks/bpr_grouped_micro.py. It times loops
of S steps of the grouped minibatch step (ops/bpr_ops.py
``_sgd_epoch_scan_grouped_body``) with parts of the step turned off. Every
variant is built from the loop's own step helpers (``_step_decode``,
``_step_gathers``, ``_step_grads``, ``_whole_batch``, ``_step_writes``):

  base        the production step: 3 gathers of factor rows (pu, qp, the
              num_neg qn) and 2 + num_neg scatter-adds (``seq``)
  merged      the item scatters as one (1 + num_neg) * B-row index_add_
              (``item_scatter="merged"``)
  noneg       the negatives' scatters skipped (user and positive remain)
  noscatter   no scatter: each table scaled by 1 + the mean of its update,
              as the JAX probe does, so that the gradients are used
  nogather    the factor gathers replaced by broadcast rows (users' row 0,
              items' rows 0 and 1; ``neg * 0.0`` keeps the negatives'
              hashes in the step); the scatters remain
  compute     neither gathers nor scatters: the decode and the arithmetic
  inscan      base with the JAX probe's model of pass 1 folded into the
              step: an index mix of Feistel cost (three int32
              multiply/xor/shift rounds), a stream-row gather, a
              bitmap-word gather and in-word probes per negative, which give
              the step its rows and their rounds; it decodes the negatives
              by each round's hash, as the JAX probe does, whatever the
              inputs' sampler
  mesh        base with ``_whole_batch`` over a mesh: the sharded engine's
              step
  collective  ``_whole_batch`` alone, once a step, on one step's tensors

``mesh`` and ``collective`` need a mesh (parallel/mesh.py), so they run
from Python only (chip_smoke.py phase 10c, at world 1 over NCCL); the
command line runs the others, by default the JAX probe's six (all but
``inscan``).

Inputs (``--inputs``):

- ``synthetic`` (the default): the JAX probe's, made the same way with
  numpy (``default_rng(0)``): U, I, K = 138,493, 26,744, 30; float32
  factors from N(0, 0.01); uniform users and positives; the ``rounds``
  decode with zero round bits; lr 1e-6 and lambda 1e-4 on both sides, as
  float32 values; no biases; the ``seq`` scatter.
- ``engine``: the first S steps of an initialized ``BPREngine``'s own pass
  1 stream (``grouped_parts(...).pass1`` on keys drawn from the tool's
  seed), at the engine's configuration: its sampler, lambdas, biases,
  ``item_scatter`` and rate. The command line builds the engine on
  tools.datagen's ``--preset`` (seed 42, all ratings) at
  tools/bpr_decomp.py's configuration. Its items are skewed as datagen
  skews them, so ``base`` less ``noscatter`` there includes the atomics'
  contention on popular rows; on the uniform synthetic ids it does not.

Each variant runs on clones of the start parameters. On a card each
variant's S steps are captured once as a CUDA graph (tools/timing.py), and
all variants replay in turns, one replay of each a round, ``reps`` rounds,
on the same steps every round, each replay timed between CUDA events.
Reported for each variant: ms a step (the median round over S, and every
round), the graph's nodes a step and the difference from ``base``; for
``base``: the bytes bound of a step (:func:`step_bytes`: the stream, the
rows its gradients read, and each distinct row its scatters touch read
and written once, counted from each step's own ids; beside it the count
with every scattered row), the time of that bound at 3.35 TB/s, the share
of it the step reaches, and the updates a second. The card's name and power
limit come first, :func:`report` prints the table on ``#`` lines and the
last line is one JSON line. Without a CUDA device and without
``--device=cpu`` it exits nonzero; ``--device=cpu`` runs the plain ops on
the host's clock.

Eager PyTorch fuses nothing: every elementwise op of the step is a kernel,
and ``nogather``'s broadcast is an ``expand`` view that the arithmetic then
reads. So ``compute`` is the floor of the step as the port writes it, one
kernel an op, not what a compiler that fuses the step would reach.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from typing import Optional

import numpy as np
import torch

from qmf_tpu_torch.ops import bpr_ops
from qmf_tpu_torch.tools import timing
from qmf_tpu_torch.tools.gather_micro import HBM_BPS

# the JAX probe's shapes and step settings
U, I, K = 138_493, 26_744, 30
NUM_NEG, N_ROUNDS = 3, 4
STEPS, BATCH = 100, 32768
LR, LAMBDA = float(np.float32(1e-6)), float(np.float32(1e-4))
# inscan's index mix: the JAX probe's three round constants
MIX = (0x1E3779B1, 0x05EBCA77, 0x42B2AE3D)
REPS = 5

DEFAULT_VARIANTS = ("base", "merged", "noneg", "noscatter", "nogather",
                    "compute")
JAX_VARIANTS = DEFAULT_VARIANTS + ("inscan",)
MESH_VARIANTS = ("mesh", "collective")
VARIANTS = JAX_VARIANTS + MESH_VARIANTS


@dataclasses.dataclass
class Inputs:
    """One run's stream, keys and step configuration
    (:func:`synthetic_inputs`, :func:`engine_inputs`)."""

    mode: str  # "synthetic" or "engine"
    enc: torch.Tensor  # (steps * batch,) int32 encoded rows
    p: torch.Tensor  # (steps * batch,) int32 positives
    rk: torch.Tensor  # (n_rounds, 3) int32 round keys
    lr: torch.Tensor  # 0-d, the factors' dtype
    params: bpr_ops.BPRParams  # the start: every variant runs on clones
    batch: int
    num_neg: int
    n_items: int
    n_rounds: int
    use_word: bool  # the word sampler's decode, else the rounds'
    wpu: int  # the word decode's bitmap words a user (0 under rounds)
    user_lambda: float
    item_lambda: float
    bias_lambda: float
    use_biases: bool
    item_scatter: str
    # inscan's stream rows (n, 2) [user, item] and bitmap words
    up: Optional[torch.Tensor] = None
    words: Optional[torch.Tensor] = None
    words_per_user: int = 0

    @property
    def steps(self) -> int:
        return self.enc.shape[0] // self.batch

    @property
    def u_shift(self) -> int:
        return 1 + 2 * self.num_neg

    def clone_params(self) -> bpr_ops.BPRParams:
        return bpr_ops.BPRParams(*(t.clone() for t in self.params))


def synthetic_inputs(batch: int = BATCH, steps: int = STEPS,
                     inscan: bool = False, n_users: int = U,
                     device="cpu", dtype=torch.float32) -> Inputs:
    """The JAX probe's inputs (benchmarks/bpr_grouped_micro.py ``main``),
    drawn in its order from ``default_rng(0)``; with ``inscan`` also its
    stream rows and bitmap words (U * wpu of them). ``n_users`` and
    ``dtype`` shrink and widen them for the tests."""
    rng = np.random.default_rng(0)
    uf = rng.normal(0, 0.01, (n_users, K)).astype(np.float32)
    itf = rng.normal(0, 0.01, (I, K)).astype(np.float32)
    rk = rng.integers(0, 1 << 30, (N_ROUNDS, 3)).astype(np.int32)
    u_shift = 1 + 2 * NUM_NEG
    enc = ((rng.integers(0, n_users, steps * batch) << u_shift)
           | 1).astype(np.int32)
    pos = rng.integers(0, I, steps * batch).astype(np.int32)
    wpu = (I + 31) // 32
    up = words = None
    if inscan:
        up = np.stack([rng.integers(0, n_users, steps * batch),
                       rng.integers(0, I, steps * batch)],
                      axis=1).astype(np.int32)
        words = rng.integers(0, 1 << 31, n_users * wpu,
                             dtype=np.int64).astype(np.int32)

    def dev(a, dt=None):
        return None if a is None else torch.from_numpy(a).to(device, dt)

    return Inputs(
        mode="synthetic", enc=dev(enc), p=dev(pos), rk=dev(rk),
        lr=torch.tensor(LR, dtype=dtype, device=device),
        params=bpr_ops.BPRParams(dev(uf, dtype), dev(itf, dtype),
                                 torch.zeros(I, dtype=dtype, device=device)),
        batch=batch, num_neg=NUM_NEG, n_items=I, n_rounds=N_ROUNDS,
        use_word=False, wpu=0, user_lambda=LAMBDA, item_lambda=LAMBDA,
        bias_lambda=0.0, use_biases=False, item_scatter="seq",
        up=dev(up), words=dev(words), words_per_user=wpu)


def engine_inputs(engine, steps: int = STEPS, seed: Optional[int] = None
                  ) -> Inputs:
    """The first ``steps`` steps of an initialized grouped engine's pass 1
    stream, on keys drawn from ``seed`` (tools/bpr_decomp.py's by default;
    the engine's own draws stay as they were), at the engine's
    configuration and rate. The stream is the views of pass 1's output,
    not a copy; the parameters are the engine's, which the variants
    clone."""
    from qmf_tpu_torch.tools import bpr_decomp

    if not engine._grouped:
        raise ValueError("bpr_grouped_micro times the grouped step; this "
                         "engine took the triplet stream")
    parts = bpr_ops.grouped_parts(*engine._grouped_args())
    rk, ks = bpr_decomp.draw_keys(engine, bpr_decomp.SEED if seed is None
                                  else seed)
    enc, p, _ = parts.pass1(rk, ks)
    batch = engine._grp_batch
    if steps * batch > enc.shape[0]:
        raise ValueError(f"{steps} steps of {batch} rows, the stream holds "
                         f"{enc.shape[0] // batch}")
    cfg = engine.config
    member = engine._membership()
    use_word = parts.pack["membership"] == "word"
    return Inputs(
        mode="engine", enc=enc[:steps * batch], p=p[:steps * batch], rk=rk,
        lr=engine._rate(), params=engine.params, batch=batch,
        num_neg=cfg.num_negative_samples, n_items=engine.nitems,
        n_rounds=cfg.neg_resample_rounds, use_word=use_word,
        wpu=member.words_per_user if use_word else 0,
        user_lambda=cfg.user_lambda, item_lambda=cfg.item_lambda,
        bias_lambda=cfg.bias_lambda, use_biases=cfg.use_biases,
        item_scatter=cfg.item_scatter, up=engine._grp_up, words=member.words,
        words_per_user=member.words_per_user)


def _inscan_rows(inp: Inputs, t: int, lane: torch.Tensor):
    """inscan's rows of step ``t`` (benchmarks/bpr_grouped_micro.py:47-67):
    (ue, p) from the mixed index, a stream row and a bitmap word, the
    rounds from in-word probes."""
    x = t * inp.batch + lane
    for c in MIX:
        # x < 2^31 and c < 2^31: the int64 product is exact, so its low 31
        # bits are those of int32's wrapped product
        x = ((x.to(torch.int64) * (c | 1)) & 0x7FFFFFFF).to(torch.int32)
        x = x ^ (x >> 13) ^ (x >> 7)  # x >= 0: >> is the logical shift
    row = inp.up[x % inp.up.shape[0]]
    u, p = row[:, 0], row[:, 1]
    wpu = inp.words_per_user
    w_row = inp.words[u * wpu + x % wpu]
    b0 = x & 31
    rbits = torch.zeros_like(x)
    for j in range(inp.num_neg):
        r_j = torch.zeros_like(x)
        for r in range(inp.n_rounds - 1):
            bit = (b0 + 7 * (j * (inp.n_rounds - 1) + r)) & 31
            # bit `bit` of w_row, whichever way >> fills: the mask drops it
            free = ((w_row >> bit) & 1) == 0
            r_j = torch.where((r_j == 0) & free, r + 1, r_j)
        rbits = rbits | (r_j << (1 + 2 * j))
    return (u << inp.u_shift) | rbits | 1, p


def _broadcast_rows(params: bpr_ops.BPRParams, negs: torch.Tensor,
                    use_biases: bool):
    """nogather's reads (benchmarks/bpr_grouped_micro.py:70-72,84-87): the
    users' row 0 and the items' rows 0 and 1 broadcast, the negatives'
    ids kept in the step by ``neg * 0.0``; the biases likewise."""
    uf, itf, ib = params
    b, n = negs.shape
    k = uf.shape[1]
    live = negs[:, :, None].to(uf.dtype) * 0.0
    pu = uf[0].expand(b, k)
    qp = itf[0].expand(b, k)
    qn = itf[1].expand(b, n, k) + live
    bp = bn = None
    if use_biases:
        bp = ib[0].expand(b)
        bn = ib[1].expand(b, n) + live[:, :, 0]
    return pu, qp, qn, bp, bn


def _scaled(params: bpr_ops.BPRParams, du, dp, dbp) -> None:
    """noscatter's writes (benchmarks/bpr_grouped_micro.py:105-107): each
    table scaled by 1 + the mean of its update (the rate is in the
    update already)."""
    uf, itf, ib = params
    uf.mul_(1.0 + du.mean())
    itf.mul_(1.0 + dp.mean())
    if dbp is not None:
        ib.mul_(1.0 + dbp.mean())


def make_step(variant: str, inp: Inputs, params: bpr_ops.BPRParams,
              mesh=None):
    """``variant``'s step as ``step(t)``: step ``t`` of ``inp``'s stream,
    updating ``params`` in place (see the module's docstring). ``mesh``
    only for ``mesh`` and ``collective``. The slot tables, and
    ``collective``'s step tensors (step 0's ids and gradients of this
    rank's lanes), are made here, before any capture; ``collective``'s
    step returns what ``_whole_batch`` gathers and updates nothing."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if (variant in MESH_VARIANTS) != (mesh is not None):
        raise ValueError(f"{variant}: a mesh goes with {MESH_VARIANTS} "
                         "and with nothing else")
    batch = inp.batch
    dev = inp.enc.device
    lo, hi = bpr_ops._lanes(batch, mesh)
    lane = torch.arange(lo, hi, dtype=torch.int32, device=dev)
    # inscan's rounds come from probes of its own, which the word decode
    # could map past the last item: it decodes them as the JAX probe does,
    # by each round's hash
    use_word = inp.use_word and variant != "inscan"
    wpu = inp.wpu if use_word else 0
    tables = bpr_ops._slot_tables(inp.num_neg, inp.n_rounds, use_word, dev)
    ue_steps = inp.enc.view(-1, batch)
    p_steps = inp.p.view(-1, batch)
    lambdas = (inp.user_lambda, inp.item_lambda, inp.bias_lambda)

    def reads(t):
        if variant == "inscan":
            ue, p = _inscan_rows(inp, t, lane)
        else:
            ue, p = ue_steps[t, lo:hi], p_steps[t, lo:hi]
        w, u, negs = bpr_ops._step_decode(
            ue, t * batch, lane, inp.rk, inp.lr, tables, inp.u_shift,
            inp.n_items, inp.n_rounds, use_word, wpu)
        if variant in ("nogather", "compute"):
            rows = _broadcast_rows(params, negs, inp.use_biases)
        else:
            rows = bpr_ops._step_gathers(params, u, p, negs, inp.use_biases)
        return w, u, p, negs, rows

    if variant == "collective":
        w, u, p, negs, rows = reads(0)
        parts = (u, p, negs, *bpr_ops._step_grads(w, *rows, *lambdas))

        def step(t):
            return bpr_ops._whole_batch(parts, batch, mesh)

        return step

    def step(t):
        w, u, p, negs, rows = reads(t)
        grads = bpr_ops._step_grads(w, *rows, *lambdas)
        if variant == "mesh":
            u, p, negs, *grads = bpr_ops._whole_batch((u, p, negs, *grads),
                                                      batch, mesh)
        du, dp, dn, dbp, dbn = grads
        if variant in ("noscatter", "compute"):
            _scaled(params, du, dp, dbp)
        elif variant == "noneg":
            params.user_factors.index_add_(0, u, du)
            params.item_factors.index_add_(0, p, dp)
            if dbp is not None:
                params.item_biases.index_add_(0, p, dbp)
        else:
            bpr_ops._step_writes(
                params, u, p, negs, *grads,
                "merged" if variant == "merged" else inp.item_scatter)

    return step


def run_steps(variant: str, inp: Inputs, params: bpr_ops.BPRParams,
              mesh=None) -> bpr_ops.BPRParams:
    """``inp.steps`` steps of ``variant`` on ``params``, eagerly; returns
    them."""
    step = make_step(variant, inp, params, mesh)
    for t in range(inp.steps):
        step(t)
    return params


def production_check(inp: Inputs) -> dict:
    """``base``'s steps against the production loop,
    bpr_ops._sgd_epoch_scan_grouped_body, on the same steps, each from
    clones of the start: ``{"equal": every table torch.equal,
    "max_abs_diff": ...}``. On a card they agree bit for bit only under
    torch.use_deterministic_algorithms (index_add_'s atomics sum a step's
    duplicate rows in the order the card runs them)."""
    got = run_steps("base", inp, inp.clone_params())
    want = bpr_ops._sgd_epoch_scan_grouped_body(
        inp.clone_params(), inp.enc, inp.p, inp.rk, inp.lr,
        inp.user_lambda, inp.item_lambda, inp.bias_lambda,
        use_biases=inp.use_biases, batch_size=inp.batch,
        num_neg=inp.num_neg, n_items=inp.n_items, n_rounds=inp.n_rounds,
        u_shift=inp.u_shift, item_scatter=inp.item_scatter,
        sampler="word" if inp.use_word else "rounds", wpu=inp.wpu)
    return {"equal": all(torch.equal(a, b) for a, b in zip(got, want)),
            "max_abs_diff": max(float((a.double() - b.double()).abs().max())
                                for a, b in zip(got, want))}


def step_bytes(inp: Inputs) -> dict:
    """The bytes ``base`` must move, a step on average over ``inp``'s
    steps: the stream's two int32 words a lane, read; the rows its
    gradients read, 2 + num_neg a lane (user, positive, negatives; with
    biases an item's bias beside its row); and each distinct row its
    scatters touch, read and written once: the step's distinct users and
    its distinct items among the positives and negatives, counted from the
    step's own ids. ``all_rows_bytes_per_step``: the same with every
    scattered row read and written (no row shared)."""
    b, n, s = inp.batch, inp.num_neg, inp.steps
    elt = inp.params.user_factors.element_size()
    urow = inp.params.user_factors.shape[1] * elt
    irow = urow + (elt if inp.use_biases else 0)
    tables = bpr_ops._slot_tables(n, inp.n_rounds, inp.use_word,
                                  inp.enc.device)
    lane = torch.arange(b, dtype=torch.int32, device=inp.enc.device)
    users = items = 0
    for t in range(s):
        rows = slice(t * b, (t + 1) * b)
        _, u, negs = bpr_ops._step_decode(
            inp.enc[rows], t * b, lane, inp.rk, inp.lr, tables, inp.u_shift,
            inp.n_items, inp.n_rounds, inp.use_word, inp.wpu)
        users += int(torch.unique(u).numel())
        items += int(torch.unique(torch.cat([inp.p[rows],
                                             negs.reshape(-1)])).numel())
    reads = urow + (1 + n) * irow  # a lane's gathered rows
    return {
        "bytes_per_step": b * (8 + reads)
        + 2 * (users * urow + items * irow) / s,
        "all_rows_bytes_per_step": b * (8 + 3 * reads),
        "distinct_users_per_step": users / s,
        "distinct_items_per_step": items / s,
        "scattered_rows_per_step": b * (2 + n),
    }


def measure(inp: Inputs, variants=DEFAULT_VARIANTS, reps: int = REPS,
            mesh=None) -> dict:
    """Each of ``variants`` on ``inp``, timed in turns (see the module's
    docstring): ``{"mode", "batch", "steps", "reps", "device",
    "variants": {name: {"ms_per_step", "ms_per_step_each",
    "nodes_per_step" (None off a card), "minus_base_ms"}}}`` and, with
    ``base`` among them, ``"bound"`` (:func:`step_bytes`, with
    ``bound_ms_per_step`` at 3.35 TB/s and ``share``, the bound over
    base's ms), ``"triplets"`` (the valid rows times num_neg) and
    ``"updates_per_s"`` at base."""
    device = inp.enc.device
    s = inp.steps
    fns, nodes = {}, {}
    for v in variants:
        step = make_step(v, inp, inp.clone_params(),
                         mesh if v in MESH_VARIANTS else None)

        def run(step=step):
            for t in range(s):
                step(t)

        fns[v], nodes[v] = timing.captured(run, device)
    each = timing.in_turns(fns, device, reps)
    del fns
    base = statistics.median(each["base"]) / s if "base" in each else None
    out = {"mode": inp.mode, "batch": inp.batch, "steps": s, "reps": reps,
           "device": str(device), "item_scatter": inp.item_scatter,
           "sampler": "word" if inp.use_word else "rounds", "variants": {}}
    for v, ms in each.items():
        per = statistics.median(ms) / s
        out["variants"][v] = {
            "ms_per_step": per, "ms_per_step_each": [m / s for m in ms],
            "nodes_per_step": None if nodes[v] is None else nodes[v] / s,
            "minus_base_ms": None if base is None else per - base}
    if base is not None:
        bound = step_bytes(inp)
        bound["bound_ms_per_step"] = bound["bytes_per_step"] / HBM_BPS * 1e3
        bound["share"] = bound["bound_ms_per_step"] / base
        out["bound"] = bound
        out["triplets"] = inp.num_neg * int((inp.enc & 1).sum())
        out["updates_per_s"] = out["triplets"] / (base * s / 1e3)
    return out


def report(parts: dict) -> str:
    """The parts as ``#`` lines: one a variant, then base's bound."""
    lines = [f"# {parts['mode']} inputs, batch {parts['batch']}, "
             f"{parts['steps']} steps, {parts['item_scatter']} scatter, "
             f"{parts['sampler']} decode, {parts['reps']} rounds in turns, "
             f"{parts['device']}",
             "# variant      ms/step  nodes/step  minus base  rounds"]
    for v, r in parts["variants"].items():
        nodes = "-" if r["nodes_per_step"] is None \
            else f"{r['nodes_per_step']:.2f}"
        minus = "-" if r["minus_base_ms"] is None \
            else f"{r['minus_base_ms']:+.4f}"
        lines.append(f"# {v:11s} {r['ms_per_step']:9.4f} {nodes:>10s} "
                     f"{minus:>11s}  " + ", ".join(
                         f"{m:.4f}" for m in r["ms_per_step_each"]))
    if "bound" in parts:
        b = parts["bound"]
        lines.append(
            f"# base's bound: {b['bytes_per_step'] / 1e6:.3f} MB a step "
            f"({b['distinct_users_per_step']:.0f} users and "
            f"{b['distinct_items_per_step']:.0f} items scattered, distinct; "
            f"every scattered row: {b['all_rows_bytes_per_step'] / 1e6:.3f}"
            f" MB), {b['bound_ms_per_step']:.4f} ms at 3.35 TB/s, "
            f"{100 * b['share']:.2f}% of base; "
            f"{parts['updates_per_s'] / 1e6:.3f}M updates/s at base")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=list(DEFAULT_VARIANTS),
                    help=f"any of {', '.join(JAX_VARIANTS)}")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--inputs", choices=("synthetic", "engine"),
                    default="synthetic")
    ap.add_argument("--preset", default="ml20m",
                    help="tools.datagen's preset of --inputs=engine")
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bad = [v for v in args.variants if v not in JAX_VARIANTS]
    if bad:
        ap.error(f"variants {bad}: the command line runs {JAX_VARIANTS} "
                 f"({MESH_VARIANTS} need a mesh: chip_smoke.py phase 10c)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bpr_grouped_micro: no CUDA device; --device=cpu times the "
              "plain ops on the host's clock", file=sys.stderr)
        return 2
    card = None
    if device.type == "cuda":
        from qmf_tpu_torch.tools.bench import card_info

        card = card_info()
        print(f"card: {card['line']}", flush=True)
    t0 = time.perf_counter()
    if args.inputs == "engine":
        from qmf_tpu_torch.models import BPREngine
        from qmf_tpu_torch.tools.bench import load_data
        from qmf_tpu_torch.tools.bpr_decomp import bpr_config

        _, dataset = load_data(args.preset)
        engine = BPREngine(bpr_config(args.batch), device=device)
        engine.init(dataset)
        inp = engine_inputs(engine, args.steps)
    else:
        inp = synthetic_inputs(args.batch, args.steps,
                               "inscan" in args.variants, device=device)
    print(f"inputs {time.perf_counter() - t0:.1f}s", flush=True)
    parts = measure(inp, args.variants, args.reps)
    print(report(parts), flush=True)
    print(json.dumps({"card": card, "preset": args.preset
                      if args.inputs == "engine" else None, **parts}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
