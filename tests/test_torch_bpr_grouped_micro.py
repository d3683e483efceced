"""tools/bpr_grouped_micro.py held against benchmarks/bpr_grouped_micro.py
and the port's production loop, on the CPU, at small sizes.

- each of the JAX probe's seven variants in ``synthetic`` mode, batch 64
  and 3 steps (the tool's numpy inputs with 50 users), against the probe's
  ``make_step`` in ``jax.lax.scan`` on the same arrays: in float32 within
  1e-5 of the largest entry of each table, and in float64 each table's
  change within 1e-8 of its largest change (the changes are ~1e-7, below
  float32's resolution of tables of ~1e-2);
- ``base`` in ``engine`` mode equals bpr_ops._sgd_epoch_scan_grouped_body
  on the same steps, ``torch.equal``, for each ``item_scatter`` with and
  without biases (the refactored loop against qmf_tpu's in float64 is
  tests/test_torch_bpr_ops.py's ``test_sgd_epoch_grouped_three_epochs``);
- ``mesh`` and ``collective`` on a gloo mesh of one rank equal ``base``;
- the report's keys, the bytes bound against a count by hand, the
  ``--device=cpu`` rehearsal, and the nonzero exit without a card.
"""

import importlib
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmf_tpu.ops import bpr_ops as jax_bpr
from qmf_tpu_torch.data import Dataset
from qmf_tpu_torch.models import BPREngine
from qmf_tpu_torch.ops import bpr_ops
from qmf_tpu_torch.tools import bpr_decomp
from qmf_tpu_torch.tools import bpr_grouped_micro as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, STEPS, N_USERS = 64, 3, 50
ENGINE_BATCH = 128


@pytest.fixture(scope="module")
def probe():
    """benchmarks/bpr_grouped_micro.py, imported without its compilation
    cache (it enables one at import unless QMF_TPU_NO_COMPILE_CACHE is
    set) and with sys.path as it was (it puts "." first)."""
    path, env = list(sys.path), os.environ.get("QMF_TPU_NO_COMPILE_CACHE")
    os.environ["QMF_TPU_NO_COMPILE_CACHE"] = "1"
    sys.path.insert(0, REPO)
    try:
        return importlib.import_module("benchmarks.bpr_grouped_micro")
    finally:
        sys.path[:] = path
        if env is None:
            del os.environ["QMF_TPU_NO_COMPILE_CACHE"]
        else:
            os.environ["QMF_TPU_NO_COMPILE_CACHE"] = env


def _jax_run(probe, variant, inp):
    """The probe's ``make_step`` over the steps of ``inp``, as its ``main``
    scans it, on the same arrays."""
    step = probe.make_step(variant, inp.batch, inp.u_shift,
                           jnp.asarray(inp.rk.numpy()), inp.words_per_user)
    params = jax_bpr.BPRParams(*(jnp.asarray(t.numpy())
                                 for t in inp.params))
    carry = (params, jnp.asarray(inp.up.numpy()),
             jnp.asarray(inp.words.numpy()))
    xs = (jnp.asarray(inp.enc.numpy().reshape(inp.steps, inp.batch)),
          jnp.asarray(inp.p.numpy().reshape(inp.steps, inp.batch)),
          jnp.arange(inp.steps, dtype=jnp.int32))
    (out, _, _), _ = jax.lax.scan(step, carry, xs)
    return [np.asarray(t) for t in out[:2]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("variant", tool.JAX_VARIANTS)
def test_synthetic_variant_matches_the_jax_probe(probe, variant, dtype):
    inp = tool.synthetic_inputs(BATCH, STEPS, inscan=True, n_users=N_USERS,
                                dtype=dtype)
    assert inp.up.shape == (BATCH * STEPS, 2)
    assert inp.words.shape == (N_USERS * inp.words_per_user,)
    got = tool.run_steps(variant, inp, inp.clone_params())
    want = _jax_run(probe, variant, inp)
    for g, w, start in zip(got[:2], want, inp.params[:2]):
        g, start = g.numpy(), start.numpy()
        assert g.dtype == w.dtype
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
        if dtype == torch.float64:
            change = np.abs(w - start).max()
            assert change > 0
            assert np.abs((g - start) - (w - start)).max() <= 1e-8 * change
    # the item biases are not trained without biases
    assert torch.equal(got.item_biases, inp.params.item_biases)


def _ratings(seed=5, n_users=50, n_items=75, n_pos=600):
    rng = np.random.default_rng(seed)
    u = np.concatenate([np.arange(n_users),
                        rng.integers(0, n_users, n_pos - n_users)])
    i = np.concatenate([np.arange(n_items),
                        rng.integers(0, n_items, n_pos - n_items)])[:n_pos]
    return Dataset(u + 1, i + 1, np.ones(n_pos))


def _engine(**kw):
    eng = BPREngine(bpr_decomp.bpr_config(ENGINE_BATCH, **kw), device="cpu")
    eng.init(_ratings())
    assert eng._grouped
    return eng


@pytest.mark.parametrize("use_biases", [False, True])
@pytest.mark.parametrize("item_scatter", ["seq", "merged", "dense"])
def test_engine_base_equals_the_production_loop(item_scatter, use_biases):
    eng = _engine(item_scatter=item_scatter, use_biases=use_biases)
    inp = tool.engine_inputs(eng, STEPS)
    assert (inp.mode, inp.batch, inp.steps) == ("engine", ENGINE_BATCH,
                                                STEPS)
    assert inp.use_word and inp.wpu == eng._pos_bitmap.words_per_user
    assert (inp.item_scatter, inp.use_biases) == (item_scatter, use_biases)
    # views of pass 1's stream, not a copy
    assert inp.enc._base is not None and inp.p._base is not None
    start = [t.clone() for t in eng.params]
    check = tool.production_check(inp)
    assert check == {"equal": True, "max_abs_diff": 0.0}
    got = tool.run_steps("base", inp, inp.clone_params())
    want = bpr_ops._sgd_epoch_scan_grouped_body(
        inp.clone_params(), inp.enc, inp.p, inp.rk, inp.lr,
        eng.config.user_lambda, eng.config.item_lambda,
        eng.config.bias_lambda, use_biases=use_biases,
        batch_size=ENGINE_BATCH, num_neg=3, n_items=eng.nitems, n_rounds=4,
        u_shift=7, item_scatter=item_scatter, sampler="word",
        wpu=inp.wpu)
    for g, w, s in zip(got, want, start):
        assert torch.equal(g, w)
    assert not torch.equal(got.user_factors, start[0])
    assert torch.equal(got.item_biases, start[2]) != use_biases
    # the engine's own parameters are left as they were
    assert all(torch.equal(a, b) for a, b in zip(eng.params, start))


def test_engine_rounds_and_bloom_decode_equal_the_production_loop():
    for kw in ({"neg_sampler": "rounds"}, {"bloom": True}):
        inp = tool.engine_inputs(_engine(**kw), STEPS)
        assert not inp.use_word and inp.wpu == 0
        assert tool.production_check(inp)["equal"]


def test_engine_inputs_refuse_more_steps_than_the_stream():
    eng = _engine()
    with pytest.raises(ValueError, match="the stream holds"):
        tool.engine_inputs(eng, 100)


def test_measure_every_variant_on_engine_inputs():
    inp = tool.engine_inputs(_engine(), STEPS)
    parts = tool.measure(inp, tool.JAX_VARIANTS, reps=2)
    assert list(parts["variants"]) == list(tool.JAX_VARIANTS)
    assert (parts["mode"], parts["batch"], parts["steps"], parts["reps"],
            parts["device"]) == ("engine", ENGINE_BATCH, STEPS, 2, "cpu")
    for name, r in parts["variants"].items():
        assert set(r) == {"ms_per_step", "ms_per_step_each",
                          "nodes_per_step", "minus_base_ms"}
        assert len(r["ms_per_step_each"]) == 2
        assert all(math.isfinite(x) and x > 0
                   for x in [r["ms_per_step"], *r["ms_per_step_each"]])
        assert r["nodes_per_step"] is None  # no graph on the CPU
        assert math.isclose(r["minus_base_ms"], r["ms_per_step"]
                            - parts["variants"]["base"]["ms_per_step"])
    assert parts["triplets"] == 3 * int((inp.enc & 1).sum())
    assert parts["updates_per_s"] > 0
    assert set(parts["bound"]) == {
        "bytes_per_step", "all_rows_bytes_per_step",
        "distinct_users_per_step", "distinct_items_per_step",
        "scattered_rows_per_step", "bound_ms_per_step", "share"}
    assert parts["bound"]["share"] > 0
    text = tool.report(parts)
    assert all(line.startswith("# ") for line in text.splitlines())
    assert len(text.splitlines()) == 2 + len(tool.JAX_VARIANTS) + 1
    # without base: no bound and no difference from it
    parts = tool.measure(inp, ["noneg"], reps=1)
    assert "bound" not in parts
    assert parts["variants"]["noneg"]["minus_base_ms"] is None
    assert len(tool.report(parts).splitlines()) == 3


def test_variants_change_what_they_say():
    """On engine inputs: noscatter and compute scale the tables, noneg
    leaves the negatives' rows as merged would not, nogather and inscan
    train, and every variant starts from its own clone."""
    inp = tool.engine_inputs(_engine(), STEPS)
    out = {v: tool.run_steps(v, inp, inp.clone_params())
           for v in tool.JAX_VARIANTS}
    start = inp.params
    for v, params in out.items():
        assert torch.isfinite(params.user_factors).all()
        assert not torch.equal(params.user_factors, start.user_factors), v
    ratio = out["noscatter"].user_factors / start.user_factors
    assert torch.allclose(ratio, ratio.flatten()[0].expand_as(ratio))
    for a, b in (("base", "noneg"), ("base", "nogather"), ("base", "inscan"),
                 ("noscatter", "compute")):
        assert not torch.equal(out[a].item_factors, out[b].item_factors)
    # merged sums the same rows in another order
    assert torch.allclose(out["base"].item_factors,
                          out["merged"].item_factors, atol=1e-6)


def test_step_bytes_against_a_count_by_hand():
    """Two steps of 4 rows, users and positives repeated within a step;
    the negatives decoded from round 0's hash."""
    k, n_items = 5, 7
    users = np.array([[3, 3, 1, 0], [2, 2, 2, 2]], np.int32)
    pos = np.array([[4, 4, 4, 1], [0, 6, 0, 6]], np.int32)
    enc = (users << 7) | 1
    rk = np.array([[11, 22, 33]] * 4, np.int32)
    params = bpr_ops.BPRParams(torch.zeros(4, k), torch.zeros(n_items, k),
                               torch.zeros(n_items))
    inp = tool.Inputs(
        mode="synthetic", enc=torch.from_numpy(enc.reshape(-1)),
        p=torch.from_numpy(pos.reshape(-1)), rk=torch.from_numpy(rk),
        lr=torch.tensor(0.1), params=params, batch=4, num_neg=3,
        n_items=n_items, n_rounds=4, use_word=False, wpu=0, user_lambda=0.0,
        item_lambda=0.0, bias_lambda=0.0, use_biases=False,
        item_scatter="seq")
    users_seen = items_seen = 0
    for t in range(2):
        f = torch.arange(t * 4 * 3, (t + 1) * 4 * 3, dtype=torch.int32)
        negs = bpr_ops._cand_hash(torch.from_numpy(rk[0]), f, n_items)
        users_seen += len(set(users[t].tolist()))
        items_seen += len(set(pos[t].tolist()) | set(negs.tolist()))
    row = k * 4
    lane = 8 + 5 * row  # the stream's two words, then 5 rows read
    got = tool.step_bytes(inp)
    assert got["distinct_users_per_step"] == users_seen / 2 == 2.0
    assert got["distinct_items_per_step"] == items_seen / 2
    assert items_seen < 2 * 4 * 4  # rows repeat
    assert got["bytes_per_step"] == 4 * lane + 2 * row * (
        users_seen + items_seen) / 2
    assert got["all_rows_bytes_per_step"] == 4 * (8 + 3 * 5 * row)
    assert got["scattered_rows_per_step"] == 4 * 5
    # biases: an item's bias travels beside its row
    inp.use_biases = True
    got = tool.step_bytes(inp)
    assert got["bytes_per_step"] == 4 * (8 + row + 4 * (row + 4)) + 2 * (
        users_seen * row + items_seen * (row + 4)) / 2


@pytest.fixture
def one_rank_mesh():
    """A gloo group of one rank on the CPU, in this process."""
    import torch.distributed as dist

    from qmf_tpu_torch.parallel import launch, make_mesh, multihost

    multihost.initialize(f"127.0.0.1:{launch.free_port()}", 1, 0,
                         backend="gloo", device="cpu")
    try:
        yield make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("use_biases", [False, True])
def test_mesh_and_collective_equal_base_on_one_gloo_rank(one_rank_mesh,
                                                        use_biases):
    mesh = one_rank_mesh
    assert mesh.size == 1 and mesh.backend == "gloo"
    inp = tool.engine_inputs(_engine(use_biases=use_biases), STEPS)
    base = tool.run_steps("base", inp, inp.clone_params())
    meshed = tool.run_steps("mesh", inp, inp.clone_params(), mesh)
    assert all(torch.equal(a, b) for a, b in zip(base, meshed))
    # the collective: step 0's ids and gradients, gathered whole, equal
    # what base computes at step 0; it updates nothing
    params = inp.clone_params()
    got = tool.make_step("collective", inp, params, mesh)(0)
    tables = bpr_ops._slot_tables(3, 4, True, "cpu")
    lane = torch.arange(ENGINE_BATCH, dtype=torch.int32)
    w, u, negs = bpr_ops._step_decode(
        inp.enc[:ENGINE_BATCH], 0, lane, inp.rk, inp.lr, tables, 7,
        inp.n_items, 4, True, inp.wpu)
    p = inp.p[:ENGINE_BATCH]
    rows = bpr_ops._step_gathers(inp.params, u, p, negs, use_biases)
    want = (u, p, negs, *bpr_ops._step_grads(
        w, *rows, inp.user_lambda, inp.item_lambda, inp.bias_lambda))
    assert len(got) == len(want) == 8
    for g, x in zip(got, want):
        assert (g is None) == (x is None)
        if x is not None:
            assert g.dtype == x.dtype and torch.equal(g, x)
    assert all(torch.equal(a, b) for a, b in zip(params, inp.params))
    parts = tool.measure(inp, ["base", "mesh", "collective"], reps=1,
                         mesh=mesh)
    assert list(parts["variants"]) == ["base", "mesh", "collective"]


def test_a_mesh_goes_with_the_mesh_variants_only():
    inp = tool.synthetic_inputs(BATCH, 1, n_users=N_USERS)
    for variant in tool.MESH_VARIANTS:
        with pytest.raises(ValueError, match="a mesh goes with"):
            tool.make_step(variant, inp, inp.clone_params())
    with pytest.raises(ValueError, match="a mesh goes with"):
        tool.make_step("base", inp, inp.clone_params(), mesh=object())
    with pytest.raises(ValueError, match="unknown variant"):
        tool.make_step("Base", inp, inp.clone_params())


def test_cpu_rehearsal_prints_the_table_then_json(capsys):
    assert tool.main(["--device=cpu", "--batch", "64", "--steps", "2",
                      "--reps", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    got = json.loads(lines[-1])
    assert got["card"] is None and got["device"] == "cpu"
    assert (got["mode"], got["batch"], got["steps"]) == ("synthetic", 64, 2)
    assert list(got["variants"]) == list(tool.DEFAULT_VARIANTS)
    assert got["bound"]["distinct_users_per_step"] <= 64
    table = [ln for ln in lines if ln.startswith("#")]
    assert len(table) == 2 + len(tool.DEFAULT_VARIANTS) + 1
    assert lines[-2] == table[-1]


def test_cpu_rehearsal_of_engine_inputs(capsys):
    assert tool.main(["--device=cpu", "--inputs=engine", "--preset=ml100k",
                      "--batch", "1024", "--steps", "3", "--reps", "1",
                      "base", "inscan"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (got["mode"], got["preset"], got["batch"], got["sampler"]) == (
        "engine", "ml100k", 1024, "word")
    assert list(got["variants"]) == ["base", "inscan"]


def test_mesh_variants_are_refused_on_the_command_line(capsys):
    with pytest.raises(SystemExit) as exc:
        tool.main(["--device=cpu", "collective"])
    assert exc.value.code == 2
    assert "need a mesh" in capsys.readouterr().err


def test_no_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([]) != 0
    assert tool.main(["--inputs=engine", "--preset=ml100k"]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err


def test_no_card_exits_nonzero_as_a_program():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "qmf_tpu_torch.tools.bpr_grouped_micro",
         "--steps", "1"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == "" and "no CUDA device" in proc.stderr
