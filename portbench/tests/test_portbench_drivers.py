"""Each cell's run at a CPU test's size: the harness with its look for a
card skipped, the program against the reference. A sound run is correct;
the control (the reference in the configuration's control precision in the
program's place) is not; and each fault the cell can have, planted under
the timed path, makes ``correct`` false."""

import time

import numpy as np
import pytest
import torch

from portbench import harness, spec
from portbench.calibrate import readings

CELLS = ["wals_ml20m_k64.train", "bpr_ml20m_k30.train",
         "wals_ml20m_k64.serve"]
SEED = 2**33 + 17  # more than 32 signed bits hold


def run(root, name, traced=False):
    cell = spec.resolve(name, root=root)
    return harness.run_cell(cell, SEED, 0.5, traced, "cpu",
                            time.perf_counter(), root=root)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(tiny_root, name, traced):
    r = run(tiny_root, name, traced)
    assert r.correct, r.checks
    assert r.attempted >= 1 and r.failed == 0
    cell = spec.resolve(name, root=tiny_root)
    wanted = cell.per_layer if traced else cell.end_to_end
    got = set(r.metrics)
    # on the CPU the device's shares are not read; the host clock's are
    device_only = {m["name"] for m in wanted if m["source"] == "device_trace"}
    assert got == {m["name"] for m in wanted} - device_only
    assert all(v["value"] > 0 for v in r.metrics.values())
    if traced:
        assert r.breakdown == {"device_ops": [], "idle_gaps": []}


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny_root, name):
    cell = spec.resolve(name, root=tiny_root)
    ways = {r["way"]: r for r in readings(cell, SEED, torch.device("cpu"))}
    driver = spec.driver_module(cell).Driver
    assert set(ways) == {"program", "control", *getattr(driver, "FAULTS",
                                                        {})}
    for way, values in ways.items():
        correct, _ = harness.verdict(values, cell.limits)
        assert correct == (way == "program"), (way, values)
        assert values["correct"] == correct


def _unchanged_wals(monkeypatch):
    from qmf_tpu_torch.models import WALSEngine
    monkeypatch.setattr(WALSEngine, "optimize", lambda self: None)


def _half_rows_wals(monkeypatch):
    from qmf_tpu_torch.ops import als_ops
    whole = als_ops._whole_class

    def half(x, mesh):
        x = whole(x, mesh).clone()
        x[(x.shape[0] + 1) // 2:] = 0
        return x
    monkeypatch.setattr(als_ops, "_whole_class", half)


def _unchanged_bpr(monkeypatch):
    from qmf_tpu_torch.models import BPREngine
    monkeypatch.setattr(BPREngine, "_epoch", lambda self: None)


def _half_batch_bpr(monkeypatch):
    from qmf_tpu_torch.ops import bpr_ops
    writes = bpr_ops._step_writes

    def half(params, u, p, negs, du, dp, dn, dbp, dbn, item_scatter):
        h = u.shape[0] // 2
        return writes(params, u[:h], p[:h], negs[:h], du[:h], dp[:h],
                      dn[:h], dbp, dbn, item_scatter)
    monkeypatch.setattr(bpr_ops, "_step_writes", half)


def _altered_answer(monkeypatch):
    from qmf_tpu_torch.models import recommend
    top_n = recommend._top_n

    def altered(scores, n):
        idx, top = top_n(scores, n)
        idx[0, 0] = (idx[0, 0] + 1) % scores.shape[1]
        return idx, top
    monkeypatch.setattr(recommend, "_top_n", altered)


def _higher_twin_first(monkeypatch):
    from qmf_tpu_torch.models import recommend
    top_n = recommend._top_n

    def reversed_ties(scores, n):
        idx, top = top_n(scores.flip(1), n)
        return scores.shape[1] - 1 - idx, top
    monkeypatch.setattr(recommend, "_top_n", reversed_ties)


@pytest.mark.parametrize("name,plant", [
    ("wals_ml20m_k64.train", _unchanged_wals),
    ("wals_ml20m_k64.train", _half_rows_wals),
    ("bpr_ml20m_k30.train", _unchanged_bpr),
    ("bpr_ml20m_k30.train", _half_batch_bpr),
    ("wals_ml20m_k64.serve", _altered_answer),
    ("wals_ml20m_k64.serve", _higher_twin_first),
])
def test_planted_fault_is_not_correct(tiny_root, monkeypatch, name, plant):
    plant(monkeypatch)
    r = run(tiny_root, name)
    assert not r.correct, r.checks
    if plant is _higher_twin_first:  # equal scores: only the order is wrong
        assert r.checks["ties"]["value"] > 0
        assert r.checks["order"]["value"] == 0


def test_reference_bpr_follows_the_programs_draws(tiny_root):
    """The reference's shuffle and negatives are the program's: the two
    agree to float32 rounding after three epochs (drift3 is read by the
    check; here the positives and negatives are checked by themselves)."""
    from qmf_tpu_torch import BPRConfig
    from qmf_tpu_torch.data import Dataset
    from qmf_tpu_torch.models import BPREngine
    from qmf_tpu_torch.ops import bpr_ops

    from portbench import data
    from portbench.reference import bpr as ref

    cell = spec.resolve("bpr_ml20m_k30.train", root=tiny_root)
    settings = dict(cell.config["settings"], init_seed=5)
    ratings = data.generate(**cell.config["data"], seed=SEED, device="cpu")
    eng = BPREngine(BPRConfig(**settings), device="cpu")
    eng.init(Dataset(*ratings))
    seen = {}
    body = bpr_ops._sample_pack_grouped_body

    def spy(*args, **kw):
        enc, p, n_over = body(*args, **kw)
        seen["p"] = p.clone()
        return enc, p, n_over
    bpr_ops._sample_pack_grouped_body = spy
    try:
        eng.optimize()
    finally:
        bpr_ops._sample_pack_grouped_body = body
    prob = ref.Problem(*ratings, settings["batch_size"], "cpu")
    gen = torch.Generator()
    gen.manual_seed(5)
    _, ks = ref.draw_keys(gen, settings["neg_resample_rounds"])
    b = settings["batch_size"].bit_length() - 1
    idx = ref.feistel(ks, prob.users.shape[0] >> b, b)
    np.testing.assert_array_equal(seen["p"].numpy(), prob.items[idx].numpy())


def test_serve_keeps_only_the_checked_answers(tiny_root):
    """The serve driver holds no more answers than its check reads, drawn
    from the seed: the same seed keeps the same requests."""
    cell = spec.resolve("wals_ml20m_k64.serve", root=tiny_root)
    k = cell.traffic["checked_requests"]
    kept = []
    for _ in range(2):
        drv = spec.driver_module(cell).Driver(cell.config, cell.traffic,
                                              SEED, torch.device("cpu"))
        drv.setup()
        for _ in range(5 * k):
            drv.call()
        assert len(drv.kept) == k
        kept.append(sorted(n for n, _ in drv.kept))
    assert kept[0] == kept[1]
    assert len(set(kept[0])) == k and 1 <= min(kept[0])
    assert max(kept[0]) <= 5 * k


def test_serve_reservoir_is_uniform():
    """Every request of the window is kept with the same chance: over many
    seeds, the first half of 200 requests holds half of what is kept."""
    from portbench.drivers.serve import Driver

    k, n, seeds, first = 8, 200, 500, 0
    for seed in range(seeds):
        drv = Driver({}, {"checked_requests": k}, seed, "cpu")
        for r in range(1, n + 1):
            drv._keep(r, None)
        first += sum(r <= n // 2 for r, _ in drv.kept)
    assert abs(first - seeds * k / 2) < 200  # ~6 standard deviations
