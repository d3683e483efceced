"""WALS training: a closed loop of ``WALSEngine.optimize()`` calls on one
initialised engine, each the configuration's ``nepochs`` epochs as the
``wals`` CLI runs them (on a card the epoch is a CUDA graph, replayed).

Set-up makes the ratings from the seed, initialises the engine and makes
the first ``checked_calls`` calls (the first warms up and captures); the
check runs the float64 reference through the same calls from the same start
and compares the factors and losses after each (``portbench/compare.py``),
with two more numbers after the last checked call:

- ``solve3``: the gap between the program's item factors and the float64
  solve of the item side from the program's own user factors (its last
  half-epoch, checked by itself), in norm, over the reference's norm;
- ``scores3``: the gap between the program's scores u.v over the rated
  pairs and the reference's, in norm, over the reference's norm.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import compare, data
from portbench.compare import rows_in_order
from portbench.reference import wals as ref


class Driver:
    FAULTS = {"drop_half": {"drop_half": True}}

    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.settings = dict(config["settings"], init_seed=seed % (1 << 31))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self) -> dict:
        from qmf_tpu_torch import WALSConfig, kernels
        from qmf_tpu_torch.data import Dataset
        from qmf_tpu_torch.models import WALSEngine

        if self.device.type == "cuda":
            kernels.load()
        self.ratings = data.generate(**self.config["data"], seed=self.seed,
                                     device=self.device)
        cfg = WALSConfig(**self.settings)
        self.engine = eng = WALSEngine(cfg, device=self.device)
        t0 = time.perf_counter()
        eng.init(Dataset(*self.ratings))
        self._sync()
        init_s = time.perf_counter() - t0
        self.stats = {"nnz": len(self.ratings[0]),
                      "n_users": len(np.unique(self.ratings[0])),
                      "n_items": len(np.unique(self.ratings[1])),
                      "epochs": cfg.nepochs}
        self.losses = []
        eng.progress_cb = lambda epoch, loss, wall: self.losses.append(loss)
        self.states = []
        t0 = time.perf_counter()
        for i in range(self.traffic["checked_calls"]):
            eng.optimize()
            if i == 0:
                self._sync()
                warmup_s = time.perf_counter() - t0
            self.states.append((eng.user_factors, eng.item_factors))
        return {"init_s": init_s, "warmup_s": warmup_s}

    def call(self):
        self.engine.optimize()  # its one host read waits for the device
        n = self.stats["epochs"]
        return n, n

    def release(self) -> None:
        eng = self.engine
        self.user_ids = eng.user_index.ids
        self.item_ids = eng.item_index.ids
        self.losses = self.losses[: self.traffic["checked_calls"]]
        del self.engine, eng

    def check(self, precision: str = "float64",
              drop_half: bool = False) -> dict:
        """The numbers compared. ``precision`` other than float64 or
        ``drop_half`` puts the reference in the program's place, in that
        precision or with the second half of each chunk's rows left
        unsolved (the control and a planted fault)."""
        s = self.settings
        prob = ref.Problem(*self.ratings, self.device)
        v0 = ref.initial_items(prob.n_items, s["nfactors"], s["init_seed"],
                               s["init_distribution_bound"])
        start = (torch.zeros((prob.n_users, s["nfactors"]),
                             device=self.device),
                 torch.from_numpy(v0).to(self.device))
        want_u = np.unique(self.ratings[0])
        want_i = np.unique(self.ratings[1])
        if precision == "float64" and not drop_half:
            program = [(rows_in_order(u, self.user_ids, want_u),
                        rows_in_order(v, self.item_ids, want_i))
                       for u, v in self.states]
            prog_losses = self.losses
        else:
            program, prog_losses = self._reference(prob, start[1], precision,
                                                   drop_half)
        reference, ref_losses = self._reference(prob, start[1], "float64")
        out = compare.training_numbers(start, program, reference,
                                       prog_losses, ref_losses)
        (u_p, v_p), (u_r, v_r) = program[-1], reference[-1]
        out["scores3"] = _score_gap(prob.user_side, u_p, v_p, u_r, v_r)
        v_one, _ = ref.solve_side(u_p, prob.item_side,
                                  s["confidence_weight"],
                                  s["regularization_lambda"], "float64")
        out["solve3"] = float(torch.linalg.vector_norm(v_p.double() - v_one)
                              / torch.linalg.vector_norm(v_one))
        return out

    def _reference(self, prob, v, precision, drop_half=False):
        s = self.settings
        states, losses = [], []
        for _ in range(self.traffic["checked_calls"]):
            u, v, step_losses = ref.epochs(
                prob, v, s["nepochs"], s["confidence_weight"],
                s["regularization_lambda"], precision, drop_half)
            states.append((u, v))
            losses.append(step_losses[-1])
        return states, losses


def _score_gap(side, u_p, v_p, u_r, v_r, chunk: int = 1 << 22) -> float:
    """The norm of the gap between two factorizations' scores u.v over the
    rated pairs, over the norm of the second's."""
    rows = torch.repeat_interleave(
        torch.arange(side.n_rows, device=side.cols.device), side.degree)
    gap = ref_sq = 0.0
    for s in range(0, rows.shape[0], chunk):
        r, c = rows[s:s + chunk], side.cols[s:s + chunk]
        s_p = (u_p[r].double() * v_p[c].double()).sum(1)
        s_r = (u_r[r].double() * v_r[c].double()).sum(1)
        gap += float(((s_p - s_r) ** 2).sum())
        ref_sq += float((s_r ** 2).sum())
    return (gap / ref_sq) ** 0.5
