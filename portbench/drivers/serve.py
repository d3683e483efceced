"""Serving: one client in a closed loop of
``qmf_tpu_torch.models.recommend.recommend_top_n`` requests, each the top
``topn`` unseen items of ``batch_users`` users, the users taken in a seeded
shuffled order of all users, wrapping around.

Set-up makes the ratings (the seen sets) and the factors on the device from
the seed, builds the seen set as the ``recommend`` CLI does
(``bpr_ops.make_pos_set``, the ``init`` of serving) and serves the first
request (the warm-up). A share ``twin_share`` of items are twins, an exact
copy of the factors of the item just below them, so that equal scores, and
the rule that the lower index comes first among them, are exercised in
every request.

The check draws ``checked_requests`` of the window's requests from the seed
as they are served (a reservoir: every request of the window is kept with
the same chance, and an answer that is not kept is let go at once, so the
window holds no more answers than the check reads) and, once the window
has closed, scores them in float64 (``portbench/reference/serve.py``):

- ``seen``: served items the user rated (limit 0);
- ``ties``: a served twin whose lower twin is neither served before it nor
  rated (limit 0);
- ``order``: the widest gap by which a served item's reference score lies
  below the reference's score at its position, over the row's best score;
- ``score``: the widest gap between a served score and the reference's
  score of that item, over the row's best score;
- ``twin_rows`` (not compared): the checked rows that serve both twins of
  a pair, so that their order was exercised.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from portbench import data
from portbench.reference import serve as ref


class Driver:
    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.requests = 0
        self.kept = []  # (request, answer): the reservoir the check reads
        self.draws = random.Random(seed)

    def setup(self) -> dict:
        from qmf_tpu_torch.models.recommend import recommend_top_n
        from qmf_tpu_torch.ops.bpr_ops import make_pos_set

        self.recommend = recommend_top_n
        d, t = self.config["data"], self.traffic
        users, items, _ = data.generate(**d, seed=self.seed,
                                        device=self.device)
        nu, ni, k = d["n_users"], d["n_items"], self.config["settings"][
            "nfactors"]
        self.u_idx, self.i_idx = users - 1, items - 1
        g = data.generator(self.seed + 1, self.device)
        self.user_factors = torch.randn((nu, k), generator=g,
                                        device=self.device) / k ** 0.5
        base = torch.randn((ni, k), generator=g, device=self.device)
        twin = torch.rand(ni, generator=g, device=self.device) < \
            t["twin_share"]
        twin[0] = False
        twin[1:] &= ~twin[:-1].clone()  # a twin's lower item is no twin
        src = torch.arange(ni, device=self.device) - twin.long()
        self.item_factors = base[src] / k ** 0.5
        self.twin = twin.cpu().numpy()
        perm = torch.randperm(nu, generator=g, device=self.device).cpu()
        self.order = perm.numpy().astype(np.int32)
        self.stats = {"n_users": nu, "n_items": ni, "nnz": len(users),
                      "batch_users": t["batch_users"], "topn": t["topn"],
                      "nfactors": k}
        t0 = time.perf_counter()
        self.seen = make_pos_set(self.u_idx, self.i_idx, nu,
                                 device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        init_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.call()
        return {"init_s": init_s, "warmup_s": time.perf_counter() - t0}

    def _batch(self, n: int) -> np.ndarray:
        b = self.traffic["batch_users"]
        start = (n * b) % len(self.order)
        return np.take(self.order, np.arange(start, start + b),
                       mode="wrap")

    def call(self):
        n = self.requests
        idx, top = self.recommend(self.user_factors, self.item_factors,
                                  self._batch(n), n=self.traffic["topn"],
                                  seen=self.seen, device=self.device)
        self.requests += 1
        if n:  # request 0 warmed up
            self._keep(n, (idx, top))
        return idx.shape[0], 1

    def _keep(self, n: int, answer) -> None:
        """Reservoir sampling (Algorithm R) of the window's requests
        1, 2, ...: after m of them each is kept with chance k / m."""
        k = self.traffic["checked_requests"]
        if len(self.kept) < k:
            self.kept.append((n, answer))
            return
        slot = self.draws.randrange(n)  # n = the requests seen so far
        if slot < k:
            self.kept[slot] = (n, answer)

    def release(self) -> None:
        del self.seen

    def check(self, precision: str = "float64") -> dict:
        """The numbers compared. ``precision`` puts the reference in that
        precision in the program's place (the control)."""
        keys = torch.unique(torch.from_numpy(
            self.u_idx * self.config["data"]["n_items"] + self.i_idx).to(
                self.device))
        twin = torch.from_numpy(self.twin).to(self.device)
        worst = {"seen": 0.0, "ties": 0.0, "order": 0.0, "score": 0.0}
        twin_rows = 0
        for r, answer in self.kept:
            users = torch.from_numpy(self._batch(r)).to(self.device)
            s = ref.scores(self.user_factors, self.item_factors, users, keys,
                           "float64")
            ref_idx, ref_top = ref.top_n(s, self.traffic["topn"])
            if precision == "float64":
                idx, top = (torch.from_numpy(a).to(self.device)
                            for a in answer)
            else:
                idx, top = ref.top_n(ref.scores(
                    self.user_factors, self.item_factors, users, keys,
                    precision), self.traffic["topn"])
            numbers = _numbers(s, ref_top, idx.long(), top.double(), twin)
            twin_rows += numbers.pop("twin_rows")
            for name, value in numbers.items():
                worst[name] = max(worst[name], value)
        return {**worst, "twin_rows": float(twin_rows)}


def _numbers(s, ref_top, idx, top, twin) -> dict:
    """One request's numbers (see the module's docstring)."""
    scale = ref_top[:, :1].abs()
    got = s.gather(1, idx)
    seen = torch.isinf(got)
    order = torch.where(seen, torch.inf, (ref_top - got) / scale)
    score = torch.where(seen, torch.inf, (top - got).abs() / scale)
    lower = (idx - 1).clamp(min=0)
    n = idx.shape[1]
    earlier = (idx[:, None, :] == lower[:, :, None]) & torch.ones(
        n, n, dtype=torch.bool, device=idx.device).tril(-1)
    lower_seen = torch.isinf(s.gather(1, lower))
    ties = twin[idx] & ~(earlier.any(2) | lower_seen)
    return {"seen": float(seen.sum()), "ties": float(ties.sum()),
            "order": float(order.max()), "score": float(score.max()),
            "twin_rows": int((twin[idx] & earlier.any(2)).any(1).sum())}
