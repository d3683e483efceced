"""BPR training: a closed loop of ``BPREngine.optimize()`` calls of one
epoch each on one initialised engine (the rate still decays an epoch), each
what the ``bpr`` CLI runs an epoch: the draws, pass 1 and the SGD loop (on a
card one CUDA graph, replayed), the finiteness read and the eval loss.

Set-up makes the ratings from the seed, initialises the engine and makes
the first ``checked_calls`` calls (the first warms up and captures); the
check runs the float64 reference (``portbench/reference/bpr.py``) through
the same epochs on the same draws from the same start and compares the
factors after each, and a loss of each on triplets the benchmark draws
(``portbench/compare.py``).
"""

from __future__ import annotations

import time

import torch

from portbench import compare, data
from portbench.compare import rows_in_order
from portbench.reference import bpr as ref

EVAL_TRIPLETS = 1 << 20


class Driver:
    FAULTS = {"drop_half": {"drop_half": True}}

    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.settings = dict(config["settings"], init_seed=seed % (1 << 31))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _params(self):
        p = self.engine.params
        return (p.user_factors.detach().clone(),
                p.item_factors.detach().clone())

    def setup(self) -> dict:
        from qmf_tpu_torch import BPRConfig
        from qmf_tpu_torch.data import Dataset
        from qmf_tpu_torch.models import BPREngine

        self.ratings = data.generate(**self.config["data"], seed=self.seed,
                                     device=self.device)
        cfg = BPRConfig(**self.settings)
        if cfg.use_biases:
            raise ValueError("the BPR reference has no biases")
        self.engine = eng = BPREngine(cfg, device=self.device,
                                      **self.config["engine_args"])
        t0 = time.perf_counter()
        eng.init(Dataset(*self.ratings))
        self._sync()
        init_s = time.perf_counter() - t0
        # from the data, not the program: the positives are the ratings of
        # 1 or more (the pairs are distinct), each with its negatives
        n_pos = int((self.ratings[2] >= 1.0).sum())
        self.stats = {"n_pos": n_pos,
                      "triplets": n_pos * cfg.num_negative_samples}
        self.states = [self._params()]
        t0 = time.perf_counter()
        for i in range(self.traffic["checked_calls"]):
            eng.optimize()
            if i == 0:
                self._sync()
                warmup_s = time.perf_counter() - t0
            self.states.append(self._params())
        return {"init_s": init_s, "warmup_s": warmup_s}

    def call(self):
        self.engine.optimize()  # its finiteness read waits for the device
        return self.stats["triplets"], 1

    def release(self) -> None:
        self.user_ids = self.engine.user_index.ids
        self.item_ids = self.engine.item_index.ids
        del self.engine

    def check(self, precision: str = "float64",
              drop_half: bool = False) -> dict:
        """The numbers compared. ``precision`` other than float64 or
        ``drop_half`` puts the reference in the program's place, in that
        precision or with each step's second half left out (the control
        and a planted fault)."""
        prob = ref.Problem(*self.ratings, self.settings["batch_size"],
                           self.device)
        if precision == "float64" and not drop_half:
            program = [(rows_in_order(u, self.user_ids, prob.user_ids),
                        rows_in_order(v, self.item_ids, prob.item_ids))
                       for u, v in self.states]
        else:
            program = ref.train(prob, self.traffic["checked_calls"],
                                self.settings, precision, drop_half)
        reference = ref.train(prob, self.traffic["checked_calls"],
                              self.settings, "float64")
        g = data.generator(self.seed + 1, self.device)
        n = min(EVAL_TRIPLETS, prob.n_pos)
        pick = torch.randint(0, prob.n_pos, (n,), generator=g,
                             device=self.device)
        triplets = (prob.users[pick].long(), prob.items[pick].long(),
                    torch.randint(0, prob.n_items, (n,), generator=g,
                                  device=self.device))
        return compare.training_numbers(
            reference[0], program[1:], reference[1:],
            [ref.eval_loss(*p, triplets) for p in program[1:]],
            [ref.eval_loss(*r, triplets) for r in reference[1:]])
