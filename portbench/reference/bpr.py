"""BPR by synchronous minibatch SGD, plainly, on the program's draws.

An epoch visits every positive pair (rating >= 1.0) once, in a shuffled
order, with ``num_neg`` negatives each; a step takes ``batch`` pairs, reads
every row it needs before it writes any, and adds the gradients of its
triplets (qmf's BPREngine update, Hogwild's concurrency made synchronous):

    d  = <p_u, q_i> - <p_u, q_n>,   e = lr / (1 + exp(d))
    p_u += sum_n e (q_i - q_n) - num_neg * user_lambda * lr * p_u
    q_i += sum_n e p_u         - num_neg * item_lambda * lr * q_i
    q_n += -e p_u              - item_lambda * lr * q_n      (each n)

The shuffle and the negatives are what the program draws from its seeded
generator: two integer draws an epoch (the round keys and the six shuffle
keys), then pure integer hashes of them. This module follows those draws
step by step, so it fixes the hashes, the index order (ids in order of first
appearance) and the sampler's rules, which are written out here from their
definitions: the shuffle is a three-round Feistel bijection on
m * 2**log2(batch) stream rows; slot j of row f's negative is the first of
rounds 0..R-2 whose candidate, bit (b0 + DELTA[j (R-1) + r]) & 31 of the
row's one probe word of the user's 32-item blocks, is not a positive (an id
past the catalog counts as one), else round R-1's hashed candidate,
accepted unchecked. Padding rows weigh nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import storage_dtype

WORD_DELTA = (0, 11, 19, 5, 16, 27, 3, 9, 25, 7, 14, 22, 29, 2, 13)
M32 = 0xFFFFFFFF


def first_occurrence(raw: np.ndarray):
    """(distinct ids in order of first appearance, each element's rank)."""
    uniq, first, inverse = np.unique(raw, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[order] = np.arange(len(uniq))
    return raw[np.sort(first)], rank[inverse]


class Problem:
    """The positive pairs as the reference indexes and pads them."""

    def __init__(self, users, items, values, batch: int, device):
        keep = values >= 1.0
        self.user_ids, u = first_occurrence(users[keep])
        self.item_ids, i = first_occurrence(items[keep])
        self.n_users, self.n_items = len(self.user_ids), len(self.item_ids)
        self.n_pos = len(u)
        pad = (-self.n_pos) % batch
        self.device = dev = torch.device(device)
        self.users = torch.from_numpy(
            np.concatenate([u, np.zeros(pad, np.int64)])).to(dev, torch.int32)
        self.items = torch.from_numpy(
            np.concatenate([i, np.zeros(pad, np.int64)])).to(dev, torch.int32)
        self.keys = torch.unique(
            torch.from_numpy(u * self.n_items + i).to(dev))
        self.batch = batch

    def is_positive(self, users: torch.Tensor, items: torch.Tensor):
        """Whether (user, item) is a positive pair; ids past the catalog
        count as positives."""
        q = users.to(torch.int64) * self.n_items + items.to(torch.int64)
        at = torch.searchsorted(self.keys, q).clamp(max=self.keys.shape[0] - 1)
        return (self.keys[at] == q) | (items >= self.n_items)


def initial_params(n_users: int, n_items: int, k: int, seed: int,
                   bound: float):
    """qmf's uniform(-bound, bound) start, users then items, from
    ``np.random.default_rng(seed)``, in the float32 the configuration
    stores."""
    rng = np.random.default_rng(seed)
    uf = rng.uniform(-bound, bound, size=(n_users, k)).astype(np.float32)
    itf = rng.uniform(-bound, bound, size=(n_items, k)).astype(np.float32)
    return uf, itf


def draw_keys(generator: torch.Generator, n_rounds: int):
    """An epoch's two draws: round keys (n_rounds, 3) and shuffle keys (6,),
    int32 in [0, 2**30)."""
    def draw(shape):
        return torch.randint(0, 1 << 30, shape, generator=generator,
                             device=generator.device, dtype=torch.int32)
    return draw((n_rounds, 3)), draw((6,))


def feistel(ks: torch.Tensor, m: int, b: int) -> torch.Tensor:
    """The stream position read at each shuffled position: a bijection on
    [0, m * 2**b), int32 arithmetic that wraps."""
    mask_b = (1 << b) - 1

    def h(x, key):
        x = x * ((key << 1) | 1)
        x = x ^ ((x >> 7) ^ (x >> 13))
        return x * 0x6C6272E5 + key

    x = torch.arange(m << b, dtype=torch.int32, device=ks.device)
    q, r = x >> b, x & mask_b
    for i in range(3):
        r = r ^ (h(q, ks[2 * i]) & mask_b)
        q = (q + (h(r, ks[2 * i + 1]) & 0x3FFFFFFF)) % m
        r = (r * ((ks[2 * i] << 1) | 1)) & mask_b
        r = r ^ (r >> max(1, b // 2))
    return q * (1 << b) + r


def mix32(rk: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    x = f * ((rk[0] << 1) | 1)
    x = x ^ ((x >> 7) ^ (x >> 13))
    x = x * ((rk[1] << 1) | 1)
    x = x ^ (x >> 11)
    x = x * ((rk[2] << 1) | 1)
    return x ^ (x >> 9)


def hashed_item(rk: torch.Tensor, f: torch.Tensor, n_items: int):
    """Round key ``rk``'s candidate for slot ``f``: the hash as an unsigned
    32-bit number, modulo the catalog."""
    return ((mix32(rk, f).to(torch.int64) & M32) % n_items).to(torch.int32)


def negatives(problem: Problem, rk: torch.Tensor, users: torch.Tensor,
              num_neg: int) -> torch.Tensor:
    """(rows, num_neg) negatives of the shuffled rows of ``users``."""
    n_rounds = rk.shape[0]
    dev = users.device
    row = torch.arange(users.shape[0], dtype=torch.int32, device=dev)
    wpu = (problem.n_items + 31) // 32
    x = mix32(rk[0], row)
    b0 = x & 31
    word = ((x >> 5) & ((1 << 27) - 1)) % wpu
    cols = []
    for j in range(num_neg):
        f = row * num_neg + j
        neg = hashed_item(rk[n_rounds - 1], f, problem.n_items)
        for r in range(n_rounds - 2, -1, -1):
            cand = word * 32 + ((b0 + WORD_DELTA[j * (n_rounds - 1) + r])
                                & 31)
            neg = torch.where(problem.is_positive(users, cand), neg, cand)
        cols.append(neg)
    return torch.stack(cols, dim=1)


def epoch(problem: Problem, uf: torch.Tensor, itf: torch.Tensor,
          generator: torch.Generator, lr: float, cfg: dict,
          drop_half: bool = False) -> None:
    """One epoch on ``uf`` and ``itf`` in place, in their dtype.
    ``drop_half`` plants a fault for the harness's tests: each step keeps
    the first half of its rows, as a step whose mean is taken over the
    rest."""
    num_neg, batch = cfg["num_negative_samples"], problem.batch
    ul, il = cfg["user_lambda"], cfg["item_lambda"]
    rk, ks = draw_keys(generator, cfg["neg_resample_rounds"])
    n_stream = problem.users.shape[0]
    b = batch.bit_length() - 1
    idx = feistel(ks, n_stream >> b, b)
    users, items = problem.users[idx], problem.items[idx]
    valid = idx < problem.n_pos
    negs = negatives(problem, rk, users, num_neg)
    w_all = valid.to(uf.dtype) * lr
    keep = batch // 2 if drop_half else batch
    for s in range(0, n_stream, batch):
        u, p = users[s:s + keep], items[s:s + keep]
        n, w = negs[s:s + keep], w_all[s:s + keep, None]
        pu, qp, qn = uf[u], itf[p], itf[n]
        d = (pu * qp).sum(1)[:, None] - (pu[:, None, :] * qn).sum(2)
        e = torch.sigmoid(-d) * w
        du = (e[:, :, None] * (qp[:, None, :] - qn)).sum(1) \
            - num_neg * ul * pu * w
        dp = e.sum(1)[:, None] * pu - num_neg * il * qp * w
        dn = -e[:, :, None] * pu[:, None, :] - il * qn * w[:, :, None]
        uf.index_add_(0, u, du)
        itf.index_add_(0, p, dp)
        itf.index_add_(0, n.T.reshape(-1),
                       dn.transpose(0, 1).reshape(-1, dn.shape[2]))


def train(problem: Problem, n_epochs: int, cfg: dict, precision: str,
          drop_half: bool = False):
    """The first ``n_epochs`` epochs from the seeded start: the factors
    after each, as float64 (user, item) pairs, the start first."""
    dtype = storage_dtype(precision)
    uf0, itf0 = initial_params(problem.n_users, problem.n_items,
                               cfg["nfactors"], cfg["init_seed"],
                               cfg["init_distribution_bound"])
    uf = torch.from_numpy(uf0).to(problem.device, dtype)
    itf = torch.from_numpy(itf0).to(problem.device, dtype)
    gen = torch.Generator(device=problem.device)
    gen.manual_seed(cfg["init_seed"])
    states = [(uf.double().clone(), itf.double().clone())]
    lr = cfg["init_learning_rate"]
    for _ in range(n_epochs):
        epoch(problem, uf, itf, gen, lr, cfg, drop_half)
        states.append((uf.double().clone(), itf.double().clone()))
        lr *= cfg["decay_rate"]
    return states


def eval_loss(uf: torch.Tensor, itf: torch.Tensor, triplets) -> float:
    """Mean log(1 + exp(-d)) over (users, positives, negatives), float64."""
    u, p, n = triplets
    uf, itf = uf.double(), itf.double()
    d = (uf[u] * (itf[p] - itf[n])).sum(1)
    return float(torch.nn.functional.softplus(-d).mean())
