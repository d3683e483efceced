"""The counts the rooflines divide by, against hand arithmetic."""

import pytest

from portbench.counts import bpr_train, serve, wals_train


def wals_cfg(k):
    return {"settings": {"nfactors": k}}


def test_wals_epoch_counts_by_hand_tiny():
    # users 3, items 4, 10 ratings, k 2: user side 80 + 40 + 32 + 3 (8/3 +
    # 8), item side 80 + 40 + 24 + 4 (8/3 + 8)
    flops, nbytes = wals_train.per_work(
        wals_cfg(2), {}, {"nnz": 10, "n_users": 3, "n_items": 4})
    assert flops == pytest.approx(184 + 144 + 4 * (8 / 3 + 8))
    assert nbytes == 2 * (80 + 4 * 2 * 7)


def test_wals_epoch_counts_at_ml20m_scale():
    flops, nbytes = wals_train.per_work(
        wals_cfg(64), {},
        {"nnz": 20_000_000, "n_users": 138_493, "n_items": 26_744})
    build = 2 * (2 * 20e6 * 64 ** 2 + 2 * 20e6 * 64)
    gram = 2 * (26_744 + 138_493) * 64 ** 2
    solves = (138_493 + 26_744) * (64 ** 3 / 3 + 2 * 64 ** 2)
    assert flops == pytest.approx(build + gram + solves)
    assert flops == pytest.approx(349.95e9, rel=1e-3)  # about 350 GFLOP
    assert nbytes == pytest.approx(2 * 8 * 20e6 + 2 * 4 * 64 * 165_237)


@pytest.mark.parametrize("n_pos,j,k,want_bytes,want_flops", [
    (2, 1, 2, 2 * (2 * 3 * 4 * 2 + 8), 2 * 2 * 13),
    (18_000_376, 3, 30, 18_000_376 * 1208, 18_000_376 * 30 * 29),
])
def test_bpr_epoch_counts(n_pos, j, k, want_bytes, want_flops):
    cfg = {"settings": {"nfactors": k, "num_negative_samples": j}}
    flops, nbytes = bpr_train.per_work(cfg, {}, {"n_pos": n_pos})
    assert nbytes == want_bytes
    assert flops == want_flops


@pytest.mark.parametrize("b,i,k,nnz,nu,topn", [
    (2, 3, 4, 6, 3, 1), (4096, 26_744, 64, 20_000_000, 138_493, 10)])
def test_serve_request_counts(b, i, k, nnz, nu, topn):
    stats = {"batch_users": b, "n_items": i, "nfactors": k, "nnz": nnz,
             "n_users": nu, "topn": topn}
    flops, nbytes = serve.per_work({}, {}, stats)
    assert flops == 2 * b * i * k
    assert nbytes == pytest.approx(4 * (b * k + i * k + b * nnz / nu
                                        + 2 * b * topn))
    if b == 4096:
        assert flops == pytest.approx(14.02e9, rel=1e-3)
