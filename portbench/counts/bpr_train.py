"""One BPR epoch over n_pos positive pairs with J negatives each, k factors:

- bytes: each positive reads its user row, its positive row and its J
  negative rows once (k float32 each), writes them once, and reads its two
  ids: n_pos (2 (2 + J) 4 k + 8);
- FLOPs: the J score differences (2 k (1 + J)), the user's, positive's and
  negatives' updates (3 k J + 3 k + 3 k J): n_pos k (8 J + 5).
"""


def per_work(config, traffic, stats):
    k = config["settings"]["nfactors"]
    j = config["settings"]["num_negative_samples"]
    n = stats["n_pos"]
    return n * k * (8 * j + 5), n * (2 * (2 + j) * 4 * k + 8)
