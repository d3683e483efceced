"""One top-n request of B users over I items, k factors:

- FLOPs: the scores, 2 B I k;
- bytes: the users' and the items' factor rows (4 bytes each), the users'
  seen items (4 bytes each, the data's mean degree) and the answer (an
  index and a score, 4 bytes each).
"""


def per_work(config, traffic, stats):
    b, i, k = stats["batch_users"], stats["n_items"], stats["nfactors"]
    seen = b * stats["nnz"] / stats["n_users"]
    return 2 * b * i * k, 4 * (b * k + i * k + seen + 2 * b * stats["topn"])
