"""One WALS epoch, both sides. A side that solves n rows given n_fixed
fixed rows of k factors over nnz ratings:

- FLOPs: the weighted build 2 nnz k^2 + 2 nnz k, the Gramian
  2 n_fixed k^2, the solves n (k^3 / 3 + 2 k^2);
- bytes: the ratings (an index and a value, 4 bytes each), the fixed
  factors read and the solved factors written (4 bytes each).
"""


def per_work(config, traffic, stats):
    k = config["settings"]["nfactors"]
    nnz, nu, ni = stats["nnz"], stats["n_users"], stats["n_items"]
    flops = nbytes = 0
    for n, n_fixed in ((nu, ni), (ni, nu)):
        flops += 2 * nnz * k * k + 2 * nnz * k + 2 * n_fixed * k * k \
            + n * (k ** 3 / 3 + 2 * k * k)
        nbytes += 8 * nnz + 4 * k * (n_fixed + n)
    return flops, nbytes
