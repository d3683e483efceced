"""serve_p95_ms: the 95th percentile of the latency of every request of the
window, in ms."""

from portbench.harness import p95


def read(ctx):
    return 1e3 * p95(ctx.latencies_s)
