"""What one collective of the sharded engines costs, at world 1.

    python -m qmf_tpu_torch.tools.collective_micro [--calls N] [--device=cpu]

One rank in a process group of its own (NCCL on the card; gloo with
``--device=cpu``), at the shapes the sharded paths hand their collectives:

  bpr_step    (32768, 155) int32 words: one step of phase 9d's data-parallel
              BPR (k = 30, 3 negatives), the ids and the gradient rows of
              ops/bpr_ops.py ``_whole_batch``
  wals_class  (31744, 64) float32: phase 4's largest user class, one
              all_gather of ops/als_ops.py ``_solve_side``
  loss        one float32, the half-epoch's all_reduce

For each it times ``--calls`` calls, the variants taking turns, of

  mesh        parallel/mesh.py's Mesh method the engines call
  raw         dist.all_gather_single (dist.all_reduce) on a preallocated
              output: the collective without the method's allocation
  copy        the same bytes by Tensor.copy_: no collective at all

and prints, after the card line (on the card), one JSON line: host
microseconds a call (the host's clock around the calls, nothing
synchronised inside) and device microseconds a call (CUDA events around the
same calls), each the median of three rounds. With ``--device=cpu`` both
are the host's (said in the line).
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from qmf_tpu_torch.parallel import launch, make_mesh, multihost
from qmf_tpu_torch.parallel.mesh import _all_gather_single
from qmf_tpu_torch.tools.gather_micro import card_line

SHAPES = {"bpr_step": ((32768, 155), torch.int32),
          "wals_class": ((31744, 64), torch.float32),
          "loss": ((), torch.float32)}


def _timed(fn, calls: int, cuda: bool) -> tuple[float, float]:
    """(host us, device us) a call of ``fn`` over ``calls`` calls."""
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    if not cuda:
        return host, host
    end.record()
    torch.cuda.synchronize()
    return host, start.elapsed_time(end) / calls * 1e3


def run(calls: int, device: str) -> dict:
    cuda = device != "cpu"
    multihost.initialize(f"127.0.0.1:{launch.free_port()}", 1, 0,
                         device=device)
    try:
        mesh = make_mesh(device=device)
        g = torch.Generator(device="cpu").manual_seed(0)
        out = {}
        for name, (shape, dtype) in SHAPES.items():
            x = torch.randint(0, 1 << 20, shape, generator=g).to(
                mesh.device, dtype)
            dst = torch.empty_like(x if x.dim() else x.reshape(1))
            if x.dim():
                fns = {"mesh": lambda x=x: mesh.all_gather_rows(x),
                       "raw": lambda x=x, d=dst: _all_gather_single(d, x),
                       "copy": lambda x=x, d=dst: d.copy_(x)}
            else:
                fns = {"mesh": lambda x=x: mesh.all_reduce_sum(x),
                       "raw": lambda d=dst: dist.all_reduce(d),
                       "copy": lambda x=x, d=dst: d.copy_(x)}
            for fn in fns.values():  # warm up: the first call makes the
                fn()                 # communicator
            got = {v: [] for v in fns}
            for _ in range(3):
                for variant, fn in fns.items():
                    got[variant].append(_timed(fn, calls, cuda))
            out[name] = {f"{variant}_{what}": round(sorted(
                t[i] for t in runs)[1], 2)
                for variant, runs in got.items()
                for i, what in enumerate(("host_us", "device_us"))}
            if x.dim():
                same = mesh.all_gather_rows(x)
                if not torch.equal(same, x):
                    raise AssertionError(f"{name}: the world-1 gather "
                                         "changed the rows")
        return {"backend": mesh.backend, "calls": calls,
                "clock": "card" if cuda else "host (cpu)", **out}
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device != "cpu":
        print(card_line(), flush=True)
    print(json.dumps(run(args.calls, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
