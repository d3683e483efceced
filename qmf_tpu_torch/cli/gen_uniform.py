"""``gen_uniform`` CLI — deterministic init seed file generator (copy of
qmf_tpu/cli/gen_uniform.py).

Equivalent of the reference binary (qmf/gen_uniform.cpp:7-30):
``python -m qmf_tpu_torch.cli.gen_uniform [count] [out_file]`` writes
``count`` (default 1e6) uniform(-0.01, 0.01) doubles, one per line, to
``uniform.dat``. An optional ``--seed`` makes the file itself reproducible
(the reference seeds from random_device).
"""

from __future__ import annotations

import sys

from qmf_tpu_torch.data import gen_uniform
from qmf_tpu_torch.utils.flags import Flags
from qmf_tpu_torch.utils.logging import log


def main(argv=None) -> int:
    fl = Flags("gen_uniform [count] [out_file]")
    fl.define_integer("seed", -1, "RNG seed (-1 = nondeterministic)")
    fl.define_float("bound", 0.01, "uniform bound")
    pos = fl.parse(argv)
    count = int(pos[0]) if len(pos) > 0 else 1_000_000
    out_file = pos[1] if len(pos) > 1 else "uniform.dat"
    seed = None if fl.seed < 0 else fl.seed
    gen_uniform(count, out_file, bound=fl.bound, seed=seed)
    log.info("wrote %d uniform values to %s", count, out_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
