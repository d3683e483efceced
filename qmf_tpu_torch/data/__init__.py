"""The reference text formats and id maps (copy of qmf_tpu/data/__init__.py).

The port keeps its own copies of ``qmf_tpu.data``'s numpy modules, so that it
imports nothing of ``qmf_tpu``. The on-disk formats are the same, so files
pass between the two packages unchanged. Left out: ``native`` (the C++
parser and writer of ``qmf_tpu/_native``): the port reads with numpy or
Python and writes factors with Python.
"""

from qmf_tpu_torch.data.dataset import Dataset, read_dataset, write_dataset  # noqa: F401
from qmf_tpu_torch.data.factor_io import (  # noqa: F401
    FactorData,
    load_factors,
    save_factors,
)
from qmf_tpu_torch.data.gen_uniform import gen_uniform  # noqa: F401
from qmf_tpu_torch.data.id_index import MISSING_IDX, IdIndex  # noqa: F401
