"""String splitting with the reference's exact semantics (copy of
qmf_tpu/utils/split.py).

Reference qmf/utils/Util.cpp:21-38: an empty input yields an empty list; for
non-empty input every delimiter produces a field, including trailing/empty
fields (``"a,,b,"`` -> ``["a", "", "b", ""]``). Used to parse
``--test_avg_metrics=auc,p@10`` style flags.
"""

from __future__ import annotations

from typing import List


def split(s: str, delim: str = ",") -> List[str]:
    if not s:
        return []
    return s.split(delim)
