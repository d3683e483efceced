"""TaskDef: distributed job specification, TextFormat-compatible (copy of
qmf_tpu/distributed/taskdef.py).

Mirrors the reference's proto2 ``TaskDef`` message
(reference distributed/proto/task.proto:5-19) and accepts the same
protobuf-TextFormat task files (reference examples/task.pb), e.g.::

    nepochs : 5
    nfactors : 30
    distribution_file : "../uniform.dat"
    train_set : "../n_rating.csv"
    user_factors : "./user_factors_vec.dat"
    item_factors : "./item_factors_vec.dat"

The parser is self-contained (flat proto2 TextFormat is `name : value`
lines with quoted strings); no protobuf runtime dependency. ``solver``
defaults to "cholesky", the plain ``torch.linalg`` solve, as qmf_tpu's
"cholesky" is XLA's: a task file reaches the CUDA kernels with
``solver : "auto"`` (chol_solve.cu on a card) or ``solver : "fused"``
(build_solve.cu).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict


@dataclasses.dataclass
class TaskDef:
    # defaults mirror task.proto:7-12
    nepochs: int = 10
    nfactors: int = 30
    regularization_lambda: float = 0.05
    confidence_weight: float = 40.0
    init_distribution_bound: float = 0.01
    distribution_file: str = ""
    # required (task.proto:14-16)
    train_set: str = ""
    user_factors: str = ""
    item_factors: str = ""
    # extensions (absent from the reference proto; reference task files
    # parse unchanged, these just keep their defaults)
    dtype: str = "float32"
    solver: str = "cholesky"

    def validate(self) -> None:
        missing = [
            f
            for f in ("train_set", "user_factors", "item_factors")
            if not getattr(self, f)
        ]
        if missing:
            raise ValueError(f"TaskDef missing required fields: {missing}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TaskDef":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


_LINE_RE = re.compile(
    r"""^\s*(?P<name>[A-Za-z_][A-Za-z0-9_]*)\s*:\s*(?P<value>.+?)\s*$"""
)


def _strip_comment(line: str) -> str:
    """Drop a trailing ``#`` comment, but only outside quoted strings —
    ``train_set : "data#1.csv"`` is legal proto2 TextFormat."""
    quote = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote:
            if ch == "\\":
                i += 1  # skip escaped char inside the string
            elif ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#":
            return line[:i]
        i += 1
    return line


def parse_taskdef(text: str) -> TaskDef:
    """Parse proto2 TextFormat (flat message) into a TaskDef."""
    td = TaskDef()
    types = {f.name: f.type for f in dataclasses.fields(TaskDef)}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).strip()
        if not line:
            continue
        m = _LINE_RE.match(line)
        if not m:
            raise ValueError(f"task file line {lineno}: can't parse {raw!r}")
        name, value = m.group("name"), m.group("value")
        if name not in types:
            raise ValueError(f"task file line {lineno}: unknown field {name!r}")
        if value.startswith('"') or value.startswith("'"):
            quote = value[0]
            if not value.endswith(quote) or len(value) < 2:
                raise ValueError(
                    f"task file line {lineno}: unterminated string {raw!r}"
                )
            # unescape what _strip_comment's string scanner accepts:
            # \" \' and \\ (TextFormat escape subset used by task files)
            parsed: Any = (
                value[1:-1]
                .replace("\\\\", "\x00")
                .replace("\\" + quote, quote)
                .replace("\x00", "\\")
            )
        elif types[name] in ("int", int):
            parsed = int(value)
        elif types[name] in ("float", float):
            parsed = float(value)
        else:
            parsed = value
        setattr(td, name, parsed)
    td.validate()
    return td


def load_taskdef(path: str) -> TaskDef:
    with open(path) as f:
        return parse_taskdef(f.read())
