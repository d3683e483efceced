"""gflags-compatible command-line flag parsing (copy of qmf_tpu/utils/flags.py).

The reference CLIs use gflags (e.g. reference qmf/wals.cpp:26-50). This module
reproduces the accepted syntax so reference command lines work verbatim:

- ``--flag=value``, ``-flag=value``
- ``--flag value``, ``-flag value`` (non-boolean flags)
- booleans: ``--flag`` (true), ``--noflag`` (false), ``--flag=true/false/1/0``
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional, Sequence


class FlagError(ValueError):
    pass


class Flags:
    """A gflags-like flag registry + parser."""

    def __init__(self, usage: str = ""):
        self.usage = usage
        self._defs: Dict[str, Dict[str, Any]] = {}
        self.values: Dict[str, Any] = {}

    # --- definitions --------------------------------------------------------
    def _define(self, name: str, default: Any, help_str: str, ftype: type) -> None:
        if name in self._defs:
            raise FlagError(f"flag {name} already defined")
        self._defs[name] = {"default": default, "help": help_str, "type": ftype}
        self.values[name] = default

    def define_integer(self, name: str, default: int, help_str: str = "") -> None:
        self._define(name, default, help_str, int)

    def define_float(self, name: str, default: float, help_str: str = "") -> None:
        self._define(name, float(default), help_str, float)

    def define_string(self, name: str, default: str, help_str: str = "") -> None:
        self._define(name, default, help_str, str)

    def define_bool(self, name: str, default: bool, help_str: str = "") -> None:
        self._define(name, default, help_str, bool)

    # --- parsing -------------------------------------------------------------
    @staticmethod
    def _parse_bool(text: str) -> bool:
        lowered = text.lower()
        if lowered in ("true", "t", "1", "yes", "y"):
            return True
        if lowered in ("false", "f", "0", "no", "n"):
            return False
        raise FlagError(f"invalid boolean value: {text!r}")

    def parse(self, argv: Optional[Sequence[str]] = None) -> List[str]:
        """Parse argv (defaults to sys.argv[1:]); returns positional leftovers."""
        if argv is None:
            argv = sys.argv[1:]
        positional: List[str] = []
        i = 0
        while i < len(argv):
            arg = argv[i]
            i += 1
            if not arg.startswith("-") or arg == "-" or arg == "--":
                positional.append(arg)
                continue
            body = arg.lstrip("-")
            if body in ("help", "h"):
                self.print_help()
                raise SystemExit(0)
            name, eq, value = body.partition("=")
            if name not in self._defs:
                # gflags --noflag negation
                if (
                    name.startswith("no")
                    and name[2:] in self._defs
                    and self._defs[name[2:]]["type"] is bool
                    and not eq
                ):
                    self.values[name[2:]] = False
                    continue
                raise FlagError(f"unknown flag: {arg}")
            ftype = self._defs[name]["type"]
            if not eq:
                if ftype is bool:
                    self.values[name] = True
                    continue
                if i >= len(argv):
                    raise FlagError(f"flag {arg} needs a value")
                value = argv[i]
                i += 1
            if ftype is bool:
                self.values[name] = self._parse_bool(value)
            else:
                try:
                    self.values[name] = ftype(value)
                except ValueError as e:
                    raise FlagError(f"invalid value for --{name}: {value!r}") from e
        return positional

    def __getattr__(self, name: str) -> Any:
        values = self.__dict__.get("values", {})
        if name in values:
            return values[name]
        raise AttributeError(name)

    def print_help(self) -> None:
        print(self.usage or "flags:", file=sys.stderr)
        for name, d in sorted(self._defs.items()):
            print(
                f"  --{name} ({d['type'].__name__}, default={d['default']!r}): "
                f"{d['help']}",
                file=sys.stderr,
            )
