"""Deprecation shims: warn exactly once per call site (DESIGN.md §14)."""
from __future__ import annotations

import sys
import warnings
from typing import Set, Tuple

_seen: Set[Tuple[str, str, int]] = set()


def warn_once(message: str, *, stacklevel: int = 3) -> None:
    """Emit ``DeprecationWarning`` once per (message, caller file, line).

    ``stacklevel`` follows the :func:`warnings.warn` convention: 3 points
    at the caller of the deprecated shim (warn_once -> shim -> caller).
    """
    try:
        frame = sys._getframe(stacklevel - 1)
        key = (message, frame.f_code.co_filename, frame.f_lineno)
    except ValueError:  # shallow stack (embedded callers)
        key = (message, "<unknown>", 0)
    if key in _seen:
        return
    _seen.add(key)
    warnings.warn(message, DeprecationWarning, stacklevel=stacklevel)
