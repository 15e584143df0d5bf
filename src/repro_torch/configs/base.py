"""Arch registry protocol: every configs/<id>.py exposes SPEC."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                     # "lm" | "gnn" | "recsys"
    model: str                      # model module key (e.g. "transformer")
    full: Callable[[], Any]         # exact assigned configuration
    smoke: Callable[[], Any]        # reduced same-family configuration
    source: str = ""                # citation tag from the assignment
