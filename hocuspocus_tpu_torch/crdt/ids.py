"""Struct identifiers: (client, clock) pairs — the Y.js ID model."""

from __future__ import annotations

from typing import NamedTuple


class ID(NamedTuple):
    client: int
    clock: int


def compare_ids(a: ID | None, b: ID | None) -> bool:
    if a is b:
        return True
    if a is None or b is None:
        return False
    return a.client == b.client and a.clock == b.clock
