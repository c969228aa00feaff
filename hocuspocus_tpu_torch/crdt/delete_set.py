"""DeleteSet — compressed ranges of deleted struct ids (Yjs-compatible).

Encoding (v1): varUint numClients; per client: varUint client, varUint
numRanges, then (varUint clock, varUint len) per range.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Callable, Iterable

from .encoding import Decoder, Encoder


class DeleteSet:
    __slots__ = ("clients",)

    def __init__(self) -> None:
        # client -> list[(clock, len)]
        self.clients: dict[int, list[tuple[int, int]]] = {}

    def add(self, client: int, clock: int, length: int) -> None:
        self.clients.setdefault(client, []).append((clock, length))

    def is_empty(self) -> bool:
        return not self.clients

    def sort_and_merge(self) -> None:
        for client, ranges in self.clients.items():
            ranges.sort()
            merged: list[tuple[int, int]] = []
            for clock, length in ranges:
                if merged and merged[-1][0] + merged[-1][1] >= clock:
                    prev_clock, prev_len = merged[-1]
                    merged[-1] = (prev_clock, max(prev_len, clock + length - prev_clock))
                else:
                    merged.append((clock, length))
            self.clients[client] = merged

    def is_deleted(self, client: int, clock: int) -> bool:
        ranges = self.clients.get(client)
        if not ranges:
            return False
        i = bisect_right(ranges, (clock, float("inf"))) - 1
        if i < 0:
            return False
        r_clock, r_len = ranges[i]
        return r_clock <= clock < r_clock + r_len

    def iterate(self) -> Iterable[tuple[int, int, int]]:
        for client, ranges in self.clients.items():
            for clock, length in ranges:
                yield client, clock, length

    def write(self, encoder: Encoder) -> None:
        # flattened into ONE bulk varint write (native when available):
        # [numClients] then per client [client][numRanges][clock len]*
        # in decreasing client order, matching yjs writeDeleteSet
        # iteration of its struct-store-derived maps; readers are
        # order-independent.
        values = [len(self.clients)]
        for client in sorted(self.clients, reverse=True):
            ranges = self.clients[client]
            values.append(client)
            values.append(len(ranges))
            for clock, length in ranges:
                values.append(clock)
                values.append(length)
        encoder.write_var_uints(values)

    @staticmethod
    def read(decoder: Decoder) -> "DeleteSet":
        ds = DeleteSet()
        num_clients = decoder.read_var_uint()
        for _ in range(num_clients):
            client = decoder.read_var_uint()
            num_ranges = decoder.read_var_uint()
            if num_ranges > 0:
                # one bulk read for the whole (clock, len) run
                flat = decoder.read_var_uints(num_ranges * 2)
                ranges = ds.clients.setdefault(client, [])
                ranges.extend(zip(flat[0::2], flat[1::2]))
        return ds

    def encode(self) -> bytes:
        e = Encoder()
        self.write(e)
        return e.to_bytes()

    def equals(self, other: "DeleteSet") -> bool:
        a = {c: r for c, r in self.clients.items() if r}
        b = {c: r for c, r in other.clients.items() if r}
        return a == b


def merge_delete_sets(dss: Iterable[DeleteSet]) -> DeleteSet:
    merged = DeleteSet()
    for ds in dss:
        for client, ranges in ds.clients.items():
            merged.clients.setdefault(client, []).extend(ranges)
    merged.sort_and_merge()
    return merged
