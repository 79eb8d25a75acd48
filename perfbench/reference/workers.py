"""Processes for the reference's independent hashes.

A proof's leaf hashes, the nodes of one tree level and the four column
chains are independent of one another, so they are split into chunks
and hashed in spawned processes, one per usable core.  `Workers(1)` runs
every chunk in the calling process.
"""

from __future__ import annotations

import multiprocessing
import os

# Below this many items a batch is hashed here: a round trip to a worker
# costs more than a few permutations.
INLINE_ITEMS = 64


def usable_cores() -> int:
    return len(os.sched_getaffinity(0))


def split(items: list, parts: int) -> list:
    """`items` in at most `parts` contiguous, nearly equal chunks."""
    parts = max(1, min(parts, len(items)))
    q, r = divmod(len(items), parts)
    out, off = [], 0
    for i in range(parts):
        n = q + (i < r)
        out.append(items[off:off + n])
        off += n
    return out


def _call(job):
    fn, args = job
    return fn(*args)


class Workers:
    def __init__(self, processes: int | None = None):
        self.processes = processes or usable_cores()
        self._pool = None
        if self.processes > 1:
            ctx = multiprocessing.get_context("spawn")
            self._pool = ctx.Pool(self.processes)

    def map_items(self, fn, head: tuple, items: list) -> list:
        """[fn(*head, chunk) for each chunk of items], concatenated in
        order; `fn` returns one result a chunk item."""
        if self._pool is None or len(items) < INLINE_ITEMS:
            return fn(*head, items)
        jobs = [(fn, head + (c,)) for c in split(items, 2 * self.processes)]
        out = []
        for part in self._pool.map(_call, jobs, chunksize=1):
            out.extend(part)
        return out

    def map_jobs(self, fn, arg_tuples: list) -> list:
        """[fn(*args) for args in arg_tuples], each in a worker."""
        if self._pool is None:
            return [fn(*a) for a in arg_tuples]
        return self._pool.map(_call, [(fn, a) for a in arg_tuples],
                              chunksize=1)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.close()
            self._pool.join()
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is not None and self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None
        self.close()
        return False
