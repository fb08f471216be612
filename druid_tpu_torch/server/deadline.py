"""One shared monotonic Deadline for every remaining-budget computation
(the port's own copy of the reference package's `server/deadline.py`).

Reference analogs:
  query/QueryContexts.java — the "timeout" context key the budget comes from
  server/QueryResource + DirectDruidClient — the same budget threads from
  the HTTP edge through the scatter to every remote call

Deadline is the single carrier for "how long may I still block":
construct it once where the budget enters (query admission, the broker's
scatter wave), pass the OBJECT down, and bound every park with `clamp()`,
instead of hand-rolling `end = time.monotonic() + t` arithmetic at each
site.
"""
from __future__ import annotations

import time
from typing import Optional


def context_timeout_ms(query) -> Optional[float]:
    """The query's timeout in ms (context key "timeout"; 0 = unlimited)."""
    t = query.context_map.get("timeout")
    if t is None:
        return None
    t = float(t)
    return None if t <= 0 else t


class Deadline:
    """Monotonic deadline; None = unlimited."""

    __slots__ = ("_end",)

    def __init__(self, timeout_ms: Optional[float]):
        self._end = None if timeout_ms is None \
            else time.monotonic() + timeout_ms / 1000.0

    @staticmethod
    def for_query(query) -> "Deadline":
        return Deadline(context_timeout_ms(query))

    @staticmethod
    def after_s(timeout_s: Optional[float]) -> "Deadline":
        """A deadline `timeout_s` seconds out (None = unlimited)."""
        return Deadline(None if timeout_s is None else timeout_s * 1000.0)

    @staticmethod
    def until(end_monotonic_s: Optional[float]) -> "Deadline":
        """A deadline at an absolute time.monotonic() instant — for budgets
        anchored to an event that already happened (the batch window opens
        at the oldest enqueue, not at the wait)."""
        d = Deadline(None)
        d._end = end_monotonic_s
        return d

    def remaining_ms(self) -> Optional[float]:
        if self._end is None:
            return None
        return max(0.0, (self._end - time.monotonic()) * 1000.0)

    def remaining(self) -> Optional[float]:
        """Remaining budget in seconds (None = unlimited), floored at 0."""
        if self._end is None:
            return None
        return max(0.0, self._end - time.monotonic())

    def clamp(self, value_s: Optional[float]) -> Optional[float]:
        """`value_s` bounded by the remaining budget — the one idiom a park
        under a deadline should use for its timeout argument. value None
        means "the whole remaining budget"; an unlimited deadline leaves
        `value_s` unchanged (so a poll quantum stays the bound)."""
        rem = self.remaining()
        if rem is None:
            return value_s
        if value_s is None:
            return rem
        return min(value_s, rem)

    def expired(self) -> bool:
        return self._end is not None and time.monotonic() >= self._end

    def check(self) -> None:
        if self.expired():
            # local import: querymanager imports Deadline from here
            from druid_tpu_torch.server.querymanager import QueryTimeoutError
            raise QueryTimeoutError("query timed out")
