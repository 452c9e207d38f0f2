"""Jittered exponential backoff, shared by every retry loop.

Extracted from the batch tier's per-workunit re-issue delay so the
elastic serving cell's re-shard retry (and anything else that must not
hammer a churning cloudlet) uses the same arithmetic: delay doubles from
``base_s`` up to ``cap_s``, an optional symmetric jitter de-correlates
retries across instances, and :meth:`reset` snaps back to ``base_s``
after a success.

Jitter is deterministic under the seed — ``(seed, level)`` keys the rng
draw — so simulated traces replay byte-for-byte.

Copied from ``repro/core/backoff.py`` (plain Python), so that
the port imports nothing of the JAX package; only the
cross-references name the port's modules.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["JitteredBackoff"]


@dataclass
class JitteredBackoff:
    """Exponential backoff with deterministic, seeded jitter.

    ``next_delay()`` returns ``min(base_s * 2**level, cap_s)`` scaled by
    a jitter factor uniform in ``[1 - jitter, 1 + jitter]`` (still capped
    at ``cap_s``), then bumps the level. ``peek()`` is the same value
    without consuming it. ``reset()`` returns to level 0 — call it on
    success so one bad stretch doesn't tax the next recovery.
    """

    base_s: float
    cap_s: float
    jitter: float = 0.0
    seed: int = 0
    level: int = field(default=0, init=False)

    def __post_init__(self) -> None:
        if self.base_s <= 0 or self.cap_s < self.base_s:
            raise ValueError(
                f"need 0 < base_s <= cap_s, got base_s={self.base_s}, "
                f"cap_s={self.cap_s}")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")

    def _delay(self, level: int) -> float:
        delay = min(self.base_s * (2 ** level), self.cap_s)
        if self.jitter:
            import numpy as np

            u = float(np.random.default_rng((self.seed, level)).random())
            delay = min(delay * (1.0 + self.jitter * (2.0 * u - 1.0)),
                        self.cap_s)
        return delay

    def peek(self) -> float:
        """The delay the next :meth:`next_delay` call will return."""
        return self._delay(self.level)

    def next_delay(self) -> float:
        """Consume and return the current delay; subsequent calls double
        (up to ``cap_s``)."""
        delay = self._delay(self.level)
        self.level += 1
        return delay

    def reset(self) -> None:
        """Back to ``base_s`` — call after a success."""
        self.level = 0
