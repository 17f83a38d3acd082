"""Bounded retry with backoff (port of ``repro.resilience.retry``; pure
Python, a copy, so that the port imports nothing of the JAX package).

A :class:`RetryPolicy` is pure data (attempt budget, backoff curve,
which exception classes are worth retrying); :func:`call_with_retry`
executes it.  Jitter is *deterministic* — a hash of the attempt index,
not ``random`` — so a retried run is replayable and tests can assert
exact sleep sequences.

The checkpoint writer retries its IO under a policy; the same
transient/deterministic split classifies a failure as worth re-running (an
:data:`TRANSIENT_EXCEPTIONS` subclass) or not (a ``ValueError``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Tuple, Type, Union

#: Exception classes that plausibly succeed on a second attempt: flaky
#: storage, network hiccups, timeouts.  Everything else (shape errors,
#: bad configs, assertion failures) is deterministic — retrying replays
#: the same failure.
TRANSIENT_EXCEPTIONS: Tuple[Type[BaseException], ...] = (
    OSError,            # covers IOError, FileNotFoundError, ConnectionError
    TimeoutError,
)


class RetryError(RuntimeError):
    """All attempts exhausted; ``__cause__`` is the last failure and
    ``attempts`` records how many were made."""

    def __init__(self, msg: str, attempts: int):
        super().__init__(msg)
        self.attempts = attempts


def classify_failure(exc: Union[BaseException, type, None]) -> str:
    """``"transient"`` or ``"deterministic"`` for an exception (instance or
    class).  ``None``/unknown classifies transient: a legacy failure record
    with no exception info gets the benefit of the doubt on retry."""
    if exc is None:
        return "transient"
    cls = exc if isinstance(exc, type) else type(exc)
    if not issubclass(cls, BaseException):
        return "transient"
    return ("transient" if issubclass(cls, TRANSIENT_EXCEPTIONS)
            else "deterministic")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter.

    ``max_attempts`` counts the first try (1 = no retries).  The delay
    before retry ``k`` (1-based) is ``base_delay_s * 2**(k-1)`` capped at
    ``max_delay_s``, scaled by ``1 + jitter * u_k`` where ``u_k in [0, 1)``
    is a hash of ``k`` — the same schedule every run.  ``retry_on`` filters
    which exception classes are retried at all; anything else re-raises
    immediately.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.25
    retry_on: Tuple[Type[BaseException], ...] = TRANSIENT_EXCEPTIONS

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {self.max_attempts}")
        if self.base_delay_s < 0 or self.max_delay_s < 0 or self.jitter < 0:
            raise ValueError("delays and jitter must be >= 0")

    def delay_s(self, retry_index: int) -> float:
        """Seconds to sleep before retry ``retry_index`` (1-based)."""
        base = min(self.base_delay_s * (2.0 ** (retry_index - 1)),
                   self.max_delay_s)
        # Knuth multiplicative hash of the retry index -> [0, 1): jittered
        # but bit-for-bit reproducible (no global random state touched)
        u = ((retry_index * 2654435761) % 4096) / 4096.0
        return base * (1.0 + self.jitter * u)

    def retriable(self, exc: BaseException) -> bool:
        return isinstance(exc, self.retry_on)


def call_with_retry(fn: Callable[..., Any], *args,
                    policy: Optional[RetryPolicy] = None,
                    on_retry: Optional[Callable[[int, BaseException], None]]
                    = None,
                    sleep: Callable[[float], None] = time.sleep,
                    **kwargs) -> Any:
    """Call ``fn(*args, **kwargs)`` under ``policy``.

    ``on_retry(attempt, exc)`` fires before each backoff sleep (attempt is
    the 1-based attempt that just failed) — the hook retry counters and
    logs hang off.  Non-retriable exceptions propagate untouched; an
    exhausted budget raises :class:`RetryError` from the last failure.
    ``sleep`` is injectable for tests.
    """
    policy = policy or RetryPolicy()
    last: Optional[BaseException] = None
    for attempt in range(1, policy.max_attempts + 1):
        try:
            return fn(*args, **kwargs)
        except BaseException as e:
            if not policy.retriable(e):
                raise
            last = e
            if attempt == policy.max_attempts:
                break
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(policy.delay_s(attempt))
    raise RetryError(
        f"{getattr(fn, '__name__', 'call')} failed after "
        f"{policy.max_attempts} attempts: {type(last).__name__}: {last}",
        attempts=policy.max_attempts) from last

