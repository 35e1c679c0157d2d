"""Typed per-ticket serving errors.

A launch or retire that raises fails only its own launch group: each
affected ticket resolves to a :class:`ServeError` that :meth:`result`
raises, while the service keeps serving everything else.
"""
from __future__ import annotations


class ServeError(RuntimeError):
    """A ticket's request failed.

    Carries the failure's serving context: ``ticket``, owning ``shard``,
    and ``attempts`` (launch tries including the first). The underlying
    device error is chained as ``__cause__``. The service stays up: only
    this ticket resolved to an error.
    """

    def __init__(self, msg: str, *, ticket: int | None = None,
                 shard: int | None = None, attempts: int = 0):
        super().__init__(msg)
        self.ticket = ticket
        self.shard = shard
        self.attempts = attempts


class DeadlineExceeded(ServeError, TimeoutError):
    """A ticket's ``deadline_ms`` expired before its chunks launched.

    Subclasses :class:`TimeoutError` too, so callers that only distinguish
    'timed out' from 'failed' can catch the builtin."""
