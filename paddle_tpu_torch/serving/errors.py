"""Typed serving errors: the request-visible failure taxonomy.

Reference analog: the serving front ends in the vLLM lineage return
typed, retriable-or-not errors (HTTP 429 vs 500) rather than letting a
pool-exhaustion or device fault surface as a bare RuntimeError.  The
router and engine raise these so callers can branch on ``retriable``
without string-matching messages:

  * retriable (the client should back off and resend — nothing about
    the request itself is wrong): :class:`AdmissionRejected` (bounded
    queue shed the request under load), :class:`ReplicaUnavailable`
    (no live replica could place it);
  * terminal (resending the same request will fail the same way):
    :class:`DeadlineExceeded` (its SLO deadline passed while queued or
    decoding), :class:`RequestQuarantined` (bisection blamed it for a
    step failure — the poison-pill request).
"""
from __future__ import annotations

__all__ = ["ServingError", "RetriableError", "AdmissionRejected",
           "DeadlineExceeded", "RequestQuarantined",
           "ReplicaUnavailable"]


class ServingError(RuntimeError):
    """Base of every typed serving failure."""

    retriable = False


class RetriableError(ServingError):
    """The request itself is fine — the serving side was overloaded or
    degraded.  Clients should retry with backoff."""

    retriable = True


class AdmissionRejected(RetriableError):
    """Bounded admission queue shed the request (watermark load
    shedding).  The 429 of this stack."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed before it finished; partial
    output (if any) was streamed but the request is terminal."""


class RequestQuarantined(ServingError):
    """Step-failure bisection blamed this request; it is quarantined
    so the remaining streams can recover via replay."""


class ReplicaUnavailable(RetriableError):
    """No live, non-draining replica could accept the request."""
