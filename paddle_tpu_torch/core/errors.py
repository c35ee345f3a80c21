"""Enforce-style error checking.

The port of ``paddle_tpu/core/errors.py``: Paddle's typed error
categories (paddle/phi/core/errors.h) and the ``enforce`` helpers.
torch raises its own errors for shape and dtype problems; these add the
Paddle categories on top.
"""
from __future__ import annotations


class EnforceNotMet(RuntimeError):
    pass


class InvalidArgumentError(EnforceNotMet, ValueError):
    pass


class NotFoundError(EnforceNotMet, KeyError):
    pass


class OutOfRangeError(EnforceNotMet, IndexError):
    pass


class AlreadyExistsError(EnforceNotMet):
    pass


class PermissionDeniedError(EnforceNotMet):
    pass


class UnimplementedError(EnforceNotMet, NotImplementedError):
    pass


class UnavailableError(EnforceNotMet):
    pass


class PreconditionNotMetError(EnforceNotMet):
    pass


def enforce(cond, msg="", err_cls=InvalidArgumentError):
    if not cond:
        raise err_cls(msg)


def enforce_eq(a, b, msg="", err_cls=InvalidArgumentError):
    if a != b:
        raise err_cls(f"{msg} (expected {a!r} == {b!r})")


def enforce_gt(a, b, msg="", err_cls=InvalidArgumentError):
    if not a > b:
        raise err_cls(f"{msg} (expected {a!r} > {b!r})")
