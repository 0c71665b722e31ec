"""Wrapping a method of the program from outside, for the time of a context:
how the benchmark records what a layer returned, counts calls into it, and
plants the faults its tests hold ``correct`` against. The program's source
is never touched; leaving the context puts the original back."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def wrapped(owner, name: str, make):
    """Replace ``owner.name`` by ``make(original)`` inside the context."""
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield original
    finally:
        setattr(owner, name, original)


def counting(owner, name: str, counts: dict, key: str):
    """A context that adds one to ``counts[key]`` on every call of
    ``owner.name``."""
    counts.setdefault(key, 0)

    def make(original):
        def call(*args, **kwargs):
            counts[key] += 1
            return original(*args, **kwargs)
        return call

    return wrapped(owner, name, make)
