"""Unique name generator.

Capability parity with the reference's ``python/paddle/fluid/unique_name.py``
(UniqueNameGenerator): dedups symbolic variable/op names per generator, with a
``guard`` to swap generators (used by tests for reproducible programs).
"""

import contextlib
import threading

__all__ = ["generate", "switch", "guard"]


class UniqueNameGenerator:
    """Generates unique names with a prefix, keyed by counter per prefix."""

    def __init__(self, prefix=""):
        self.ids = {}
        self.prefix = prefix
        self.lock = threading.Lock()

    def __call__(self, key):
        with self.lock:
            if key not in self.ids:
                self.ids[key] = 0
            tmp = self.ids[key]
            self.ids[key] += 1
        return self.prefix + "_".join([key, str(tmp)])


_generator = UniqueNameGenerator()


def generate(key):
    return _generator(key)


def switch(new_generator=None):
    global _generator
    old = _generator
    _generator = new_generator if new_generator is not None else UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
