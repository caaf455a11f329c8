"""Unique name generator: per-prefix counters with guard/switch support
so programs are reproducible.

Copy of ``paddle_tpu/framework/unique_name.py``: both packages must hand
out the same names (``gpt_0.tmp_3``, ``gpt.wte_moment1_0``, ...) for the
same build, so that parameters and optimizer state map one to one."""
from __future__ import annotations

import contextlib
from collections import defaultdict


class NameGenerator:
    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.ids = defaultdict(int)

    def __call__(self, key: str) -> str:
        name = f"{self.prefix}{key}_{self.ids[key]}"
        self.ids[key] += 1
        return name


_generator = NameGenerator()


def generate(key: str) -> str:
    return _generator(key)


def switch(new_generator: NameGenerator | None = None) -> NameGenerator:
    global _generator
    old = _generator
    _generator = new_generator or NameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator: NameGenerator | None = None):
    if isinstance(new_generator, str):
        new_generator = NameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
