"""Unique name generator: a copy of ``paddle_tpu/framework/unique_name.py``
(same counters, same ``<key>_<n>`` names, so a program built here names
its vars as the JAX package's builder does)."""
import contextlib


class UniqueNameGenerator:
    def __init__(self, prefix=""):
        self.prefix = prefix
        self.ids = {}

    def __call__(self, key):
        if key not in self.ids:
            self.ids[key] = 0
        tmp = self.ids[key]
        self.ids[key] += 1
        return f"{self.prefix}{key}_{tmp}"


generator = UniqueNameGenerator()


def generate(key):
    return generator(key)


@contextlib.contextmanager
def guard(new_generator=None):
    global generator
    old = generator
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    generator = new_generator or UniqueNameGenerator()
    try:
        yield
    finally:
        generator = old
