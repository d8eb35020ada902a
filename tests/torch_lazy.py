"""A helper of the port's tests (``tests/test_torch_*.py``)."""


class Lazy(dict):
    """A dict whose missing entry is made by ``make(key)`` when first read,
    so that a test worker builds only the JAX runs its tests read."""

    def __init__(self, make):
        super().__init__()
        self._make = make

    def __missing__(self, key):
        self[key] = value = self._make(key)
        return value
