"""Silence-gated printing plumbing (reference layer L0); a copy of
``srnn_tpu/utils/printing.py``.

Reference: ``util.py:1-39`` — ``PrintingObject`` gives every object a
``silent`` flag, a ``_print`` gate that honors it, and a ``SilenceSignal``
context manager (``obj.silence()``) that silences the object for a ``with``
block.  The port's runtime logging goes through ``Experiment.log``
instead, but the mixin keeps the exact reference surface —
``is_silent / get_silence / set_silence / unset_silence / with_silence /
silence / _print`` — so reference users migrating interactive scripts keep
their habits on any framework object.
"""

from __future__ import annotations


class PrintingObject:
    """Mixin: per-object ``silent`` flag gating ``_print`` (``util.py:1-39``)."""

    class SilenceSignal:
        """Context manager: force ``silent=value`` inside the block, restore
        the previous value on exit (``util.py:3-11``)."""

        def __init__(self, obj: "PrintingObject", value: bool):
            self.obj = obj
            self.new_silent = value

        def __enter__(self):
            self.old_silent = self.obj.get_silence()
            self.obj.set_silence(self.new_silent)

        def __exit__(self, exc_type, exc_value, traceback):
            self.obj.set_silence(self.old_silent)

    @property
    def silent(self) -> bool:
        # reference sets the flag in __init__ (util.py:13-14); a property
        # default keeps the mixin usable without requiring super().__init__()
        return getattr(self, "_silent", True)

    @silent.setter
    def silent(self, value: bool) -> None:
        self._silent = bool(value)

    def is_silent(self) -> bool:
        return self.silent

    def get_silence(self) -> bool:
        return self.is_silent()

    def set_silence(self, value: bool = True) -> "PrintingObject":
        self.silent = value
        return self

    def unset_silence(self) -> "PrintingObject":
        self.silent = False
        return self

    def with_silence(self, value: bool = True) -> "PrintingObject":
        self.set_silence(value)
        return self

    def silence(self, value: bool = True) -> "PrintingObject.SilenceSignal":
        return self.__class__.SilenceSignal(self, value)

    def _print(self, *args, **kwargs) -> None:
        if not self.silent:
            print(*args, **kwargs)
