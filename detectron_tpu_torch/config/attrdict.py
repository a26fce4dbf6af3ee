"""A small attribute dictionary with the override rules of the JAX config.

The JAX package keeps its config in ``ml_collections.ConfigDict``; the port
has no such dependency, so this class carries the part of its behaviour
that the config functions rely on: attribute and item access, ``get``,
``to_dict``, and type-checked assignment to an existing field (an int may
replace a float and is stored as a float, a list may replace a tuple and
is stored as a tuple, any other change of type raises ``TypeError``).
"""

from __future__ import annotations


def _coerce(key: str, old, new):
    if old is None or new is None:
        return new
    if isinstance(old, AttrDict):
        raise TypeError(f"config key {key!r} expects a mapping")
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    if type(old) is float and type(new) is int:
        return float(new)
    if type(old) is not type(new):
        raise TypeError(
            f"could not override field {key!r}: {new!r} is of type "
            f"{type(new).__name__}, the field is {type(old).__name__}")
    return new


class AttrDict(dict):
    """``dict`` whose keys are also attributes; see the module docstring."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self[name] = value

    def __setitem__(self, key, value):
        if key in self:
            value = _coerce(key, self[key], value)
        super().__setitem__(key, value)

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, AttrDict) else v
                for k, v in self.items()}
