"""Typed key-value map for index metadata.

Replaces the reference's ``BaseStorage`` typed-KV adapter
(``bigsi/storage/base.py:61-151``) for everything that is *not* the bit
matrix: sample metadata, index parameters, counters.  Same key-suffix
scheme (``:int`` / ``:string``) so serialized stores are recognizable;
values live in a plain dict and round-trip through JSON.
"""

from __future__ import annotations


class TypedKV:
    def __init__(self, data: dict | None = None):
        self._data = dict(data) if data else {}
        self.dirty = False

    # -- typed API ----------------------------------------------------

    def set_integer(self, key, value: int) -> None:
        self._data[str(key) + ":int"] = int(value)
        self.dirty = True

    def get_integer(self, key) -> int:
        return int(self._data[str(key) + ":int"])

    def set_string(self, key, value: str) -> None:
        assert isinstance(value, str)
        self._data[str(key) + ":string"] = value
        self.dirty = True

    def get_string(self, key) -> str:
        return self._data[str(key) + ":string"]

    def incr(self, key) -> int:
        k = str(key) + ":int"
        self._data[k] = int(self._data.get(k, 0)) + 1
        self.dirty = True
        return self._data[k]

    def delete_all(self) -> None:
        self._data.clear()
        self.dirty = True

    # -- persistence --------------------------------------------------

    def to_dict(self) -> dict:
        return dict(self._data)

    @classmethod
    def from_dict(cls, d: dict) -> "TypedKV":
        return cls(d)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data
