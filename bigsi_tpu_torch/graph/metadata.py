"""Sample <-> colour metadata, array-backed.

Behavior parity with the reference (``bigsi/graph/metadata.py:4-120``):

* colours are assigned densely by a monotonically increasing counter;
* deleting a sample renames its colour to the ``D3L3T3D`` sentinel and
  sets the sample's colour to ``-1`` — the counter is NOT decremented,
  and the name stays reserved (re-adding it raises);
* duplicate sample names are rejected with ``ValueError``;
* merging appends the other index's samples, suffixing clashes with
  ``_duplicate_in_merge``.

Unlike the reference — which does one storage round-trip per lookup
against a KV database — the maps live in memory as a colour-ordered
name list plus a name->colour dict, loaded once from the manifest KV
and written through on mutation.  The persisted representation keeps
the reference's key scheme (``metadata:<name>:int``,
``metadata:<colour>:string``, ``metadata:colour_count:int``) so stores
serialized by earlier versions (and converted reference stores) load
unchanged.
"""

from __future__ import annotations

DELETION_SPECIAL_SAMPLE_NAME = "D3L3T3D"
MERGE_DUPLICATE_SUFFIX = "_duplicate_in_merge"

_PREFIX = "metadata"
_COUNT_KEY = "colour_count"


def _kv_key(key) -> str:
    return "%s:%s" % (_PREFIX, key)


class SampleMetadata:
    """Mixin managing the colour <-> sample-name bijection."""

    def __init__(self, storage):
        # Named to avoid clashing with KmerSignatureIndex.storage when
        # both are mixed into BIGSI (the reference shares one handle;
        # here metadata uses the KV while the index uses the full store).
        self.metadata_kv = storage
        self._names: list[str] = []        # colour -> current name
        self._colours: dict[str, int] = {}  # name -> colour (-1 deleted)
        self._load()

    def _load(self) -> None:
        try:
            count = self.metadata_kv.get_integer(_kv_key(_COUNT_KEY))
        except KeyError:
            return
        self._names = [
            self.metadata_kv.get_string(_kv_key(c)) for c in range(count)
        ]
        for colour, name in enumerate(self._names):
            if name != DELETION_SPECIAL_SAMPLE_NAME:
                self._colours[name] = colour
        # deleted names stay reserved: recover them from the KV, where
        # they persist as <name> -> -1
        for key, value in self.metadata_kv.to_dict().items():
            if not key.startswith(_PREFIX + ":") or not key.endswith(":int"):
                continue
            name = key[len(_PREFIX) + 1:-len(":int")]
            if name != _COUNT_KEY and value == -1:
                self._colours[name] = -1

    # -- queries (all in-memory) ---------------------------------------

    @property
    def num_samples(self) -> int:
        return len(self._names)

    def sample_name_exists(self, sample_name: str) -> bool:
        return sample_name in self._colours

    def sample_to_colour(self, sample_name: str):
        colour = self._colours.get(sample_name)
        return None if colour is None or colour < 0 else colour

    def colour_to_sample(self, colour: int) -> str:
        if not 0 <= colour < len(self._names):
            raise KeyError(colour)
        return self._names[colour]

    def samples_to_colours(self, sample_names) -> dict:
        pairs = ((s, self.sample_to_colour(s)) for s in sample_names)
        return {s: c for s, c in pairs if c is not None}

    def colours_to_samples(self, colours) -> dict:
        pairs = ((c, self.colour_to_sample(c)) for c in colours)
        return {c: s for c, s in pairs if s}

    def sample_names(self) -> list[str]:
        """All names in colour order (deleted sentinel included)."""
        return list(self._names)

    # -- mutations (write-through to the KV) ----------------------------

    def add_sample(self, sample_name: str) -> int:
        if sample_name == DELETION_SPECIAL_SAMPLE_NAME:
            raise ValueError(
                "You can't call a sample %s" % DELETION_SPECIAL_SAMPLE_NAME
            )
        if sample_name in self._colours:
            raise ValueError("You can't insert two samples with the same name")
        colour = len(self._names)
        self._names.append(sample_name)
        self._colours[sample_name] = colour
        self.metadata_kv.set_integer(_kv_key(sample_name), colour)
        self.metadata_kv.set_string(_kv_key(colour), sample_name)
        return self.metadata_kv.incr(_kv_key(_COUNT_KEY))

    def add_samples(self, sample_names) -> None:
        for sample_name in sample_names:
            self.add_sample(sample_name)

    def delete_sample(self, sample_name: str) -> None:
        colour = self.sample_to_colour(sample_name)
        if colour is not None:
            self._names[colour] = DELETION_SPECIAL_SAMPLE_NAME
            self.metadata_kv.set_string(
                _kv_key(colour), DELETION_SPECIAL_SAMPLE_NAME
            )
        self._colours[sample_name] = -1
        self.metadata_kv.set_integer(_kv_key(sample_name), -1)

    def merge_metadata(self, other: "SampleMetadata") -> None:
        for name in other.sample_names():
            try:
                self.add_sample(name)
            except ValueError:
                self.add_sample(name + MERGE_DUPLICATE_SUFFIX)
