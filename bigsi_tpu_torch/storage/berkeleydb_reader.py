"""Pure-Python read-only BerkeleyDB DB_HASH reader.

The reference persists indexes in BerkeleyDB hash files
(``bigsi/storage/berkeleydb.py:12-19``, libdb 4.8) and reads them via
the optional ``bsddb3`` C binding.  This module reads the same files
with no native dependency, enough to migrate a reference index
(``scripts/convert_reference_index.py``) — read-only, DB_HASH only.

Format (libdb 4.8, little-endian files):

* page 0 is the hash metadata page: magic ``0x061561`` at offset 12,
  version at 16, pagesize at 20, page type ``P_HASHMETA`` (8) at 25;
* data pages (types ``P_HASH_UNSORTED`` 2 / ``P_HASH`` 13) carry a
  26-byte header (lsn 8, pgno 4, prev 4, next 4, entries u16 at 20,
  hf_offset u16 at 22, level u8, type u8) then ``entries`` u16 offsets;
  items are packed from the page end, so an item's length is the gap to
  the next-higher offset (or the page end);
* each item starts with a type byte: ``H_KEYDATA`` (1) inline bytes,
  ``H_OFFPAGE`` (3) a pointer {pad[3], pgno u32, tlen u32} to a chain
  of ``P_OVERFLOW`` (7) pages whose payload length is the header's
  hf_offset field;
* entries alternate key, value.

Duplicate sets (H_DUPLICATE / H_OFFDUP) are not supported — the
reference never writes duplicates.
"""

from __future__ import annotations

import struct

HASH_MAGIC = 0x061561
P_HASH_UNSORTED = 2
P_OVERFLOW = 7
P_HASHMETA = 8
P_HASH = 13

H_KEYDATA = 1
H_OFFPAGE = 3

_HDR = 26  # fixed page header size


class BerkeleyHashReader:
    """dict-like read-only view of a DB_HASH file."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self._buf = f.read()
        if len(self._buf) < _HDR:
            raise ValueError("%s: not a BerkeleyDB file (too small)" % path)
        magic, _version, pagesize = struct.unpack_from("<III", self._buf, 12)
        if magic != HASH_MAGIC:
            raise ValueError(
                "%s: bad magic %#x (not a DB_HASH file)" % (path, magic)
            )
        if self._buf[25] != P_HASHMETA:
            raise ValueError("%s: page 0 is not a hash metadata page" % path)
        self.pagesize = pagesize
        self._items = dict(self._scan())

    # -- mapping API ----------------------------------------------------

    def __getitem__(self, key: bytes) -> bytes:
        return self._items[key]

    def __contains__(self, key: bytes) -> bool:
        return key in self._items

    def __len__(self) -> int:
        return len(self._items)

    def get(self, key: bytes, default=None):
        return self._items.get(key, default)

    def keys(self):
        return self._items.keys()

    def items(self):
        return self._items.items()

    # -- parsing ---------------------------------------------------------

    def _page(self, pgno: int) -> memoryview:
        off = pgno * self.pagesize
        return memoryview(self._buf)[off: off + self.pagesize]

    def _scan(self):
        npages = len(self._buf) // self.pagesize
        for pgno in range(npages):
            page = self._page(pgno)
            if page[25] not in (P_HASH_UNSORTED, P_HASH):
                continue
            entries = struct.unpack_from("<H", page, 20)[0]
            offsets = struct.unpack_from("<%dH" % entries, page, _HDR)
            ends = {}
            ordered = sorted(set(offsets)) + [self.pagesize]
            for i, o in enumerate(ordered[:-1]):
                ends[o] = ordered[i + 1]
            if entries % 2:
                raise ValueError("odd entry count on page %d" % pgno)
            for i in range(0, entries, 2):
                key = self._item(page, offsets[i], ends)
                val = self._item(page, offsets[i + 1], ends)
                yield key, val

    def _item(self, page: memoryview, off: int, ends: dict) -> bytes:
        itype = page[off]
        if itype == H_KEYDATA:
            return bytes(page[off + 1: ends[off]])
        if itype == H_OFFPAGE:
            pgno, tlen = struct.unpack_from("<II", page, off + 4)
            return self._read_overflow(pgno, tlen)
        raise ValueError("unsupported hash item type %d" % itype)

    def _read_overflow(self, pgno: int, tlen: int) -> bytes:
        chunks = []
        remaining = tlen
        while pgno != 0 and remaining > 0:
            page = self._page(pgno)
            if page[25] != P_OVERFLOW:
                raise ValueError("page %d is not an overflow page" % pgno)
            length = struct.unpack_from("<H", page, 22)[0]
            take = min(length, remaining)
            chunks.append(bytes(page[_HDR: _HDR + take]))
            remaining -= take
            pgno = struct.unpack_from("<I", page, 16)[0]  # next_pgno
        data = b"".join(chunks)
        if len(data) != tlen:
            raise ValueError(
                "overflow chain truncated: wanted %d bytes, got %d"
                % (tlen, len(data))
            )
        return data
