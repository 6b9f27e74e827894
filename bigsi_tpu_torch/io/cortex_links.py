"""Cortex links (``.ctp``) reader + link-guided graph traversal.

Completes the reference's sequence-format surface
(``bigsi/utils/cortex.py:267-443``; dead code in the reference's main
path, provided here for full parity).  A ``.ctp`` file is gzipped text:
a JSON header (multi-line, brace-balanced; schema v2 ``fileFormat`` or
v3 ``file_format``/``graph``/``paths``), then per-kmer link blocks::

    <kmer> <num_paths>
    <F|R> <num_kmers> <num_juncs> <count[,count...]> <junction-bases>

Links record, for a k-mer where the de Bruijn graph branches, which
junction bases a read-coherent walk takes — they let a traversal
recover contigs through branch points that plain edges cannot resolve.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
from typing import Iterator

COMPLEMENT = str.maketrans("ACGT", "TGCA")


def reverse_complement(seq: str) -> str:
    return seq.translate(COMPLEMENT)[::-1]


@dataclasses.dataclass
class LinkPath:
    """One link: a junction-choice path starting at a k-mer."""

    direction: str  # "F" (follow the canonical kmer forward) or "R"
    num_kmers: int  # k-mers covered by the original read path
    counts: list  # per-colour observation counts
    junctions: str  # branch bases consumed in order at junctions

    def __post_init__(self):
        if self.direction not in ("F", "R"):
            raise ValueError("link direction must be F or R, got %r" % self.direction)


@dataclasses.dataclass
class LinksHeader:
    kmer_size: int
    num_colours: int
    num_kmers_in_graph: int
    num_kmers_with_paths: int
    colours: list
    format_version: int


class LinksReader:
    """Iterate ``(kmer, [LinkPath, ...])`` blocks of a ``.ctp`` file."""

    def __init__(self, path: str):
        self._f = gzip.open(path, "rt")
        self.header = self._parse_header()

    def _parse_header(self) -> LinksHeader:
        depth = 0
        buf = []
        while True:
            line = self._f.readline()
            if not line:
                raise ValueError("truncated .ctp header")
            buf.append(line)
            depth += line.count("{") - line.count("}")
            if buf and depth == 0 and "{" in "".join(buf):
                break
        meta = json.loads("".join(buf))
        if "fileFormat" in meta:  # schema v2
            if meta["fileFormat"] != "ctp" or meta["formatVersion"] != 2:
                raise ValueError("not a ctp v2 header")
            return LinksHeader(
                kmer_size=meta["kmer_size"],
                num_colours=meta["ncols"],
                num_kmers_in_graph=meta["num_kmers_in_graph"],
                num_kmers_with_paths=meta["num_kmers_with_paths"],
                colours=meta.get("colours", []),
                format_version=2,
            )
        if meta.get("file_format") != "ctp" or meta.get("format_version") != 3:
            raise ValueError("not a ctp header (v2 or v3)")
        graph, paths = meta["graph"], meta["paths"]
        return LinksHeader(
            kmer_size=graph["kmer_size"],
            num_colours=graph["num_colours"],
            num_kmers_in_graph=graph["num_kmers_in_graph"],
            num_kmers_with_paths=paths["num_kmers_with_paths"],
            colours=graph.get("colours", []),
            format_version=3,
        )

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            line = self._f.readline()
            if not line:
                raise StopIteration
            line = line.strip()
            if line and not line.startswith("#"):
                break
        kmer, num_paths = line.split()[0], int(line.split()[1])
        paths = []
        for _ in range(int(num_paths)):
            d, nk, nj, counts, juncs = self._f.readline().split()[:5]
            if int(nj) != len(juncs):
                raise ValueError(
                    "junction count %s != junction string %r" % (nj, juncs)
                )
            paths.append(
                LinkPath(d, int(nk), [int(c) for c in counts.split(",")], juncs)
            )
        return kmer, paths

    def close(self) -> None:
        self._f.close()


def load_links(path: str) -> tuple[LinksHeader, dict]:
    """Read a whole ``.ctp`` into {canonical_kmer: [LinkPath, ...]}."""
    reader = LinksReader(path)
    links = dict(reader)
    if len(links) != reader.header.num_kmers_with_paths:
        raise ValueError(
            "header promises %d linked kmers, file holds %d"
            % (reader.header.num_kmers_with_paths, len(links))
        )
    reader.close()
    return reader.header, links


def adjacent_kmers(kmer: str, edges, orientation: int) -> list:
    """Next k-mers from a record's decoded edge byte.

    ``edges`` is ``(fwd_bases, rev_bases)`` (io/cortex.py:decode_edges);
    orientation 0 extends the canonical k-mer rightward, 1 walks the
    reverse-complement strand (prepend on the canonical form).
    """
    fwd, rev = edges
    if orientation == 0:
        return [kmer[1:] + b for b in fwd]
    return [b + kmer[:-1] for b in rev]


def traverse(graph: dict, links: dict, seed: str, colour: int = 0) -> str:
    """Link-guided contig assembly from ``seed``.

    ``graph`` maps canonical k-mer -> ``(fwd_bases, rev_bases)`` edge
    tuples (one colour); ``links`` maps canonical k-mer ->
    ``[LinkPath]``.  Walks the unique edge where the graph is linear; at
    junctions the OLDEST live link's next junction base picks the
    branch, and links that disagree are dropped — the standard
    mccortex link-following rule (reference behavior:
    ``bigsi/utils/cortex.py:372-443``).
    """
    kmer = seed
    contig = seed[:-1]
    orient = 0  # 0: seed strand matches the canonical walk direction
    live: list = []  # (age, remaining junction bases)
    # cycle guard: palindromic / rc-colliding k-mers can make the walk
    # revisit states forever (the reference traverser loops); stop after
    # more steps than the graph has nodes to extend with
    budget = 2 * len(graph) + len(seed)
    while kmer is not None and budget > 0:
        budget -= 1
        contig += kmer[-1] if orient == 0 else reverse_complement(kmer[0])
        canon = min(kmer, reverse_complement(kmer))
        if canon != kmer:
            orient ^= 1
        want = "F" if orient == 0 else "R"
        for lp in links.get(canon, ()):
            # zero-junction links carry no branch information — admitting
            # one would make live[0][1][0] blow up at the next junction
            if lp.direction == want and lp.junctions:
                live.append((0, lp.junctions))
        edges = graph.get(canon)
        if edges is None:
            # an edge pointed at a k-mer the caller's graph dict doesn't
            # hold (e.g. a partial/subset graph): the contig ends here
            break
        nxt = adjacent_kmers(canon, edges, orient)
        kmer = None
        if len(nxt) == 1:
            kmer = nxt[0]
        elif len(nxt) > 1 and live:
            junction = live[0][1][0]
            pos, base = (-1, junction) if orient == 0 else (
                0, reverse_complement(junction)
            )
            for cand in nxt:
                if cand[pos] == base:
                    kmer = cand
            live = [
                (age + 1, rest[1:])
                for age, rest in live
                if rest[0] == junction and len(rest) > 1
            ]
    return contig
