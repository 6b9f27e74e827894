#! /usr/bin/env python
"""CLI of the port: ``python -m bigsi_tpu_torch <verb>``.

bigsi_tpu's verbs and flags, verb for verb with the reference CLI
(``bigsi/__main__.py``): insert, bloom, build, merge, search,
variant_search, bulk_search, delete — plus ``compact`` and ``serve``
(the HTTP API, see :mod:`bigsi_tpu_torch.http.server`).  Every verb that
opens an index opens :class:`bigsi_tpu_torch.BIGSI`, on the CUDA engine
unless the config says ``engine: numpy``; ``run(args, device="cpu")``
puts the CUDA engine's work on the CPU (the plain PyTorch versions).
Every search response carries the citation DOI, as the reference does
(``__main__.py:71``).
"""

from __future__ import annotations

import argparse
import csv
import functools
import io
import json
import logging
import sys

from bigsi_tpu_torch.cmds import (
    BIGSIAminoAcidMutationSearch,
    BIGSIVariantSearch,
    bloom,
    build,
    insert,
    merge,
)
from bigsi_tpu_torch.config import get_config_from_file, parse_size
from bigsi_tpu_torch.graph import BIGSI
from bigsi_tpu_torch.io.cortex import extract_kmers_from_ctx
from bigsi_tpu_torch.io.fasta import read_fasta
from bigsi_tpu_torch.storage import get_storage
from bigsi_tpu_torch.version import __version__

logger = logging.getLogger(__name__)

CITATION = "http://dx.doi.org/10.1038/s41587-018-0010-1"


def d_to_csv(d, with_header=True, carriage_return=True):
    """Result dict -> CSV rows (reference: ``__main__.py:41-63``)."""
    df = []
    results = d["results"]
    header = []
    if results:
        header = sorted(results[0].keys())
        if with_header:
            df.append(["query"] + header)
    for res in results:
        row = [d["query"]]
        for key in header:
            row.append(res[key])
        df.append(row)
    output = io.StringIO()
    writer = csv.writer(output, quoting=csv.QUOTE_NONNUMERIC)
    for row in df:
        writer.writerow(row)
    csv_string = output.getvalue()
    return csv_string if carriage_return else csv_string[:-1]


def result_dict(seq, threshold, results):
    """The canonical search-response schema (single source for the CLI,
    bulk paths, and HTTP server; reference shape at ``__main__.py:66-72``)."""
    return {
        "query": seq,
        "threshold": threshold,
        "results": results,
        "citation": CITATION,
    }


def search_bigsi(bigsi, seq, threshold, score):
    return result_dict(seq, threshold, bigsi.search(seq, threshold, score))


def _add_config_arg(p):
    p.add_argument("--config", "-c", default=None, help="YAML config file")


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="bigsi-tpu-torch", description="BIGSI genomic signature index on PyTorch and CUDA"
    )
    parser.add_argument("--version", action="version", version=__version__)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("bloom", help="create a Bloom filter from a cortex graph")
    p.add_argument("ctx")
    p.add_argument("outfile")
    _add_config_arg(p)

    p = sub.add_parser("build", help="build an index from .bloom files")
    p.add_argument("bloomfilters", nargs="*", default=[])
    p.add_argument("--samples", "-s", nargs="*", default=[])
    p.add_argument("--from_file", default=None, help="TSV of bloom-path<TAB>sample")
    _add_config_arg(p)

    p = sub.add_parser("insert", help="insert a bloom filter into the index")
    p.add_argument("bloomfilter")
    p.add_argument("sample")
    _add_config_arg(p)

    p = sub.add_parser("merge", help="merge a second index into this one")
    p.add_argument("merge_config")
    _add_config_arg(p)

    p = sub.add_parser(
        "compact",
        help="fold staged inserts (side.bin) into the main matrix",
    )
    _add_config_arg(p)

    p = sub.add_parser("search", help="search the index for a sequence")
    p.add_argument("seq")
    p.add_argument("--threshold", "-t", type=float, default=1.0)
    p.add_argument("--score", action="store_true")
    p.add_argument("--format", choices=["json", "csv"], default="json")
    _add_config_arg(p)

    p = sub.add_parser("bulk_search", help="search every record of a FASTA file")
    p.add_argument("fasta")
    p.add_argument("--threshold", "-t", type=float, default=1.0)
    p.add_argument("--score", action="store_true")
    p.add_argument("--format", choices=["json", "csv"], default="json")
    p.add_argument("--stream", action="store_true")
    _add_config_arg(p)

    p = sub.add_parser("variant_search", help="genotype a variant via probe search")
    p.add_argument("reference")
    p.add_argument("ref")
    p.add_argument("pos", type=int)
    p.add_argument("alt")
    p.add_argument("--gene", default=None)
    p.add_argument("--genbank", default=None)
    p.add_argument("--format", choices=["json", "csv"], default="json")
    _add_config_arg(p)

    p = sub.add_parser("delete", help="delete the index")
    _add_config_arg(p)

    p = sub.add_parser("serve", help="serve the HTTP API")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument(
        "--distributed",
        action="store_true",
        help="multi-process serving (not ported yet: raises)",
    )
    _add_config_arg(p)

    return parser


def run(args, device=None) -> str | None:
    """Run one parsed command; ``device`` places the CUDA engine of every
    index it opens (None: the current CUDA device)."""
    config = get_config_from_file(getattr(args, "config", None))
    open_index = functools.partial(BIGSI, device=device)
    cmd = args.command

    if cmd == "bloom":
        bloom(
            config=config,
            outfile=args.outfile,
            kmers=extract_kmers_from_ctx(args.ctx, config["k"]),
        )
        return None

    if cmd == "build":
        bloomfilters, samples = list(args.bloomfilters), list(args.samples)
        if args.from_file and bloomfilters:
            raise ValueError(
                "You can only specify blooms via from_file or bloomfilters, "
                "but not both"
            )
        if args.from_file:
            with open(args.from_file) as tsvfile:
                for row in csv.reader(tsvfile, delimiter="\t"):
                    bloomfilters.append(row[0])
                    samples.append(row[1])
        if samples:
            assert len(samples) == len(bloomfilters)
        else:
            samples = bloomfilters
        max_memory = (
            parse_size(config["max_build_mem_bytes"])
            if config.get("max_build_mem_bytes")
            else None
        )
        return json.dumps(
            build(
                config=config,
                bloomfilter_filepaths=bloomfilters,
                samples=samples,
                max_memory=max_memory,
                device=device,
            )
        )

    if cmd == "insert":
        return json.dumps(
            insert(index=open_index(config), bloomfilter=args.bloomfilter, sample=args.sample)
        )

    if cmd == "compact":
        index = open_index(config)
        n = index.side.num_cols if index.side is not None else 0
        index.compact()
        return json.dumps({"result": "compacted %d staged column(s)." % n})

    if cmd == "merge":
        merge_config = get_config_from_file(args.merge_config)
        merge(open_index(config), open_index(merge_config))
        return json.dumps(
            {"result": "merged %s into %s." % (args.merge_config, args.config)}
        )

    if cmd == "search":
        d = search_bigsi(open_index(config), args.seq, args.threshold, args.score)
        return d_to_csv(d) if args.format == "csv" else json.dumps(d, indent=4)

    if cmd == "bulk_search":
        fasta = read_fasta(args.fasta)
        bigsi = open_index(config)
        seqs = [str(seq) for seq in fasta.values()]
        # one batched device dispatch for the whole file (reference used
        # a multiprocessing.Pool here, ``bigsi/__main__.py:276-283``)
        batch = bigsi.search_batch(seqs, args.threshold, args.score)
        out = []
        for i, (seq, results) in enumerate(zip(seqs, batch)):
            d = result_dict(seq, args.threshold, results)
            if args.stream:
                print(
                    d_to_csv(d, i == 0, False)
                    if args.format == "csv"
                    else json.dumps(d)
                )
            else:
                out.append(d)
        if args.stream:
            return None
        if args.format == "csv":
            return "\n".join(
                d_to_csv(d, i == 0, False) for i, d in enumerate(out)
            )
        return json.dumps(out, indent=4)

    if cmd == "variant_search":
        bigsi = open_index(config)
        if args.genbank and args.gene:
            d = BIGSIAminoAcidMutationSearch(bigsi, args.reference, args.genbank).search(
                args.gene, args.ref, args.pos, args.alt
            )
        elif args.genbank or args.gene:
            raise ValueError("genbank and gene must be supplied together")
        else:
            d = BIGSIVariantSearch(bigsi, args.reference).search(
                args.ref, args.pos, args.alt
            )
        d["citation"] = CITATION
        return d_to_csv(d) if args.format == "csv" else json.dumps(d, indent=4)

    if cmd == "delete":
        get_storage(config).delete_all()
        return json.dumps({"result": "success"})

    if cmd == "serve":
        from bigsi_tpu_torch.http.server import serve

        serve(
            config,
            host=args.host,
            port=args.port,
            device=device,
            distributed=getattr(args, "distributed", False),
        )
        return None

    raise ValueError("unknown command %r" % cmd)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = make_parser().parse_args(argv)
    out = run(args)
    if out is not None:
        print(out)


if __name__ == "__main__":
    main()
