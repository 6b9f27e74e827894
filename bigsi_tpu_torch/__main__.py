"""CLI of the port: ``python -m bigsi_tpu_torch <verb>``.

The verbs and flags are bigsi_tpu's (``make_parser``).  ``search``,
``bulk_search`` and ``serve`` run on :class:`bigsi_tpu_torch.BIGSI`,
on the CUDA engine unless the config says ``engine: numpy``.  Every
other verb is host-only and goes to ``bigsi_tpu.__main__.run``.
"""

from __future__ import annotations

import json
import logging

from bigsi_tpu import __main__ as host_cli
from bigsi_tpu.__main__ import d_to_csv, make_parser, result_dict
from bigsi_tpu.config import get_config_from_file
from bigsi_tpu.io.fasta import read_fasta
from bigsi_tpu_torch.graph import BIGSI

PORTED_VERBS = ("search", "bulk_search", "serve")


def run(args, device=None) -> str | None:
    """Run one parsed command; ``device`` places the CUDA engine (None:
    the current CUDA device)."""
    if args.command not in PORTED_VERBS:
        return host_cli.run(args)
    config = get_config_from_file(getattr(args, "config", None))
    if args.command == "serve":
        if args.distributed:
            raise NotImplementedError(
                "serve --distributed is not ported to bigsi_tpu_torch yet"
            )
        from bigsi_tpu_torch.http.server import serve

        serve(config, host=args.host, port=args.port, device=device)
        return None
    bigsi = BIGSI(config, device=device)
    if args.command == "search":
        d = result_dict(
            args.seq, args.threshold,
            bigsi.search(args.seq, args.threshold, args.score),
        )
        return d_to_csv(d) if args.format == "csv" else json.dumps(d, indent=4)
    seqs = [str(seq) for seq in read_fasta(args.fasta).values()]
    batch = bigsi.search_batch(seqs, args.threshold, args.score)
    out = [result_dict(seq, args.threshold, res) for seq, res in zip(seqs, batch)]
    if args.stream:
        for i, d in enumerate(out):
            print(d_to_csv(d, i == 0, False) if args.format == "csv" else json.dumps(d))
        return None
    if args.format == "csv":
        return "\n".join(d_to_csv(d, i == 0, False) for i, d in enumerate(out))
    return json.dumps(out, indent=4)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    out = run(make_parser().parse_args(argv))
    if out is not None:
        print(out)


if __name__ == "__main__":
    main()
