"""HTTP API.

Route-for-route with the reference's hug app (``bigsi/__main__.py``):

* ``GET/POST /search?seq=...&threshold=&score=&format=``
* ``GET/POST /bulk_search?fasta=...`` (server-side FASTA path)
* ``POST /insert?bloomfilter=...&sample=...``
* ``POST /merge?merge_config=...``
* ``GET/POST /variant_search?reference=...&ref=&pos=&alt=[&gene=&genbank=]``
* ``DELETE /``

Implemented on the stdlib ``http.server`` with a threading server: one
shared :class:`bigsi_tpu_torch.BIGSI` handle serves all requests
(queries are read-only; the engine batches on device, on the server's
``device``).  Responses carry
``Access-Control-Allow-Origin: *`` and the citation DOI like the
reference.  No hug/falcon/uWSGI dependency.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from bigsi_tpu_torch.cmds import (
    BIGSIAminoAcidMutationSearch,
    BIGSIVariantSearch,
    insert,
    merge,
)
from bigsi_tpu_torch.config import get_config_from_file
from bigsi_tpu_torch.graph import BIGSI
from bigsi_tpu_torch.io.fasta import read_fasta

logger = logging.getLogger(__name__)

CITATION = "http://dx.doi.org/10.1038/s41587-018-0010-1"


def _bool(v, default=False):
    if v is None:
        return default
    return str(v).lower() in ("1", "true", "yes", "on")


class BigsiHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, config, device=None):
        self.config = config
        self.device = device
        self.read_only = False  # distributed serving forbids mutation
        self._bigsi = None
        self._batcher = None
        self._lock = threading.RLock()  # batcher resolves bigsi under it
        super().__init__(addr, _Handler)

    @property
    def bigsi(self) -> BIGSI:
        with self._lock:
            if self._bigsi is None:
                self._bigsi = BIGSI(self.config, device=self.device)
            return self._bigsi

    @property
    def batcher(self):
        """Micro-batcher coalescing concurrent /search dispatches
        (config ``serve_batching: false`` disables; ``serve_batch_wait_ms``
        tunes the linger, default 3)."""
        if not self.config.get("serve_batching", True):
            return None
        with self._lock:
            if self._batcher is None:
                from bigsi_tpu_torch.http.batcher import QueryBatcher

                # resolve bigsi INSIDE the critical section (RLock) so a
                # concurrent invalidate() can't hand the new batcher a
                # stale pre-invalidation index
                self._batcher = QueryBatcher(
                    self.bigsi,
                    max_wait_ms=float(self.config.get("serve_batch_wait_ms", 3)),
                )
            return self._batcher

    def invalidate(self):
        with self._lock:
            if self._batcher is not None:
                self._batcher.close()
            self._batcher = None
            self._bigsi = None


class _Handler(BaseHTTPRequestHandler):
    server: BigsiHTTPServer

    def log_message(self, fmt, *args):
        logger.info("%s %s", self.address_string(), fmt % args)

    def _params(self) -> dict:
        parsed = urllib.parse.urlparse(self.path)
        params = {k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()}
        length = int(self.headers.get("Content-Length") or 0)
        if length:
            body = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "")
            if "json" in ctype:
                params.update(json.loads(body))
            else:
                params.update(
                    {k: v[0] for k, v in urllib.parse.parse_qs(body.decode()).items()}
                )
        return params

    def _route(self) -> str:
        return urllib.parse.urlparse(self.path).path.rstrip("/") or "/"

    def _reply(self, payload, status=200, content_type="application/json"):
        body = payload if isinstance(payload, bytes) else payload.encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, exc, status=500):
        logger.exception("request failed")
        self._reply(json.dumps({"error": str(exc)}), status=status)

    def do_GET(self):
        self._dispatch(
            {"/search", "/bulk_search", "/variant_search", "/", "/metrics"}
        )

    def do_POST(self):
        self._dispatch(
            {"/search", "/bulk_search", "/variant_search", "/insert",
             "/merge", "/build", "/bloom"}
        )

    MUTATING_ROUTES = frozenset({"/insert", "/merge", "/build", "/bloom"})

    def do_DELETE(self):
        route = self._route()
        if route != "/":
            return self._reply(json.dumps({"error": "not found"}), 404)
        if self.server.read_only:
            return self._reply(
                json.dumps({"error": "index is served read-only"}), 403
            )
        try:
            self.server.bigsi.delete()
            self.server.invalidate()
            self._reply(json.dumps({"result": "success"}))
        except Exception as e:  # noqa: BLE001 — surface as HTTP 500
            self._error(e)

    def _dispatch(self, allowed):
        route = self._route()
        if route not in allowed:
            return self._reply(json.dumps({"error": "not found"}), 404)
        if self.server.read_only and route in self.MUTATING_ROUTES:
            return self._reply(
                json.dumps({"error": "index is served read-only"}), 403
            )
        try:
            params = self._params()
            handler = {
                "/": self._handle_root,
                "/metrics": self._handle_metrics,
                "/search": self._handle_search,
                "/bulk_search": self._handle_bulk_search,
                "/variant_search": self._handle_variant_search,
                "/insert": self._handle_insert,
                "/merge": self._handle_merge,
                "/build": self._handle_build,
                "/bloom": self._handle_bloom,
            }[route]
            handler(params)
        except KeyError as e:
            self._error("missing parameter: %s" % e, status=400)
        except Exception as e:  # noqa: BLE001
            self._error(e)

    def _search_dict(self, seq, threshold, score):
        from bigsi_tpu_torch.__main__ import result_dict

        batcher = self.server.batcher
        results = (
            batcher.search(seq, threshold, score)
            if batcher is not None
            else self.server.bigsi.search(seq, threshold, score)
        )
        return result_dict(seq, threshold, results)

    def _handle_root(self, params):
        self._reply(
            json.dumps(
                {
                    "service": "bigsi-tpu",
                    "routes": [
                        "/search",
                        "/bulk_search",
                        "/variant_search",
                        "/insert",
                        "/merge",
                        "/build",
                        "/bloom",
                        "/metrics",
                    ],
                }
            )
        )

    def _handle_metrics(self, params):
        from bigsi_tpu_torch.utils.profiling import metrics

        self._reply(json.dumps(metrics.snapshot(), indent=4))

    def _handle_search(self, params):
        from bigsi_tpu_torch.__main__ import d_to_csv

        d = self._search_dict(
            params["seq"],
            float(params.get("threshold", 1.0)),
            _bool(params.get("score")),
        )
        if params.get("format") == "csv":
            self._reply(d_to_csv(d), content_type="text/csv")
        else:
            self._reply(json.dumps(d, indent=4))

    def _handle_bulk_search(self, params):
        from bigsi_tpu_torch.__main__ import d_to_csv

        fasta = read_fasta(params["fasta"])
        threshold = float(params.get("threshold", 1.0))
        score = _bool(params.get("score"))
        from bigsi_tpu_torch.__main__ import result_dict

        seqs = [str(seq) for seq in fasta.values()]
        batch = self.server.bigsi.search_batch(seqs, threshold, score)
        dd = [
            result_dict(seq, threshold, results)
            for seq, results in zip(seqs, batch)
        ]
        if params.get("format") == "csv":
            self._reply(
                "\n".join(d_to_csv(d, i == 0, False) for i, d in enumerate(dd)),
                content_type="text/csv",
            )
        else:
            self._reply(json.dumps(dd, indent=4))

    def _handle_variant_search(self, params):
        bigsi = self.server.bigsi
        gene, genbank = params.get("gene"), params.get("genbank")
        if gene and genbank:
            d = BIGSIAminoAcidMutationSearch(bigsi, params["reference"], genbank).search(
                gene, params["ref"], int(params["pos"]), params["alt"]
            )
        elif gene or genbank:
            raise ValueError("genbank and gene must be supplied together")
        else:
            d = BIGSIVariantSearch(bigsi, params["reference"]).search(
                params["ref"], int(params["pos"]), params["alt"]
            )
        d["citation"] = CITATION
        self._reply(json.dumps(d, indent=4))

    def _handle_insert(self, params):
        result = insert(
            index=self.server.bigsi,
            bloomfilter=params["bloomfilter"],
            sample=params["sample"],
        )
        self.server.invalidate()
        self._reply(json.dumps(result))

    def _handle_bloom(self, params):
        """Server-side bloom construction from a cortex graph
        (reference route: ``bigsi/__main__.py:119-131``)."""
        from bigsi_tpu_torch.cmds import bloom
        from bigsi_tpu_torch.io.cortex import extract_kmers_from_ctx

        config = self.server.config
        bloom(
            config=config,
            outfile=params["outfile"],
            kmers=extract_kmers_from_ctx(params["ctx"], config["k"]),
        )
        self._reply(json.dumps({"result": "success"}))

    def _handle_build(self, params):
        """Server-side index build from .bloom files (reference route:
        ``bigsi/__main__.py:134-171``).  Accepts ``bloomfilters`` and
        ``samples`` as JSON arrays or comma-separated strings, or a
        ``from_file`` TSV path."""
        from bigsi_tpu_torch.cmds import build
        from bigsi_tpu_torch.config import parse_size

        def as_list(v):
            if v is None:
                return []
            if isinstance(v, str):
                return [x for x in v.split(",") if x]
            return list(v)

        bloomfilters = as_list(params.get("bloomfilters"))
        samples = as_list(params.get("samples"))
        from_file = params.get("from_file")
        if from_file and bloomfilters:
            raise ValueError(
                "specify blooms via from_file or bloomfilters, not both"
            )
        if from_file:
            import csv as _csv

            bloomfilters, samples = [], []
            with open(from_file) as tsvfile:
                for row in _csv.reader(tsvfile, delimiter="\t"):
                    bloomfilters.append(row[0])
                    samples.append(row[1])
        if not bloomfilters:
            raise KeyError("bloomfilters")
        if not samples:
            samples = list(bloomfilters)
        if len(samples) != len(bloomfilters):
            raise ValueError("samples and bloomfilters must pair up")
        config = self.server.config
        max_memory = (
            parse_size(config["max_build_mem_bytes"])
            if config.get("max_build_mem_bytes")
            else None
        )
        result = build(
            config=config,
            bloomfilter_filepaths=bloomfilters,
            samples=samples,
            max_memory=max_memory,
            device=self.server.device,
        )
        self.server.invalidate()
        self._reply(json.dumps(result))

    def _handle_merge(self, params):
        merge_config = get_config_from_file(params["merge_config"])
        result = merge(self.server.bigsi, BIGSI(merge_config, device=self.server.device))
        self.server.invalidate()
        self._reply(json.dumps(result))


def make_server(config, host="0.0.0.0", port=8000, device=None) -> BigsiHTTPServer:
    return BigsiHTTPServer((host, port), config, device)


def serve(config, host="0.0.0.0", port=8000, device=None, distributed=False) -> None:
    if distributed:
        return serve_distributed(config, host, port, device)
    server = make_server(config, host, port, device)
    logger.info("bigsi-tpu-torch serving on %s:%d", host, port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.invalidate()
        server.server_close()


def serve_distributed(config, host="0.0.0.0", port=8000, device=None) -> None:
    """Multi-process serving: the index is split over the ranks of the
    process group (:func:`bigsi_tpu_torch.parallel.distributed.initialize`,
    from ``BIGSI_TPU_COORDINATOR``, ``BIGSI_TPU_NUM_PROCESSES`` and
    ``BIGSI_TPU_PROCESS_ID``), each rank on its own device (``device``
    where given, else ``cuda:{rank % device_count}``); rank 0 answers
    HTTP, the other ranks run their parts of each dispatch
    (``run_worker_loop``).  Serving is read-only: mutating routes answer
    403; rebuild or merge offline, then restart the fleet.  When rank 0's
    server ends (SIGINT included) it stops the other ranks.  Every rank
    leaves the process group before it returns."""
    from bigsi_tpu_torch.parallel import distributed

    distributed.initialize()
    try:
        _serve_rank(config, host, port, device)
    finally:
        distributed.shutdown()


def _serve_rank(config, host, port, device) -> None:
    """This rank's part of :func:`serve_distributed`, in the process
    group."""
    import torch.distributed as dist

    cfg = dict(config, engine="distributed")
    graph = BIGSI(cfg, device=device)
    # the collective engine is graph.engine, except on verified (screen:)
    # indexes, where it runs the screen and graph.engine verifies on rank 0
    collective = next(
        (e for e in (graph.engine, graph.screen_engine) if hasattr(e, "run_worker_loop")), None
    )
    if collective is None:
        raise ValueError(
            "serve --distributed: the index of %r opened no distributed engine"
            % cfg.get("storage-config", {}).get("filename")
        )
    rank, world = dist.get_rank(), dist.get_world_size()
    if rank != 0:
        logger.info("bigsi-tpu-torch distributed worker %d of %d running", rank, world)
        collective.run_worker_loop()
        return
    server = None
    try:  # the other ranks leave their loops however rank 0's server ends
        server = make_server(cfg, host, port, device)
        server._bigsi = graph  # the handle every rank opened
        server.read_only = True
        logger.info("bigsi-tpu-torch distributed serving on %s:%d (%d ranks)", host, port, world)
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        collective.stop()
        if server is not None:
            server.server_close()
