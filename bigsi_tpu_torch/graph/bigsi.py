"""BIGSI facade: metadata + signature index + scoring, on the CUDA engine.

API and result-schema parity with ``bigsi/graph/bigsi.py``:

* ``BIGSI.bloom / build / search / insert / merge / delete``;
* search result dicts ``{percent_kmers_found, num_kmers,
  num_kmers_found, sample_name}`` (``bigsi.py:105-114``), score keys
  appended when ``score=True``;
* ``num_kmers`` counts *distinct* query k-mers; the inexact threshold
  is ``ceil(|distinct| * t)`` (``bigsi.py:179``);
* deleted samples (renamed ``D3L3T3D``) are filtered from output
  (``bigsi.py:186-190``); inexact results sort by hits descending.

The query pipeline is batch-vectorized end to end: one ASCII k-mer
matrix, one hash batch, one fused gather/AND/count on the engine —
no per-kmer Python.

This is bigsi_tpu's facade with the port's engine seam: the config's
``engine`` picks the engine (:func:`engine_factory_for`):

* absent: the CUDA engine
  (:class:`~bigsi_tpu_torch.index.device_engine.DeviceEngine`, on
  ``device``, CUDA unless given);
* ``numpy``: the host engine;
* ``mesh``: the sharded mesh engine
  (:class:`~bigsi_tpu_torch.parallel.sharding.MeshEngine`) over ``mesh:
  [d, k, s(, r)]``, its positions on the CUDA devices or all on
  ``device`` where one is given;
* ``distributed``: the multi-process engine
  (:class:`~bigsi_tpu_torch.parallel.distributed.DistributedEngine`) of
  ``serve --distributed``, the same ``mesh`` across the ranks of the
  process group (``parallel.distributed.initialize``), each rank on its
  own device (``device`` where given); without the process group it
  raises;
* anything else is refused: the JAX engines are not part of the port.

A screened (verified) index answers as a classic one (bigsi_tpu's
two-stage search, :mod:`bigsi_tpu_torch.index.verify`): the config's
engine runs the minimizer screen over ``screen.bin``, the classic counts
of the screen's candidate colours are verified from ``rows.bin``.  A
batch verifies on :class:`~bigsi_tpu_torch.index.device_engine.DeviceVerifier`
(kernel A on ``device``), staged at the first batch; a single ``search``
uses it once staged, else the host pass.  Config ``verify-device``: true
forces it, false disables it, absent engages it on the CUDA engine when
``rows.bin`` fits the device's free memory (or
``verify-device-max-bytes`` where set); without it the host pass
verifies.  On the CPU
``tests/test_torch_verified.py`` holds this path to bigsi_tpu, on the
card ``chip_smoke.py``'s verified phase.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import logging
import math
import os
import threading

import numpy as np

from bigsi_tpu_torch import native
from bigsi_tpu_torch.bloom import BloomFilter
from bigsi_tpu_torch.constants import DEFAULT_CONFIG, DEFAULT_NPROC
from bigsi_tpu_torch.graph.metadata import DELETION_SPECIAL_SAMPLE_NAME, SampleMetadata
from bigsi_tpu_torch.hashing.scheme import CLASSIC
from bigsi_tpu_torch.index import verify
from bigsi_tpu_torch.index.device_engine import (
    DeviceEngine,
    DeviceVerifier,
    Hits,
    dense_hits,
    device_fits,
    resolve_device,
)
from bigsi_tpu_torch.index.host_engine import (
    HostEngine,
    counts_batch_fallback,
    presence_strings_fallback,
)
from bigsi_tpu_torch.index.signature import KmerSignatureIndex
from bigsi_tpu_torch.kmers import (
    ascii_to_strings,
    convert_query_kmers,
    seq_to_kmer_matrix,
    seq_to_kmers,
    unique_rows_with_inverse,
)
from bigsi_tpu_torch.scoring import Scorer
from bigsi_tpu_torch.storage import get_storage
from bigsi_tpu_torch.utils.profiling import device_trace, metrics, phase, spans, trace_dir

logger = logging.getLogger(__name__)

MIN_UNIQUE_KMERS_IN_QUERY = 0


def validate_build_params(bloomfilters, samples):
    if len(bloomfilters) != len(samples):
        raise ValueError(
            "There must be the same number of bloomfilters and sample names"
        )


@dataclasses.dataclass(eq=False)
class BigsiQueryResult:
    """One hit of a search.

    ``todict()`` is the wire schema — key set, ordering, and the
    2-decimal percent rounding match the reference's result object
    (``bigsi/graph/bigsi.py:91-126``); score keys (``score``,
    ``pident``, ``evalue``, ``kmer-presence``, ...) merge in when
    scoring ran.
    """

    colour: int
    sample_name: str
    num_kmers_found: int
    num_kmers: int
    score: dict | None = None

    @property
    def percent_kmers_found(self) -> float:
        return round(100 * self.num_kmers_found / self.num_kmers, 2)

    def add_score(self, score: dict) -> None:
        self.score = score

    @staticmethod
    def wire(sample_name: str, num_kmers_found: int, num_kmers: int) -> dict:
        """The wire dict of an unscored hit, without building the object."""
        return {
            "percent_kmers_found": round(100 * num_kmers_found / num_kmers, 2),
            "num_kmers": num_kmers,
            "num_kmers_found": num_kmers_found,
            "sample_name": sample_name,
        }

    def todict(self) -> dict:
        out = self.wire(self.sample_name, self.num_kmers_found, self.num_kmers)
        if self.score:
            out.update(self.score)
        return out

    def tojson(self) -> str:
        return json.dumps(self.todict())

    def __repr__(self) -> str:
        return self.tojson()

    def __eq__(self, other) -> bool:
        return self.todict() == other.todict()


class BIGSI(SampleMetadata, KmerSignatureIndex):
    def __init__(self, config=None, engine_factory=None, device=None):
        if config is None:
            config = DEFAULT_CONFIG
        self.config = config
        if trace_dir(config):  # the span log is on while a trace dir is set
            spans.start()
        self.storage = get_storage(config)
        SampleMetadata.__init__(self, self.storage.kv)
        KmerSignatureIndex.__init__(
            self, self.storage,
            engine_factory=engine_factory or engine_factory_for(config, device),
        )
        self.device = device
        self.min_unique_kmers_in_query = MIN_UNIQUE_KMERS_IN_QUERY
        self.scorer = Scorer(self.num_samples)
        # each calling thread's buffer of the classic native pass's row ids,
        # reused call after call: a fresh 9 MB a genes call let glibc trim
        # and fault its heap afresh every call (PERF.md §6)
        self._classic_ids = threading.local()
        # verified indexes: the classic matrix goes to the device for the
        # verify when it fits.  Staging is lazy (the first batched
        # verify): single-query serving never pays the upload.
        # _rebuild_engines drops the staged copy wherever the matrix
        # changes.
        self._want_verifier = False
        if self.screen is not None:
            want = config.get("verify-device")
            self._want_verifier = want is True or (
                want is None and config.get("engine") is None
                and self._verifier_fits(config.get("verify-device-max-bytes"))
            )

    def _verifier_fits(self, max_bytes) -> bool:
        """Whether rows.bin fits the device beside what it holds now
        (:func:`~bigsi_tpu_torch.index.device_engine.device_fits`), or
        under ``verify-device-max-bytes`` where the config sets it; a
        matrix that does not fit is verified on the host, and says so."""
        nbytes = self.bitmatrix.words.nbytes
        if max_bytes is not None:
            fits = nbytes <= int(max_bytes)
        else:
            fits = device_fits(nbytes, resolve_device(self.device))
        if not fits:
            logger.warning(
                "verify-device: rows.bin (%d B) does not fit %s; the verify "
                "runs on the host", nbytes,
                "verify-device-max-bytes" if max_bytes is not None else "the device",
            )
        return fits

    @property
    def verifier(self):
        """The device verifier, staged at the first call that wants it
        (one thread stages; the others wait for it)."""
        if self._verifier is None and self._want_verifier:
            with self._verifier_lock:
                if self._verifier is None:
                    self._verifier = DeviceVerifier(self.bitmatrix, device=self.device)
        return self._verifier

    @property
    def kmer_size(self):
        return self.config["k"]

    @property
    def nproc(self):
        return self.config.get("nproc", DEFAULT_NPROC)

    # -- build-time classmethods --------------------------------------

    @classmethod
    def bloom(cls, config, kmers):
        from bigsi_tpu_torch.hashing.scheme import default_slot_scheme
        from bigsi_tpu_torch.index.verify import screen_params_from_config

        kmers = list(convert_query_kmers(kmers))
        layout = config.get("layout", "classic")
        screen = screen_params_from_config(config)
        bloomfilter = BloomFilter(
            m=config["m"],
            h=config["h"],
            layout=layout,
            tile_rows=config.get("tile-rows", 32),
            window=config.get("minimizer-window"),
            slot_scheme=default_slot_scheme(layout, config),
        )
        bloomfilter.update(kmers)
        if screen is None:
            return bloomfilter.bitarray
        # verified build: classic bloom (m bits) + minimizer screen
        # bloom (screen m bits) concatenated — one .bloom artifact per
        # sample still restarts a build (SURVEY §5.4)
        sbloom = BloomFilter(
            m=screen["m"], h=config["h"], layout="minimizer",
            tile_rows=screen["tile_rows"], window=screen["window"],
            slot_scheme=screen["slot_scheme"],
        )
        sbloom.update(kmers)
        return np.concatenate([bloomfilter.bitarray, sbloom.bitarray])

    @classmethod
    def build(cls, config, bloomfilters, samples, engine_factory=None, device=None):
        """Write the index; -> it opened on the config's engine."""
        storage = get_storage(config)
        validate_build_params(bloomfilters, samples)
        with phase("build.metadata"):
            SampleMetadata(storage.kv).add_samples(samples)
        with device_trace("build.index", config):
            from bigsi_tpu_torch.hashing.scheme import default_slot_scheme
            from bigsi_tpu_torch.index.verify import screen_params_from_config

            layout = config.get("layout", "classic")
            KmerSignatureIndex.create(
                storage,
                bloomfilters,
                config["m"],
                config["h"],
                config.get("low_mem_build", False),
                layout=layout,
                tile_rows=config.get("tile-rows", 32),
                minimizer_window=config.get("minimizer-window"),
                slot_scheme=default_slot_scheme(layout, config),
                run_len=config.get("run-len"),
                screen=screen_params_from_config(config),
            )
        storage.close()
        metrics.incr("build.samples", len(samples))
        return cls(config, engine_factory=engine_factory, device=device)

    # -- queries ------------------------------------------------------

    def search(self, seq, threshold=1.0, score=False):
        self.__validate_search_query(seq)
        assert threshold <= 1
        kmer_mat = seq_to_kmer_matrix(seq, self.kmer_size)
        uniq, inverse = unique_rows_with_inverse(kmer_mat)
        metrics.incr("search.queries")
        metrics.incr("search.kmers", int(uniq.shape[0]))
        num_kmers = uniq.shape[0]
        if num_kmers == 0:
            # Queries shorter than k have no k-mers; the reference
            # crashes here (UnboundLocalError in unpack_and_sum) — we
            # return no hits instead.
            return []
        if self.screen is not None and not score:
            # two-stage verified search: screen (minimizer, the engine) ->
            # classic verification of the candidate colours (rows.bin).
            # score=True takes the classic host path below: scoring needs
            # full per-kmer presence, and the classic engine IS the
            # verified semantics.
            min_kmers = math.ceil(num_kmers * threshold)
            with phase("search.verified"):
                results = self._verified_filter(uniq, num_kmers, min_kmers,
                                                threshold)
            return [
                r.todict()
                for r in results
                if not r.sample_name == DELETION_SPECIAL_SAMPLE_NAME
            ]
        with phase("search.lookup"):
            row_idx = self.kmer_matrix_to_row_idx(uniq)
            packed = self.engine.and_rows(row_idx)
            side_pres = self.side_presence(row_idx)  # staged inserts
        min_kmers = math.ceil(num_kmers * threshold)
        if threshold == 1.0:
            results = self.__exact_filter(packed, num_kmers, side_pres)
        else:
            results = self.__inexact_filter(
                packed, num_kmers, min_kmers, side_pres
            )
        if score:
            scores = self._score([row_idx], [inverse], [[r.colour for r in results]],
                                 [packed], [side_pres])
            for r, score in zip(results, scores[0]):
                r.add_score(score)
        return [
            r.todict()
            for r in results
            if not r.sample_name == DELETION_SPECIAL_SAMPLE_NAME
        ]

    def search_batch(self, seqs, threshold=1.0, score=False):
        """Search many sequences in ONE device dispatch.

        Returns a list (one entry per input seq) of result-dict lists —
        each entry identical to what :meth:`search` returns for that
        sequence.  Replaces the reference's ``bulk_search``
        ``multiprocessing.Pool`` fan-out (``bigsi/__main__.py:276-283``)
        with a single batched gather/AND/count program: queries are
        padded to one static k-mer bucket and masked.

        The exact filter needs no separate AND pass: a sample matches
        exactly iff its hit count equals the distinct-kmer count.
        Scoring (``score=True``) runs the batched counts dispatch first,
        then asks the engine for the presence strings of every hit
        query's results in one call (one kernel launch on the card; the
        reference scores per result with per-char string joins,
        ``bigsi.py:232-239``).

        The call is one span, ``search.batch``: the root of every span it
        opens, the recursive calls of its length splits included.
        """
        with phase("search.batch"):
            return self._search_batch(seqs, threshold, score)

    def _search_batch(self, seqs, threshold, score):
        assert threshold <= 1
        seqs = list(seqs)
        if len(seqs) <= 1:
            return [self.search(s, threshold, score) for s in seqs]
        h = self.num_hashes
        b = len(seqs)
        # wildly mixed lengths: EVERY dispatch path pads per-query work
        # to the longest query (k-mer bucket for the host-prep/screen
        # paths, byte bucket for the seq path), so a genome-scale
        # straggler multiplies the whole batch's cost.  Length-bucket
        # up front and recurse on each side; both sides re-enter every
        # fast path at their own natural padding.
        if b >= 8:
            lens = sorted(len(s) for s in seqs)
            cut = 2 * max(256, lens[b // 2])
            if lens[-1] > 2 * cut:
                short_i = [i for i, s in enumerate(seqs) if len(s) <= cut]
                if 0 < len(short_i) < b:
                    long_i = [
                        i for i in range(b) if len(seqs[i]) > cut
                    ]
                    sres = self.search_batch(
                        [seqs[i] for i in short_i], threshold, score
                    )
                    lres = self.search_batch(
                        [seqs[i] for i in long_i], threshold, score
                    )
                    out = [None] * b
                    for j, i in enumerate(short_i):
                        out[i] = sres[j]
                    for j, i in enumerate(long_i):
                        out[i] = lres[j]
                    return out
        engine = self.engine
        if (
            not score
            and self.screen is None
            and self.side is None
            and self.kmer_size <= 32
            and getattr(engine, "supports_seq_batch", lambda: False)()
        ):
            # hottest serving path: ship raw query BYTES; the device
            # runs packing, minimizers, distinct-kmer dedup, grouping
            # and counting in one program (ops/prep_jax.py).  Falls
            # through to the host paths on non-ACGT bytes or when a
            # query overflows the device grouped-entry budget.
            res = self._seq_batch_device(seqs, threshold)
            if res is not None:
                return res
            # mixed-length batch: one genome-scale straggler fails the
            # whole-batch geometry (the B*NK^2 work bound pads every
            # query to the longest) — serve the short majority on the
            # device path and recurse on the stragglers, which as a
            # SMALL batch often pass the geometry on their own
            short = [i for i, s in enumerate(seqs) if len(s) <= 1024]
            if 8 <= len(short) < b:
                long_i = [i for i in range(b) if len(seqs[i]) > 1024]
                sres = self._seq_batch_device(
                    [seqs[i] for i in short], threshold
                )
                if sres is not None:
                    lres = self.search_batch(
                        [seqs[i] for i in long_i], threshold
                    )
                    out = [None] * b
                    for j, i in enumerate(short):
                        out[i] = sres[j]
                    for j, i in enumerate(long_i):
                        out[i] = lres[j]
                    return out
        if self.layout == CLASSIC and self.screen is None:
            res = self._classic_batch_native(seqs, threshold, score)
            if res is not None:
                return res
        # per-query k-mer prep, shared by both dispatch paths; the
        # (uniq, inverse) pairs feed the post-counts scoring pass
        mats, inverses, nks = [], [], []
        with phase("search.kmer_prep"):  # extraction and dedup
            for seq in seqs:
                kmer_mat = seq_to_kmer_matrix(seq, self.kmer_size)
                uniq, inverse = unique_rows_with_inverse(kmer_mat)
                mats.append(uniq)
                inverses.append(inverse if score else None)
                nks.append(uniq.shape[0])
        score_info = list(zip(mats, inverses)) if score else None
        if self.screen is not None and not score:
            metrics.incr("search.queries", b)
            metrics.incr("search.kmers", int(sum(nks)))
            return self._verified_batch(mats, nks, threshold)
        if self.side is None and getattr(
            engine, "supports_kmer_batch", lambda: False
        )():
            # fused serving path: distinct ASCII k-mers straight to the
            # threaded native prep + one device program per chunk — no
            # per-query hashing round-trips on this side
            qstart = np.zeros(b + 1, dtype=np.int64)
            np.cumsum(nks, out=qstart[1:])
            kmer_rows = (
                np.concatenate(mats)
                if qstart[-1]
                else np.empty((0, self.kmer_size), dtype=np.uint8)
            )
            with phase("search.batch_counts"):
                counts = engine.counts_batch_kmers(
                    kmer_rows, qstart, h, self.num_samples
                )
            per_query = [(None, nk) for nk in nks]
            metrics.incr("search.queries", b)
            metrics.incr("search.kmers", int(qstart[-1]))
            return self._batch_results(
                per_query, counts, threshold, score_info
            )
        per_query = []  # (row_idx [K_i, h], num_kmers)
        kmax = 1
        with phase("search.hash"):  # canonical k-mers and rows, per query
            for uniq in mats:
                if uniq.shape[0] == 0:
                    per_query.append((np.empty((0, h), dtype=np.int64), 0))
                    continue
                row_idx = self.kmer_matrix_to_row_idx(uniq)
                per_query.append((row_idx, uniq.shape[0]))
                kmax = max(kmax, uniq.shape[0])
        with phase("search.pad"):
            idx = np.zeros((b, kmax, h), dtype=np.int64)
            mask = np.zeros((b, kmax), dtype=bool)
            for i, (row_idx, nk) in enumerate(per_query):
                idx[i, :nk] = row_idx
                mask[i, :nk] = True
        with phase("search.batch_counts"):
            counts = self._counts_batch(idx, mask)
        metrics.incr("search.queries", b)
        metrics.incr("search.kmers", int(mask.sum()))
        return self._batch_results(
            per_query, self._with_side(counts, per_query), threshold, score_info
        )

    def _with_side(self, counts, per_query):
        """The engine's counts with the staged columns' appended."""
        if self.side is None:
            return counts
        sidec = np.zeros((len(per_query), self.side.num_cols), dtype=counts.dtype)
        for i, (row_idx, nk) in enumerate(per_query):
            if nk:
                sidec[i] = self.side.presence(row_idx).sum(axis=0)
        return np.concatenate([counts, sidec], axis=1)

    def _classic_batch_native(self, seqs, threshold, score):
        """A classic batch in one threaded native pass from its bytes to
        its padded row ids (``native.prep_classic_seqs``: extraction,
        dedup, canonical rows and padding), then the engine's counts.

        Returns the result lists, or None when the batch must take the
        per-query route: scored (scoring wants each query's inverse map),
        k past 32, no native library, or bytes other than ACGT (where
        2-bit codes are not injective) or not ASCII text.  Counters
        ``search.kmer_native_offered`` / ``search.kmer_native_refused``.
        """
        metrics.incr("search.kmer_native_offered")
        prep = None
        with phase("search.kmer_prep"):  # join, encode, ACGT gate, native pass
            if (
                not score
                and self.kmer_size <= 32
                and not os.environ.get("BIGSI_TPU_NO_NATIVE")
                and native.available()
            ):
                flat = self._acgt_bytes(seqs)
                if flat is not None:
                    lens = [len(s) for s in seqs]
                    sstart = np.zeros(len(seqs) + 1, dtype=np.int64)
                    np.cumsum(lens, out=sstart[1:])
                    size = len(seqs) * max(1, max(lens) - self.kmer_size + 1) * self.num_hashes
                    buf = getattr(self._classic_ids, "buf", None)
                    if buf is None or buf.size < size:
                        buf = self._classic_ids.buf = np.empty(size, dtype=np.int32)
                    prep = native.prep_classic_seqs(
                        flat, sstart, self.kmer_size, self.num_hashes,
                        self.bloomfilter_size, out=buf,
                    )
        if prep is None:
            metrics.incr("search.kmer_native_refused")
            return None
        idx, nks = prep
        with phase("search.pad"):
            mask = np.arange(idx.shape[1]) < nks[:, None]
        metrics.incr("search.queries", len(seqs))
        metrics.incr("search.kmers", int(nks.sum()))
        if self._hits_route():
            with phase("search.batch_counts"):
                hits = self.engine.counts_batch(idx, mask, self.bitmatrix.num_cols, threshold, nks)
            return self._batch_results(None, hits, threshold)
        with phase("search.batch_counts"):
            counts = self._counts_batch(idx, mask)
        per_query = [(idx[i, :nk], nk) for i, nk in enumerate(nks.tolist())]
        return self._batch_results(per_query, self._with_side(counts, per_query), threshold)

    def _hits_route(self) -> bool:
        """Whether the classic native route and the seq arm take the
        engine's hits (``counts_batch`` and ``counts_batch_seqs`` given the
        threshold): the engine is the card's, which offers them, and no
        staged column needs the dense counts."""
        return self.side is None and isinstance(self.engine, DeviceEngine)

    @staticmethod
    def _all_acgt(flat: np.ndarray) -> bool:
        """ACGT-only gate for the device seq path.  Four vectorized
        compares measure 7x faster than a LUT fancy-index (0.047 vs
        0.346 ms per 256x542 batch) — this check was 82% of the
        serving pad cost."""
        return bool(
            (
                (flat == ord("A"))
                | (flat == ord("C"))
                | (flat == ord("G"))
                | (flat == ord("T"))
            ).all()
        )

    def _acgt_bytes(self, seqs):
        """The batch's bytes joined as uint8[total], or None unless every
        query is a str of ACGT alone."""
        try:
            flat = np.frombuffer("".join(seqs).encode("ascii"), dtype=np.uint8)
        except (TypeError, UnicodeEncodeError):
            return None  # bytes-like/odd input: host path handles it
        return flat if self._all_acgt(flat) else None

    def _seq_padded(self, seqs):
        """The batch's bytes as (padded uint8[B, L] of ``A``-padded rows,
        lens int32[B]), or None when they cannot take the seq arm."""
        b = len(seqs)
        flat = self._acgt_bytes(seqs)
        if flat is None:
            return None
        # vectorized padding (a per-string Python loop measured 1.3 ms
        # per 256-query batch — comparable to the device step itself)
        lens = np.asarray([len(s) for s in seqs], dtype=np.int32)
        lmax = max(int(lens.max()), self.kmer_size)
        padded = np.full((b, lmax), ord("A"), dtype=np.uint8)
        if (lens == lens[0]).all():
            padded[:, : lens[0]] = flat.reshape(b, lens[0])
        else:
            rows = np.repeat(np.arange(b), lens)
            starts = np.zeros(b, dtype=np.int64)
            np.cumsum(lens[:-1], out=starts[1:])
            cols = np.arange(flat.size, dtype=np.int64) - np.repeat(
                starts, lens
            )
            padded[rows, cols] = flat
        return padded, lens

    def _seq_batch_device(self, seqs, threshold):
        """All-on-device serving path: pad query bytes, one program.

        Returns the result lists, or None when the batch must take the
        host-prep path (non-ACGT bytes — where 2-bit codes are not
        injective and distinct-kmer semantics would drift from the
        reference's raw-string set — or device grouped-entry
        overflow).
        """
        b = len(seqs)
        metrics.incr("search.seq_offered")
        with phase("search.seq_prep"):  # join, encode, ACGT gate, padding
            prep = self._seq_padded(seqs)
        if prep is None:
            metrics.incr("search.seq_gate_refused")
            return None
        padded, lens = prep
        args = (padded, lens, self.kmer_size, self.num_hashes, self.num_samples)
        with phase("search.batch_counts"):
            if self._hits_route():
                out = self.engine.counts_batch_seqs(*args, threshold)
            else:
                out = self.engine.counts_batch_seqs(*args)
        if out is None:
            return None  # grouped-entry overflow: host path re-runs
        if isinstance(out, Hits):
            per_query, counts, n_valid = None, out, out.nks
        else:
            counts, n_valid = out
            per_query = [(None, int(nv)) for nv in n_valid]
        metrics.incr("search.queries", b)
        metrics.incr("search.kmers", int(n_valid.sum()))
        return self._batch_results(per_query, counts, threshold, None)

    # -- two-stage verified search (screened indexes) ------------------

    def _screen_candidates(self, scounts, num_kmers, min_kmers):
        """Colours whose screen count clears the margin-loosened
        threshold (see index/verify.py for the bound)."""
        margin = verify.screen_margin(num_kmers, self.config.get("verify-margin"))
        return np.flatnonzero(
            scounts[: self.bitmatrix.num_cols] >= max(1, min_kmers - margin)
        )

    def _verified_results(
        self, cand, vcounts, c_idx, num_kmers, min_kmers, threshold
    ):
        """Result objects from verified counts + always-verified side
        columns; ordering parity with the classic filters."""
        keep = vcounts >= min_kmers
        results = [
            BigsiQueryResult(
                colour=int(c),
                sample_name=self.colour_to_sample(int(c)),
                num_kmers_found=int(n),
                num_kmers=num_kmers,
            )
            for c, n in zip(cand[keep], vcounts[keep])
        ]
        side_pres = self.side_presence(c_idx)
        if side_pres is not None and side_pres.size:
            base = self.bitmatrix.num_cols
            for j, n in enumerate(side_pres.sum(axis=0)):
                if n >= min_kmers:
                    results.append(
                        BigsiQueryResult(
                            colour=base + j,
                            sample_name=self.colour_to_sample(base + j),
                            num_kmers_found=int(n),
                            num_kmers=num_kmers,
                        )
                    )
        if threshold != 1.0:
            results.sort(key=lambda x: x.num_kmers_found, reverse=True)
        return results

    def _verified_filter(self, uniq, num_kmers, min_kmers, threshold):
        s_idx = self.screen_row_idx(uniq)
        packed = self.screen_engine.and_rows(s_idx)
        scounts = self.screen_engine.counts(packed, self.bitmatrix.num_cols)
        cand = self._screen_candidates(scounts, num_kmers, min_kmers)
        c_idx = self.kmer_matrix_to_row_idx(uniq)  # classic rows
        # a single query stages nothing (bigsi_tpu verifies it on the
        # host); once a batch has staged rows.bin it verifies there too
        verifier = self._verifier
        if verifier is not None:
            vcounts = verifier.counts([c_idx], [cand])[0]
        else:
            vcounts = verify.classic_counts_for_colours(
                self.bitmatrix.words, c_idx, cand
            )
        return self._verified_results(
            cand, vcounts, c_idx, num_kmers, min_kmers, threshold
        )

    def _verified_batch(self, mats, nks, threshold):
        """Batched two-stage search: one screen dispatch (the fused
        k-mer serving path when available), then one verify pass: on the
        device verifier where there is one, else the host pass."""
        b = len(mats)
        h = self.num_hashes
        n_main = self.bitmatrix.num_cols
        engine = self.screen_engine
        if self.side is None and getattr(
            engine, "supports_kmer_batch", lambda: False
        )():
            qstart = np.zeros(b + 1, dtype=np.int64)
            np.cumsum(nks, out=qstart[1:])
            kmer_rows = (
                np.concatenate(mats)
                if qstart[-1]
                else np.empty((0, self.kmer_size), dtype=np.uint8)
            )
            with phase("search.screen_counts"):
                scounts = engine.counts_batch_kmers(
                    kmer_rows, qstart, h, n_main
                )
        else:
            kmax = max(1, max(nks, default=1))
            idx = np.zeros((b, kmax, h), dtype=np.int64)
            mask = np.zeros((b, kmax), dtype=bool)
            for i, uniq in enumerate(mats):
                if nks[i]:
                    idx[i, : nks[i]] = self.screen_row_idx(uniq)
                    mask[i, : nks[i]] = True
            with phase("search.screen_counts"):
                if hasattr(engine, "counts_batch"):
                    scounts = engine.counts_batch(idx, mask, n_main)
                else:
                    scounts = counts_batch_fallback(engine, idx, mask, n_main)
        cands, c_idxs = [], []
        min_kmers_list = []
        with phase("search.candidates"):  # and the classic rows of each
            for i, uniq in enumerate(mats):
                nk = nks[i]
                if nk == 0:
                    cands.append(None)
                    c_idxs.append(None)
                    min_kmers_list.append(0)
                    continue
                min_kmers = math.ceil(nk * threshold)
                min_kmers_list.append(min_kmers)
                cand = self._screen_candidates(scounts[i], nk, min_kmers)
                cands.append(cand)
                # staged columns are verified whatever the candidates
                c_idxs.append(
                    self.kmer_matrix_to_row_idx(uniq)
                    if (cand.size or self.side is not None)
                    else None
                )
        verifier = self.verifier
        with phase("search.verify"):
            if verifier is not None:
                vcounts = verifier.counts(c_idxs, cands)
            else:
                vcounts = verify.verify_queries(self.bitmatrix.words, c_idxs, cands)
        with phase("search.batch_results"):
            out = []
            for i in range(b):
                if nks[i] == 0:
                    out.append([])
                    continue
                results = self._verified_results(
                    cands[i] if cands[i] is not None else np.empty(0, np.int64),
                    vcounts[i], c_idxs[i], nks[i], min_kmers_list[i], threshold,
                )
                out.append(
                    [
                        r.todict()
                        for r in results
                        if not r.sample_name == DELETION_SPECIAL_SAMPLE_NAME
                    ]
                )
            return out

    def _batch_results(self, per_query, counts, threshold, score_info=None):
        """The result lists of a batch from its hits: ``counts`` is the
        engine's :class:`Hits`, or dense counts [B, N] that one host
        threshold turns into them (``dense_hits``, the distinct k-mers
        from ``per_query``: (row ids or None, distinct k-mers) a query,
        which scoring also reads)."""
        # timed beside "search.batch_counts", so one search_batch splits
        # into k-mer prep, engine counts and results; a scored batch's
        # results hold its "search.presence" and "search.score" spans
        with phase("search.batch_results"):
            hits = counts
            if not isinstance(hits, Hits):
                hits = dense_hits(counts, [nk for _, nk in per_query], threshold)
            per = np.diff(hits.off)
            q = np.repeat(np.arange(per.size, dtype=np.int64), per)
            colours, found_kmers = hits.colours, hits.found
            if threshold != 1.0:  # by count, descending; stable: colour order among equal counts
                order = np.argsort((q << 32) - found_kmers, kind="stable")
                colours, found_kmers = colours[order], found_kmers[order]
            # the wire dicts and their colours, query by query, deleted
            # samples left out
            found = [[] for _ in range(per.size)]
            kept = [[] for _ in range(per.size)]
            names, wire = self.colour_to_sample, BigsiQueryResult.wire
            for i, c, n, nk in zip(q.tolist(), colours.tolist(), found_kmers.tolist(),
                                   np.repeat(hits.nks, per).tolist()):
                name = names(c)
                if name != DELETION_SPECIAL_SAMPLE_NAME:
                    found[i].append(wire(name, n, nk))
                    kept[i].append(c)
            hit_queries = [i for i, results in enumerate(found) if results]
            if score_info is not None and hit_queries:
                # scoring pass ONLY over hit queries, all of them in one
                # engine call.  The k-mer path hashed no rows: hash each
                # hit query's k-mers, one call a query (one call over the
                # whole batch measured slower: the hashing's numpy
                # temporaries then outgrow the cache)
                rows = [
                    self.kmer_matrix_to_row_idx(score_info[i][0])
                    if per_query[i][0] is None
                    else per_query[i][0]
                    for i in hit_queries
                ]
                scores = self._score(rows, [score_info[i][1] for i in hit_queries],
                                     [kept[i] for i in hit_queries])
                for i, query_scores in zip(hit_queries, scores):
                    for d, score in zip(found[i], query_scores):
                        d.update(score)
            return found

    def _counts_batch(self, idx, mask):
        engine = self.engine
        n = self.bitmatrix.num_cols  # engines cover MAIN columns only;
        # staged side columns are appended by the caller
        if hasattr(engine, "counts_batch"):
            return engine.counts_batch(idx, mask, n)
        return counts_batch_fallback(engine, idx, mask, n)

    def __exact_filter(self, packed, num_kmers, side_pres=None):
        colours = self.engine.exact_colours(packed)
        colours = [int(c) for c in colours]
        if side_pres is not None and side_pres.size:
            base = self.bitmatrix.num_cols
            colours.extend(
                base + int(c) for c in np.flatnonzero(side_pres.all(axis=0))
            )
        samples = self.get_sample_list(colours)
        return [
            BigsiQueryResult(
                colour=c,
                sample_name=s,
                num_kmers=num_kmers,
                num_kmers_found=num_kmers,
            )
            for c, s in zip(colours, samples)
        ]

    def get_sample_list(self, colours):
        colours_to_samples = self.colours_to_samples(colours)
        return [colours_to_samples[i] for i in colours]

    def __inexact_filter(self, packed, num_kmers, min_kmers, side_pres=None):
        counts = self.engine.counts(packed, self.bitmatrix.num_cols)
        if side_pres is not None:
            counts = np.concatenate(
                [counts, side_pres.sum(axis=0).astype(counts.dtype)]
            )
        keep = np.flatnonzero(counts >= min_kmers)
        results = [
            BigsiQueryResult(
                colour=int(colour),
                sample_name=self.colour_to_sample(int(colour)),
                num_kmers_found=int(counts[colour]),
                num_kmers=num_kmers,
            )
            for colour in keep
        ]
        results.sort(key=lambda x: x.num_kmers_found, reverse=True)
        return results

    def _score(self, row_idx_list, inverse_list, colours_list, packed_list=None,
               side_list=None):
        """-> each query's score dicts, one a colour of ``colours_list``,
        in its order."""
        # Each query's presence strings over ALL its positions (duplicates
        # included: ``inverse``), matching ``bigsi.py:232-239``, which
        # stacks one row per k-mer of the sliding window; then the scorer.
        # A caller that has each query's AND-ed rows and staged presence
        # (a single search) passes them, so neither is gathered again.
        # search.presence times the engine's strings of every main-matrix
        # colour, for all the queries in one call (kernel L's strings form
        # on the card), search.score the staged colours' strings (the side
        # shard, on the host) and the scorer.
        n = self.bitmatrix.num_cols
        engine = self.engine
        with phase("search.presence"):
            colours = [[c for c in cs if c < n] for cs in colours_list]
            if hasattr(engine, "presence_strings"):
                strings = engine.presence_strings(row_idx_list, inverse_list, colours, n)
            else:
                strings = presence_strings_fallback(
                    engine, row_idx_list, inverse_list, colours, n, packed_list
                )
        out = []
        with phase("search.score"):
            for i, (row_idx, inverse, cs, main) in enumerate(
                zip(row_idx_list, inverse_list, colours_list, strings)
            ):
                main, side, scores = iter(main), None, []
                for c in cs:
                    if c < n:
                        col = next(main)
                    else:
                        if side is None:
                            side = (
                                self.side_presence(row_idx)
                                if side_list is None
                                else side_list[i]
                            )
                            side = side[inverse].astype(np.uint8) + np.uint8(0x30)
                        col = side[:, c - n].tobytes().decode("ascii")
                    score_results = self.scorer.score(col)
                    score_results["kmer-presence"] = col
                    scores.append(score_results)
                out.append(scores)
        return out

    # -- mutation -----------------------------------------------------

    def insert(self, bloomfilter, sample):
        logger.warning("Build and merge is preferable to insert in most cases")
        colour = self.add_sample(sample)
        self.insert_bloom(bloomfilter, colour - 1)
        self.storage.sync()

    def delete(self):
        self.storage.delete_all()

    def __validate_merge(self, bigsi):
        assert self.bloomfilter_size == bigsi.bloomfilter_size
        assert self.num_hashes == bigsi.num_hashes
        assert self.kmer_size == bigsi.kmer_size
        assert self.layout == bigsi.layout
        assert self.tile_rows == bigsi.tile_rows
        assert self.minimizer_window == bigsi.minimizer_window
        assert self.slot_scheme == bigsi.slot_scheme

    def merge(self, bigsi):
        self.__validate_merge(bigsi)
        self.merge_indexes(bigsi)
        self.merge_metadata(bigsi)
        self.storage.sync()

    def __validate_search_query(self, seq):
        kmers = set()
        for k in self.seq_to_kmers(seq):
            kmers.add(k)
            if len(kmers) > self.min_unique_kmers_in_query:
                return True
        logger.warning(
            "Query string should contain at least %i unique kmers. "
            "Your query contained %i unique kmers, and as a result the "
            "false discovery rate may be high."
            % (self.min_unique_kmers_in_query, len(kmers))
        )

    def seq_to_kmers(self, seq):
        return seq_to_kmers(seq, self.kmer_size)


def engine_factory_for(config: dict, device=None):
    """The compute engine of ``config["engine"]``: unset is the CUDA
    engine on ``device`` (CUDA unless given), ``"numpy"`` the host
    engine, ``"mesh"`` the sharded mesh engine over ``config["mesh"]``
    (``[d, k, s(, r)]``; its positions on the CUDA devices, or all on
    ``device`` where one is given), ``"distributed"`` the multi-process
    engine over the same mesh across the process group's ranks (raises
    without one); anything else raises."""
    engine = config.get("engine")
    if engine == "numpy":
        return HostEngine
    if engine == "mesh":
        from bigsi_tpu_torch.parallel.sharding import mesh_engine_factory

        return mesh_engine_factory(config.get("mesh"), device)
    if engine == "distributed":
        from bigsi_tpu_torch.parallel.distributed import distributed_engine_factory

        return distributed_engine_factory(config.get("mesh"), device)
    if engine is not None:
        raise ValueError(
            "engine %r is not part of bigsi_tpu_torch: leave 'engine' unset "
            "for the CUDA engine, or set it to 'numpy'" % engine
        )
    return functools.partial(DeviceEngine, device=device)
