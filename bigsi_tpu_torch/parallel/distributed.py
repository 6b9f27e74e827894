"""Multi-process serving on ``torch.distributed``: rank 0 answers, every
rank counts its own shards.

The port of ``bigsi_tpu/parallel/distributed.py``.  The index is split
over the ranks of a gloo process group (:func:`initialize`): each rank
drives one device (``cuda:{rank % device_count}`` unless a device is
given, ``"cpu"`` in the tests; ranks may share a card) and holds only its
own shards of the matrix, read from strided views of the ``rows.bin``
mmap, chunk by chunk.  A global mesh (:class:`GlobalMesh`) is the mesh
engine's :class:`~bigsi_tpu_torch.parallel.sharding.Mesh` with the rank
owning each position beside it; a rank's positions form a sub-block, an
ordinary mesh on its device, and each op runs the mesh engine's step on
it unchanged:

* ``query``: the sharded query step (kernel A);
* ``query_grouped``: the grouped step (kernel C), or with ``row_shards``
  > 1 the row-sharded step (C over slabs);
* ``query_seqs``: the seq step (kernel H, then E; D packs the cols at
  the first such dispatch);
* ``presence``: plain ``and_rows`` per shard (the scored path).

One transport carries a dispatch: rank 0 broadcasts a fixed int64 header
(op, k, h, and each array's dtype code and shape) and then one uint8
buffer of the arrays the header lays out; every rank runs its part and
rank 0 gathers one packed int32 tensor per rank, a status word first, and
joins the parts along the axes the ranks split (``gather_samples`` over
``s``, rows over ``d``, ``psum`` and ``and_all`` over ``k``, ``psum`` over
``r``).  A rank whose part raises still reaches the gather, with its
status set, and rank 0 raises after it, so no rank is left in a
collective.  Nothing that crosses a process is pickled.  The other
ranks loop in :meth:`DistributedQueryService.run_worker_loop` until
``stop``.
"""

from __future__ import annotations

import functools
import logging
import math
import os
import threading

import numpy as np
import torch
import torch.distributed as dist

from bigsi_tpu_torch.hashing.scheme import (
    MINIMIZER_SEED,
    TILE_ROWS,
    default_minimizer_s,
    default_run_len,
    window_to_s,
)
from bigsi_tpu_torch.index.device_engine import (
    TILED_LAYOUTS,
    DeviceEngine,
    resolve_device,
    seq_batch_geometry,
    tile_streams,
)
from bigsi_tpu_torch.ops import lookup as plain
from bigsi_tpu_torch.parallel.sharding import (
    AXIS_BATCH,
    AXIS_KMERS,
    AXIS_ROWS,
    AXIS_SAMPLES,
    Mesh,
    and_all,
    device_array,
    factor_devices,
    gather_samples,
    grouped_mesh,
    make_rowsharded_grouped_step,
    make_sharded_grouped_step,
    make_sharded_query_step,
    make_sharded_seq_step,
    place_cols,
    place_slabs,
    psum,
    shard_matrix,
    shard_words,
)

logger = logging.getLogger(__name__)

OP_STOP = 0
OP_QUERY = 1
OP_PRESENCE = 2
OP_GROUPED = 3
OP_SEQS = 4  # raw query bytes; kernel H preps them on every rank

# the header's whitelist of array types, by code
DTYPES = (np.dtype(np.int32), np.dtype(np.uint8), np.dtype(np.int64), np.dtype(np.bool_))
MAX_ARRAYS = 2
HEADER_WORDS = 16  # op, k, h, n arrays, then (dtype code, ndim, 3 dims) per array
CPU = torch.device("cpu")


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the gloo process group of the serving fleet (a no-op when
    this process has joined it already).

    Env fall-backs: ``BIGSI_TPU_COORDINATOR`` (``host:port`` of rank 0's
    store), ``BIGSI_TPU_NUM_PROCESSES``, ``BIGSI_TPU_PROCESS_ID``.
    """
    if dist.is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get("BIGSI_TPU_COORDINATOR")
    if num_processes is None and os.environ.get("BIGSI_TPU_NUM_PROCESSES"):
        num_processes = int(os.environ["BIGSI_TPU_NUM_PROCESSES"])
    if process_id is None and os.environ.get("BIGSI_TPU_PROCESS_ID"):
        process_id = int(os.environ["BIGSI_TPU_PROCESS_ID"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize needs the coordinator address, the number of processes and "
            "this process's id (or BIGSI_TPU_COORDINATOR, BIGSI_TPU_NUM_PROCESSES "
            "and BIGSI_TPU_PROCESS_ID)"
        )
    dist.init_process_group(
        "gloo", init_method="tcp://" + coordinator_address,
        world_size=num_processes, rank=process_id,
    )
    logger.info("distributed: rank %d of %d", process_id, num_processes)


def _process_group() -> tuple[int, int]:
    """-> (this process's rank, the world size) of the process group."""
    if not dist.is_initialized():
        raise ValueError(
            "no process group: call bigsi_tpu_torch.parallel.distributed.initialize() "
            "first (serve --distributed does)"
        )
    return dist.get_rank(), dist.get_world_size()


def rank_device(rank: int, device=None) -> torch.device:
    """The device rank ``rank`` drives: ``device`` where given (``"cuda"``
    without an index: the rank's card), else ``cuda:{rank %
    device_count}``; without CUDA and without a device this raises
    (``resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


# -- the global mesh ------------------------------------------------------


class GlobalMesh:
    """A mesh over every rank's positions: ``mesh`` (each position holding
    its owner's device) and ``owners`` (each position's rank, the same
    shape).  Each rank's positions must form a sub-block of one shape,
    which :meth:`local` gives as an ordinary mesh."""

    def __init__(self, mesh: Mesh, owners: np.ndarray, world: int):
        if owners.shape != mesh.devices.shape:
            raise ValueError("owners %s do not match the mesh %s"
                             % (owners.shape, mesh.devices.shape))
        self.mesh = mesh
        self.owners = owners
        self.world = world
        self.boxes = [self._box(r) for r in range(world)]
        shapes = {tuple(b - a for a, b in box) for box in self.boxes}
        if len(shapes) != 1:
            raise ValueError("the ranks' blocks of the mesh differ in shape: %s" % sorted(shapes))

    @property
    def shape(self) -> dict:
        return self.mesh.shape

    @property
    def axis_names(self) -> tuple:
        return self.mesh.axis_names

    def _box(self, rank: int):
        where = np.argwhere(self.owners == rank)
        if not len(where):
            raise ValueError("rank %d owns no position of the mesh" % rank)
        box = tuple((int(lo), int(hi) + 1) for lo, hi in zip(where.min(0), where.max(0)))
        if math.prod(b - a for a, b in box) != len(where):
            raise ValueError("rank %d's positions %s are not a sub-block of the mesh"
                             % (rank, where.tolist()))
        return box

    def box(self, rank: int, axis: str) -> tuple[int, int]:
        """Rank ``rank``'s [start, stop) of the mesh's ``axis``."""
        return self.boxes[rank][self.axis_names.index(axis)]

    def local(self, rank: int) -> Mesh:
        block = tuple(slice(a, b) for a, b in self.boxes[rank])
        return Mesh(self.mesh.devices[block], self.axis_names)


def _global_mesh(axes, order, names, world: int, device) -> GlobalMesh:
    """The positions of a mesh of ``axes`` (sizes named ``names``), laid
    out as JAX lays the process-ordered devices: ``order`` is the axes'
    order over the rank-ordered positions, outermost first.  The
    positions are split evenly over the ranks (a mesh must span every
    rank, or its shards would concentrate on a few)."""
    need = math.prod(axes)
    if need % world != 0:
        raise ValueError(
            "mesh needs %d positions but %d ranks cannot split them "
            "evenly (%d %% %d != 0); pick axis sizes whose product is a "
            "multiple of the number of ranks" % (need, world, need, world)
        )
    sizes = [axes[names.index(a)] for a in order]
    owners = np.repeat(np.arange(world), need // world).reshape(sizes)
    owners = owners.transpose([order.index(a) for a in names])
    devices = device_array([rank_device(int(r), device) for r in owners.flat], owners.shape)
    return GlobalMesh(Mesh(devices, names), owners, world)


def make_global_mesh(axis_sizes=None, *, world: int | None = None, device=None) -> GlobalMesh:
    """A (d, k, s) mesh over every rank's positions, ``s`` outermost: the
    ranks split the sample axis first (each rank's device holds a column
    block of the matrix), then the batch, then the k-mers.  ``axis_sizes``
    None factors the world (one position a rank, all on ``s``)."""
    world = world or _process_group()[1]
    d, k, s = axis_sizes or factor_devices(world)
    return _global_mesh((d, k, s), (AXIS_SAMPLES, AXIS_BATCH, AXIS_KMERS),
                        (AXIS_BATCH, AXIS_KMERS, AXIS_SAMPLES), world, device)


def make_global_row_mesh(axis_sizes, *, world: int | None = None, device=None) -> GlobalMesh:
    """A (d, r, s) mesh for row-sharded tile indexes, ``r`` outermost:
    each rank holds a contiguous slab of tiles (times its sample
    columns), so indexes larger than one card split across ranks by rows
    as well as samples."""
    world = world or _process_group()[1]
    return _global_mesh(tuple(axis_sizes), (AXIS_ROWS, AXIS_SAMPLES, AXIS_BATCH),
                        (AXIS_BATCH, AXIS_ROWS, AXIS_SAMPLES), world, device)


def flat_mesh(gmesh: GlobalMesh) -> GlobalMesh:
    """The (d·k, 1, s) mesh of the grouped and seq steps over the same
    positions (``grouped_mesh``)."""
    d, k, s = (gmesh.shape[a] for a in (AXIS_BATCH, AXIS_KMERS, AXIS_SAMPLES))
    return GlobalMesh(grouped_mesh(gmesh.mesh), gmesh.owners.reshape(d * k, 1, s), gmesh.world)


# -- placement, per rank --------------------------------------------------


def _local_word_slice(words, mesh: GlobalMesh, rank: int):
    """-> (the columns of ``words`` that rank ``rank``'s sample shards
    hold, a view; W_l): the view is narrower than its shards where they
    pass the true width, and the placement pads it."""
    w = words.shape[1]
    w_l = shard_words(w, mesh.shape[AXIS_SAMPLES])
    s0, s1 = mesh.box(rank, AXIS_SAMPLES)
    return words[:, min(w, s0 * w_l): min(w, s1 * w_l)], w_l


def distribute_words(words, mesh: GlobalMesh, *, rank: int, tile_rows: int | None = None) -> dict:
    """Rank ``rank``'s column shards of the packed matrix (uint32[m, W],
    typically the ``rows.bin`` mmap) on its sub-mesh: -> ``{(device, j):
    int32[m_pad, W_l]}``, j its local sample shard, m padded to whole
    tiles with ``tile_rows``.  Only this rank's columns are read, chunk
    by chunk: neither the padded full matrix nor a host copy of the
    rank's column block is ever made."""
    view, w_l = _local_word_slice(words, mesh, rank)
    return shard_matrix(view, mesh.local(rank), tile_rows, shard_w=w_l)


# -- the wire format ------------------------------------------------------


def _header(op: int, arrays, k: int = 0, h: int = 0) -> np.ndarray:
    if len(arrays) > MAX_ARRAYS:
        raise ValueError("a dispatch carries at most %d arrays" % MAX_ARRAYS)
    hdr = np.zeros(HEADER_WORDS, dtype=np.int64)
    hdr[:4] = op, k, h, len(arrays)
    for i, a in enumerate(arrays):
        if a.dtype not in DTYPES or a.ndim > 3:
            raise ValueError("cannot send a %d-d %s array" % (a.ndim, a.dtype))
        hdr[4 + 5 * i: 6 + 5 * i] = DTYPES.index(a.dtype), a.ndim
        hdr[6 + 5 * i: 6 + 5 * i + a.ndim] = a.shape
    return hdr


def _specs(hdr: np.ndarray):
    """-> (op, k, h, [(shape, dtype), ...]) of a header."""
    op, k, h, n = (int(x) for x in hdr[:4])
    specs = []
    for i in range(n):
        code, ndim = int(hdr[4 + 5 * i]), int(hdr[5 + 5 * i])
        specs.append((tuple(int(x) for x in hdr[6 + 5 * i: 6 + 5 * i + ndim]), DTYPES[code]))
    return op, k, h, specs


def _nbytes(shape, dtype) -> int:
    """An array's bytes in the buffer, rounded up to 8 so every array
    starts aligned."""
    return -(-math.prod(shape) * np.dtype(dtype).itemsize // 8) * 8


def _split_buffer(buf: np.ndarray, specs):
    """Slice one uint8 buffer back into arrays of ``specs`` [(shape,
    dtype), ...] (views)."""
    outs, off = [], 0
    for shape, dtype in specs:
        n = math.prod(shape) * np.dtype(dtype).itemsize
        outs.append(buf[off: off + n].view(dtype).reshape(shape))
        off += _nbytes(shape, dtype)
    return outs


def _pack(arrays) -> np.ndarray:
    buf = np.zeros(sum(_nbytes(a.shape, a.dtype) for a in arrays), dtype=np.uint8)
    off = 0
    for a in arrays:
        raw = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        buf[off: off + raw.size] = raw
        off += _nbytes(a.shape, a.dtype)
    return buf


# -- the service ----------------------------------------------------------


class DistributedQueryService:
    """Rank 0's dispatch and every rank's part of the sharded steps.

    Every rank constructs it identically (the matrix source, the mesh,
    the layout); rank 0 then calls :meth:`query`, :meth:`query_grouped`,
    :meth:`query_seqs` and :meth:`presence`, the other ranks
    :meth:`run_worker_loop`.  ``words`` is the matrix on every rank
    (typically the ``rows.bin`` mmap, of which each rank reads only its
    shards); ``device`` places a row mesh's positions as ``mesh``'s, as
    in :func:`rank_device`.  The rank and the world are the process
    group's.  Placements are made at the first dispatch that needs them.
    """

    def __init__(self, words, mesh: GlobalMesh, *, m: int, layout: str = "classic",
                 tile_rows: int = TILE_ROWS,
                 run_len: int | None = None, row_shards: int = 1,
                 minimizer_window: int | None = None, slot_scheme: int = 1, device=None):
        if words is None:
            raise ValueError(
                "DistributedQueryService needs the matrix source on every rank "
                "(typically the rows.bin mmap, of which each rank reads only its "
                "own shards); workers cannot pass None"
            )
        self.rank, self.world = _process_group()
        if mesh.world != self.world:
            raise ValueError("a mesh of %d ranks in a world of %d" % (mesh.world, self.world))
        self.mesh = mesh
        self.flat = flat_mesh(mesh)
        d, k, s = (mesh.shape[a] for a in (AXIS_BATCH, AXIS_KMERS, AXIS_SAMPLES))
        self.rows_mesh = (make_global_row_mesh((d * k, row_shards, s), world=self.world,
                                               device=device) if row_shards > 1 else None)
        self.m = m
        self.layout = layout
        self.tile_rows = tile_rows
        self.run_len = run_len
        self.row_shards = row_shards
        self.minimizer_window = minimizer_window
        self.slot_scheme = slot_scheme
        self._words_src = words
        self.w_l = shard_words(words.shape[1], s)
        self._placed = {}
        self._stopped = False
        self._lock = threading.Lock()  # HTTP serving is threaded: one dispatch at a time

    # -- placement

    def _placement(self, name: str) -> dict:
        if name not in self._placed:
            self._placed[name] = self._place(name)
        return self._placed[name]

    def _place(self, name: str) -> dict:
        src, tr = self._words_src, self.tile_rows
        if name == "words":  # padded to whole tiles: the grouped step's tiles too
            return distribute_words(src, self.mesh, rank=self.rank, tile_rows=tr)
        if name == "cols":
            view, w_l = _local_word_slice(src, self.flat, self.rank)
            return place_cols(view, self.flat.local(self.rank), tr, shard_w=w_l)
        view, w_l = _local_word_slice(src, self.rows_mesh, self.rank)
        tiles = -(-self.m // tr)
        slab_rows = -(-tiles // self.row_shards) * tr
        q0, q1 = self.rows_mesh.box(self.rank, AXIS_ROWS)
        return place_slabs(view[q0 * slab_rows: q1 * slab_rows], self.rows_mesh.local(self.rank),
                           tr, shard_w=w_l, slab_rows=slab_rows)

    # -- one dispatch, on every rank

    def _grouped_mesh(self) -> GlobalMesh:
        return self.rows_mesh if self.row_shards > 1 else self.flat

    def _presence_mesh(self) -> GlobalMesh:
        return self.rows_mesh if self.row_shards > 1 else self.mesh

    def _rows(self, mesh: GlobalMesh, b: int) -> slice:
        """This rank's rows of a batch of ``b`` split over ``mesh``'s d."""
        d0, d1 = mesh.box(self.rank, AXIS_BATCH)
        bl = b // mesh.shape[AXIS_BATCH]
        return slice(d0 * bl, d1 * bl)

    def _part_shape(self, op: int, b: int) -> tuple[int, int]:
        """The shape of this rank's part of a dispatch of ``b`` queries (or
        k-mers, for presence), from the header alone: a rank that fails
        sends zeros of this shape."""
        if op == OP_QUERY:
            mesh, width = self.mesh, 33
        elif op == OP_GROUPED:
            mesh, width = self._grouped_mesh(), 32
        elif op == OP_SEQS:
            mesh, width = self.flat, 32
        else:  # presence: every k-mer, this rank's words
            s0, s1 = self._presence_mesh().box(self.rank, AXIS_SAMPLES)
            return b, self.w_l * (s1 - s0)
        s0, s1 = mesh.box(self.rank, AXIS_SAMPLES)
        rows = self._rows(mesh, b)
        extra = 2 if op == OP_SEQS else 0
        return rows.stop - rows.start, width * self.w_l * (s1 - s0) + extra

    def _part(self, op: int, arrays, k: int, h: int) -> torch.Tensor:
        """This rank's part of a dispatch, int32 on the CPU."""
        if op == OP_QUERY:
            idx, mask = arrays
            rows = self._rows(self.mesh, idx.shape[0])
            k0, k1 = self.mesh.box(self.rank, AXIS_KMERS)
            kl = idx.shape[1] // self.mesh.shape[AXIS_KMERS]
            kmers = slice(k0 * kl, k1 * kl)
            counts, exact = make_sharded_query_step(self.mesh.local(self.rank), h)(
                self._placement("words"), idx[rows, kmers], mask[rows, kmers])
            return torch.cat([counts, exact], dim=1).cpu()
        if op == OP_GROUPED:
            utile, gmask = arrays
            mesh = self._grouped_mesh()
            rows = self._rows(mesh, utile.shape[0])
            if self.row_shards == 1:
                step = make_sharded_grouped_step(mesh.local(self.rank), self.tile_rows)
                counts, _ = step(self._placement("words"), utile[rows], gmask[rows])
            else:
                slabs = self._placement("slabs")
                slab_tiles = next(iter(slabs.values())).shape[0] // self.tile_rows
                q0, _ = mesh.box(self.rank, AXIS_ROWS)
                step = make_rowsharded_grouped_step(mesh.local(self.rank), self.tile_rows)
                counts, _ = step(slabs, utile[rows] - q0 * slab_tiles, gmask[rows])
            return counts.cpu()
        if op == OP_SEQS:
            seqs, lens = arrays
            rows = self._rows(self.flat, seqs.shape[0])
            s_mer = window_to_s(k, self.minimizer_window) or default_minimizer_s(k)
            window = k - s_mer + 1
            step = make_sharded_seq_step(
                self.flat.local(self.rank), k=k, s=s_mer,
                num_tiles=max(1, self.m // self.tile_rows), h=h, tile_rows=self.tile_rows,
                r=self.run_len or plain.GROUP_R,
                u_cap=DeviceEngine._seq_u_cap(seqs.shape[1] - k + 1, window), seed=MINIMIZER_SEED,
            )
            counts, n_valid, ok = step(self._placement("cols"), seqs[rows], lens[rows])
            flags = torch.full((counts.shape[0], 1), int(bool(ok.all())), dtype=torch.int32)
            return torch.cat([counts.cpu(), n_valid.cpu()[:, None], flags], dim=1)
        (idx,) = arrays
        return self._presence_part(torch.from_numpy(np.ascontiguousarray(idx)))

    def _presence_part(self, idx: torch.Tensor) -> torch.Tensor:
        """Each k-mer's AND of its h rows over this rank's sample shards
        (plain PyTorch); on row slabs a k-mer's rows (one tile) lie in one
        slab, and the other slabs give zero."""
        if self.row_shards == 1:
            sub = self.mesh.local(self.rank)
            words = self._placement("words")
            parts = [plain.and_rows(words[(sub.devices[0, 0, c], c)], idx.to(sub.devices[0, 0, c]))
                     for c in range(sub.shape[AXIS_SAMPLES])]
            return gather_samples(parts, sub.home).cpu()
        sub = self.rows_mesh.local(self.rank)
        slabs = self._placement("slabs")
        q0, _ = self.rows_mesh.box(self.rank, AXIS_ROWS)
        parts = []
        for c in range(sub.shape[AXIS_SAMPLES]):
            out = None
            for q in range(sub.shape[AXIS_ROWS]):
                dev = sub.devices[0, q, c]
                slab = slabs[(dev, c, q)]
                local = idx.to(dev).long() - (q0 + q) * slab.shape[0]
                here = ((local[:, 0] >= 0) & (local[:, 0] < slab.shape[0]))[:, None]
                rows = plain.and_rows(slab, local.clamp(0, slab.shape[0] - 1))
                out = torch.where(here, rows, 0 if out is None else out)
            parts.append(out)
        # joined on the device, then one blocking copy: a non-blocking copy
        # to the host may still be in flight when the host reads it
        return gather_samples(parts, sub.home).cpu()

    def _execute(self, op: int, arrays, k: int, h: int):
        """Runs this rank's part and gathers the parts at rank 0: -> every
        rank's part (int32, a status word first) on rank 0, None
        elsewhere.  A part that raises is logged and sent as zeros with
        its status set; rank 0 raises once the gather is done."""
        shape = self._part_shape(op, arrays[0].shape[0])
        packed = torch.zeros(1 + math.prod(shape), dtype=torch.int32)
        error = None
        try:
            packed[1:] = self._part(op, arrays, k, h).reshape(-1)
        except Exception as e:  # noqa: BLE001 -- every rank must reach the gather
            logger.exception("rank %d: part of op %d failed", self.rank, op)
            packed.zero_()
            packed[0] = 1
            error = e
        if self.world == 1:
            parts = [packed]
        else:
            parts = ([torch.empty_like(packed) for _ in range(self.world)]
                     if self.rank == 0 else None)
            dist.gather(packed, parts, dst=0)
        if self.rank != 0:
            return None
        failed = [r for r, p in enumerate(parts) if int(p[0])]
        if failed:
            raise RuntimeError("rank(s) %s failed their part of op %d (see their logs)"
                               % (failed, op)) from error
        return [p[1:].reshape(shape) for p in parts]

    # -- rank 0

    def _dispatch(self, op: int, arrays, k: int = 0, h: int = 0):
        if self.rank != 0:
            raise RuntimeError("only rank 0 dispatches; the other ranks run run_worker_loop")
        hdr = _header(op, arrays, k, h)
        with self._lock:
            if self._stopped:
                raise RuntimeError("the service has been stopped")
            if self.world > 1:
                dist.broadcast(torch.from_numpy(hdr), src=0)
                if arrays:
                    dist.broadcast(torch.from_numpy(_pack(arrays)), src=0)
            return self._execute(op, arrays, k, h)

    def _cells(self, mesh: GlobalMesh, parts):
        """The parts by the rows and samples they cover: [[the parts over
        the other axis (k or r) for each s block] for each d block], both
        in order."""
        cells = {}
        for r in range(self.world):
            d0, s0 = mesh.box(r, AXIS_BATCH)[0], mesh.box(r, AXIS_SAMPLES)[0]
            cells.setdefault(d0, {}).setdefault(s0, []).append(parts[r])
        return [[cells[d0][s0] for s0 in sorted(cells[d0])] for d0 in sorted(cells)]

    def _pad_batch(self, b: int, mult: int) -> int:
        return max(mult, -(-b // mult) * mult)

    def query(self, idx: np.ndarray, mask: np.ndarray):
        """Classic counts and exact words of a batch: row ids int[B, K, h],
        mask bool[B, K] -> (counts int64[B, W_pad * 32], exact uint32[B,
        W_pad]); the batch is padded to the mesh's d, the k-mers to its k."""
        b, k, h = idx.shape
        bb = self._pad_batch(b, self.mesh.shape[AXIS_BATCH])
        kk = self._pad_batch(k, self.mesh.shape[AXIS_KMERS])
        pidx = np.zeros((bb, kk, h), dtype=np.int32)
        pmask = np.zeros((bb, kk), dtype=bool)
        pidx[:b, :k] = idx
        pmask[:b, :k] = mask
        parts = self._dispatch(OP_QUERY, [pidx, pmask], h=h)
        split = parts[0].shape[1] * 32 // 33
        cells = self._cells(self.mesh, parts)
        counts = torch.cat([gather_samples([psum([p[:, :split] for p in ks], CPU) for ks in row],
                                           CPU) for row in cells])
        exact = torch.cat([gather_samples([and_all([p[:, split:] for p in ks], CPU) for ks in row],
                                          CPU) for row in cells])
        return counts[:b].numpy().astype(np.int64), exact[:b].numpy().view(np.uint32)

    def query_grouped(self, utile: np.ndarray, gmask: np.ndarray) -> np.ndarray:
        """Grouped (minimizer tile-dedup) counts: utile int32[B, U], gmask
        int64[B, U, R] (64-bit slot masks) -> counts int64[B, W_pad * 32];
        the batch is padded to the step mesh's d (d·k)."""
        b = utile.shape[0]
        mesh = self._grouped_mesh()
        bb = self._pad_batch(b, mesh.shape[AXIS_BATCH])
        pu = np.zeros((bb,) + utile.shape[1:], dtype=np.int32)
        pg = np.zeros((bb,) + gmask.shape[1:], dtype=np.int64)
        pu[:b] = utile
        pg[:b] = gmask
        parts = self._dispatch(OP_GROUPED, [pu, pg])
        cells = self._cells(mesh, parts)
        counts = torch.cat([gather_samples([psum(rs, CPU) for rs in row], CPU) for row in cells])
        return counts[:b].numpy().astype(np.int64)

    def supports_seq_batch(self) -> bool:
        """The seq op's conditions: the minimizer layout at slot scheme 3,
        one row shard, a power-of-two tile height with a cols type and
        fewer than 2^28 tiles."""
        num_tiles = max(1, self.m // self.tile_rows)
        return (
            self.layout == "minimizer"
            and self.slot_scheme == 3
            and self.row_shards == 1
            and self.tile_rows & (self.tile_rows - 1) == 0
            and plain.cols_dtype(self.tile_rows) is not None
            and num_tiles < (1 << 28)
        )

    def query_seqs(self, seqs: np.ndarray, lens: np.ndarray, k: int, h: int):
        """Padded query bytes uint8[B, L] and lens int[B] -> (counts
        int64[B, W_pad * 32], n_valid int32[B]), or None when any rank's
        batch shard overflows its entry budget (every rank stays in step;
        the caller takes a host path).  The batch is padded to d·k."""
        b, length = seqs.shape
        bb = self._pad_batch(b, self.flat.shape[AXIS_BATCH])
        pq = np.full((bb, length), ord("A"), dtype=np.uint8)
        pl = np.zeros(bb, dtype=np.int32)
        pq[:b] = seqs
        pl[:b] = lens
        parts = self._dispatch(OP_SEQS, [pq, pl], k=k, h=h)
        if not all(bool((p[:, -1] == 1).all()) for p in parts):
            return None
        cells = self._cells(self.flat, parts)
        counts = torch.cat([gather_samples([ps[0][:, :-2] for ps in row], CPU) for row in cells])
        n_valid = torch.cat([row[0][0][:, -2] for row in cells])
        return counts[:b].numpy().astype(np.int64), n_valid[:b].numpy()

    def presence(self, idx: np.ndarray) -> np.ndarray:
        """Per-k-mer presence rows (the scored path): row ids int[K, h] ->
        uint32[K, W_pad].  On row slabs each k-mer's h rows must lie in
        one tile, as the tiled layouts place them."""
        tr = self.tile_rows
        if self.row_shards > 1 and idx.size and (idx // tr != idx[:, :1] // tr).any():
            raise ValueError("on row slabs a k-mer's rows must lie in one tile")
        parts = self._dispatch(OP_PRESENCE, [np.ascontiguousarray(idx, dtype=np.int32)])
        mesh = self._presence_mesh()
        by_s = {}
        for r in range(self.world):  # replicas over d and k: the first of each; slabs: summed
            s0 = mesh.box(r, AXIS_SAMPLES)[0]
            q0 = mesh.box(r, AXIS_ROWS)[0] if self.row_shards > 1 else 0
            by_s.setdefault(s0, {}).setdefault(q0, parts[r])
        rows = gather_samples([psum([qs[q] for q in sorted(qs)], CPU)
                               for _, qs in sorted(by_s.items())], CPU)
        return rows.numpy().view(np.uint32)

    def stop(self) -> None:
        """Rank 0: send the other ranks out of their loops; returns at
        once.  A no-op on the other ranks and after the first call."""
        if self.rank != 0:
            return
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            if self.world > 1:
                dist.broadcast(torch.from_numpy(_header(OP_STOP, [])), src=0)

    # -- the other ranks

    def run_worker_loop(self) -> None:
        """Ranks > 0: receive each dispatch from rank 0, run this rank's
        part and send it back, until OP_STOP."""
        if self.rank == 0:
            raise RuntimeError("rank 0 dispatches; only the other ranks run the worker loop")
        while True:
            hdr = torch.zeros(HEADER_WORDS, dtype=torch.int64)
            dist.broadcast(hdr, src=0)
            op, k, h, specs = _specs(hdr.numpy())
            if op == OP_STOP:
                return
            arrays = []
            if specs:
                buf = torch.empty(sum(_nbytes(*sp) for sp in specs), dtype=torch.uint8)
                dist.broadcast(buf, src=0)
                arrays = _split_buffer(buf.numpy(), specs)
            self._execute(op, arrays, k, h)


# -- the engine -----------------------------------------------------------


class DistributedEngine:
    """Engine with the surface of the port's ``DeviceEngine`` (numpy in,
    numpy out) over the fleet's :class:`DistributedQueryService`: the
    ``engine: distributed`` of ``serve --distributed``.

    Every rank constructs it when it opens the index (no collective: the
    placements come at the first dispatch).  Rank 0 serves; the other
    ranks call :meth:`run_worker_loop`.  Classic batches go to the query
    step, blocked and minimizer batches to the grouped step (64-bit slot
    masks, so tile_rows 64 keeps rows 32-63), ACGT batches of a
    minimizer index at slot scheme 3 to the seq step.  No
    ``counts_batch_kmers``, as in JAX.
    """

    def __init__(self, matrix, axis_sizes=None, layout: str = "classic",
                 tile_rows: int = TILE_ROWS, minimizer_window: int | None = None,
                 row_shards: int = 1, run_len: int | None = None, slot_scheme: int = 1,
                 device=None):
        if layout != "classic" and layout not in TILED_LAYOUTS:
            raise ValueError("unknown layout %r" % layout)
        if row_shards > 1 and layout not in TILED_LAYOUTS:
            raise ValueError(
                "row sharding needs a tile layout (blocked/minimizer): "
                "classic spreads a k-mer's rows over the whole index"
            )
        if -(-matrix.num_rows // tile_rows) * tile_rows >= 1 << 31:
            raise ValueError("row ids are int32: at most 2**31 - 1 rows")
        words = np.asarray(matrix.words)  # a mmap passes through uncopied
        self.matrix = matrix
        self.num_cols = matrix.num_cols
        self.layout = layout
        self.tile_rows = tile_rows
        if run_len is None and layout == "minimizer":
            run_len = default_run_len(minimizer_window)
        self.service = DistributedQueryService(
            words, make_global_mesh(axis_sizes, device=device), m=words.shape[0],
            layout=layout, tile_rows=tile_rows, run_len=run_len,
            row_shards=row_shards, minimizer_window=minimizer_window, slot_scheme=slot_scheme,
            device=device,
        )

    # -- serving lifecycle

    def run_worker_loop(self) -> None:
        self.service.run_worker_loop()

    def stop(self) -> None:
        self.service.stop()

    # -- batched search

    def _check_rows(self, row_idx: np.ndarray) -> None:
        # an id past the matrix would read out of bounds on the card
        if row_idx.size and (row_idx.min() < 0 or row_idx.max() >= self.matrix.num_rows):
            raise IndexError("row ids must lie in [0, %d)" % self.matrix.num_rows)

    def counts_batch(self, row_idx: np.ndarray, mask: np.ndarray, num_cols: int) -> np.ndarray:
        """row ids int[B, K, h], mask bool[B, K] -> int64[B, num_cols]."""
        b, k = mask.shape
        if b == 0 or k == 0:
            return np.zeros((b, num_cols), dtype=np.int64)
        self._check_rows(row_idx)
        if self.layout in TILED_LAYOUTS:
            tile, smask = tile_streams(torch.from_numpy(np.ascontiguousarray(row_idx)),
                                       torch.from_numpy(np.ascontiguousarray(mask, dtype=bool)),
                                       self.tile_rows)
            utile, gmask = plain.build_grouped_streams(tile, smask,
                                                       self.service.run_len or plain.GROUP_R)
            counts = self.service.query_grouped(utile.numpy(), gmask.numpy())
        else:
            counts, _ = self.service.query(row_idx, mask)
        return counts[:, :num_cols]

    def supports_seq_batch(self) -> bool:
        return self.service.supports_seq_batch()

    def counts_batch_seqs(self, seqs: np.ndarray, lens: np.ndarray, k: int, h: int,
                          num_cols: int):
        """Padded query bytes to counts over the fleet (the seq op), with
        the single-device engine's contract: None sends the batch to a
        host path (the geometry guard refused it, or a batch shard
        overflowed)."""
        b = seqs.shape[0]
        if b == 0:
            return np.zeros((0, num_cols), dtype=np.int64), np.zeros(0, dtype=np.int32)
        s_mer = window_to_s(k, self.service.minimizer_window) or default_minimizer_s(k)
        geom = seq_batch_geometry(seqs, lens, k, k - s_mer + 1,
                                  db=self.service.flat.shape[AXIS_BATCH])
        if geom is None:
            return None
        padded, lens_b, _, _ = geom
        out = self.service.query_seqs(padded, lens_b, k, h)
        if out is None:
            return None
        counts, n_valid = out
        return counts[:b, :num_cols], n_valid[:b]

    # -- the single-query surface: `packed` is an opaque handle the facade
    #    passes back; the empty query stays a numpy array

    def and_rows(self, row_idx: np.ndarray):
        if row_idx.shape[0] == 0:
            return np.empty((0, self.matrix.num_words), dtype=np.uint32)
        self._check_rows(row_idx)
        return _DistributedQuery(self, np.asarray(row_idx))

    def exact_colours(self, packed) -> np.ndarray:
        if isinstance(packed, np.ndarray):
            return np.empty(0, dtype=np.int64)
        _, exact = packed.result()
        bits = np.unpackbits(exact[0].view(np.uint8), bitorder="little")
        return np.flatnonzero(bits[: self.num_cols]).astype(np.int64)

    def counts(self, packed, num_cols: int) -> np.ndarray:
        if isinstance(packed, np.ndarray):
            return np.zeros(num_cols, dtype=np.int64)
        counts, _ = packed.result()
        return counts[0, :num_cols]

    def presence_matrix(self, packed, num_cols: int) -> np.ndarray:
        if isinstance(packed, np.ndarray):
            return np.empty((0, num_cols), dtype=np.uint8)
        rows = self.service.presence(packed.row_idx)
        bits = np.unpackbits(rows.view(np.uint8), axis=-1, bitorder="little")
        return bits[:, :num_cols]


class _DistributedQuery:
    """One query's row ids; the fleet reduces them on first use."""

    def __init__(self, engine: DistributedEngine, row_idx: np.ndarray):
        self.engine = engine
        self.row_idx = row_idx
        self._result = None

    def result(self):
        if self._result is None:
            idx = np.asarray(self.row_idx, dtype=np.int32)[None]
            self._result = self.engine.service.query(idx, np.ones(idx.shape[:2], dtype=bool))
        return self._result


def distributed_engine_factory(axes=None, device=None):
    """The engine factory of ``engine: distributed``: ``axes`` is the
    config's ``mesh: [d, k, s(, r)]`` (None: one position a rank, on
    ``s``), ``r`` the row shards; ``device`` as in :func:`rank_device`.
    Raises without a process group: the engine never serves
    single-process in silence."""
    if not dist.is_initialized():
        raise ValueError(
            "engine 'distributed' needs the fleet's process group: call "
            "bigsi_tpu_torch.parallel.distributed.initialize() first (serve "
            "--distributed does), or use engine 'mesh' in one process"
        )
    axes = tuple(axes or ())
    row_shards = axes[3] if len(axes) > 3 else 1
    return functools.partial(DistributedEngine, axis_sizes=axes[:3] or None,
                             row_shards=row_shards, device=device)
