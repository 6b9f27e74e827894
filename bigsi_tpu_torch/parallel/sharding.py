"""Sharding of the signature index over a mesh of CUDA devices.

The port of ``bigsi_tpu/parallel/sharding.py``.  Like the JAX module it
is single-controller: one process places every shard and launches every
kernel.  A :class:`Mesh` names the axes of an array of ``torch.device``:

* ``d``: query batch; the queries split across positions;
* ``k``: k-mers; one query's k-mers split, the partial counts are summed
  and the partial exact words ANDed;
* ``s``: samples; the matrix's word axis splits, each position holds a
  column shard, and the per-shard counts concatenate;
* ``r`` (a row mesh ``(d, r, s)``, tile layouts only): the tile axis
  splits into slabs, and the per-slab counts are summed.

A mesh may name one device at several positions (``[torch.device("cuda:0")]
* 8``, or ``["cpu"] * 8`` for the kernels' plain versions): the port's
counterpart of the JAX tests' virtual devices.  Placement keeps one
contiguous tensor per distinct (device, sample shard[, row slab]), so
replicas over ``d`` and ``k`` that land on one device share it, and each
shard is loaded chunk by chunk through the engine's own loaders
(``index/device_engine.py:load_words`` and ``load_cols``, which runs
kernel D), never through a whole copy of the matrix.

Each step is a plain function over the shards that launches its
layout's kernel once per mesh position:

* :func:`make_sharded_query_step`: kernel A (classic and blocked row ids);
* :func:`make_sharded_grouped_step`: kernel C;
* :func:`make_sharded_cols_step`: kernel E;
* :func:`make_sharded_seq_step`: kernel H once per batch shard and
  device, then E once per sample shard;
* :func:`make_rowsharded_grouped_step`: kernel C over each row slab.

The collectives are three functions, :func:`psum`, :func:`gather_samples`
and :func:`and_all`, that bring the per-position tensors to the mesh's
first device.  Slot masks are 64 bits wide throughout
(``index/device_engine.py:tile_streams``), so tile_rows 64 keeps rows
32-63, which the JAX engine's uint32 masks drop.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from bigsi_tpu_torch.hashing.scheme import (
    MINIMIZER_SEED,
    TILE_ROWS,
    default_minimizer_s,
    default_run_len,
    window_to_s,
)
from bigsi_tpu_torch.index.device_engine import (
    TILED_LAYOUTS,
    counts_to_host,
    load_cols,
    load_words,
    resolve_device,
    seq_batch_geometry,
    tile_streams,
)
from bigsi_tpu_torch.ops import lookup as plain
from bigsi_tpu_torch.ops.fused_lookup import (
    classic_counts,
    cols_counts,
    grouped_tile_counts,
    presence_rows,
    seq_streams,
)
from bigsi_tpu_torch.utils.profiling import phase

AXIS_BATCH = "d"
AXIS_KMERS = "k"
AXIS_SAMPLES = "s"
AXIS_ROWS = "r"


class Mesh:
    """Named axes over an object array of ``torch.device``: ``devices``
    has one axis per name, and ``shape[name]`` is that axis's size, as
    ``jax.sharding.Mesh`` gives them."""

    def __init__(self, devices: np.ndarray, axis_names):
        if devices.ndim != len(axis_names):
            raise ValueError("%d axis names for a %d-d device array"
                             % (len(axis_names), devices.ndim))
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def home(self) -> torch.device:
        """The first position's device: where the steps' results land."""
        return self.devices.flat[0]


def device_list(devices=None) -> list:
    """``devices`` resolved (``"cuda"`` to the current CUDA device), or
    every CUDA device when None."""
    if devices is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = []
    for dev in devices:
        dev = resolve_device(dev)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    return out


def device_array(devices: list, shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return arr.reshape(shape)


def factor_devices(n: int) -> tuple[int, int, int]:
    """Factor n devices into (d, k, s) mesh axis sizes.

    Sample sharding gets the largest factor (the matrix is the big
    operand), then batch, then k-mer parallelism.
    """
    best = (1, 1, n)
    # enumerate factorizations d*k*s = n, prefer s >= d >= k
    for d in range(1, n + 1):
        if n % d:
            continue
        rest = n // d
        for k in range(1, rest + 1):
            if rest % k:
                continue
            s = rest // k
            cand = (d, k, s)
            # score: maximize s, then d
            if (s, d, k) > (best[2], best[0], best[1]):
                best = cand
    return best


def _axes(axis_sizes, what: str) -> tuple[int, int, int]:
    sizes = tuple(axis_sizes)
    if len(sizes) != 3 or not all(isinstance(a, int) and a >= 1 for a in sizes):
        raise ValueError("%s axes must be three positive sizes, got %r" % (what, sizes))
    return sizes


def make_mesh(n_devices: int | None = None, axis_sizes=None, devices=None) -> Mesh:
    """A ``(d, k, s)`` mesh over the first d·k·s of ``devices`` (None:
    the CUDA devices); ``axis_sizes`` None factors ``n_devices`` (or all
    of them) with :func:`factor_devices`."""
    devices = device_list(devices)
    n = n_devices or len(devices)
    if axis_sizes is None:
        axis_sizes = factor_devices(n)
    d, k, s = _axes(axis_sizes, "mesh")
    avail = min(n, len(devices))
    if d * k * s > avail:
        raise ValueError(
            "mesh axes %r need %d devices but only %d are available"
            % (tuple(axis_sizes), d * k * s, avail)
        )
    # axes may multiply to FEWER than available: a config pinning a
    # small mesh (e.g. [1, 1, 2] on an 8-device host) uses a device subset
    return Mesh(device_array(devices[: d * k * s], (d, k, s)),
                (AXIS_BATCH, AXIS_KMERS, AXIS_SAMPLES))


def make_row_mesh(axis_sizes, devices=None) -> Mesh:
    """Mesh with axes (d, r, s) for ROW-sharded tile indexes.

    ``r`` shards the tile axis: each position holds a contiguous slab of
    tiles, so indexes larger than one device's memory span devices by
    rows as well as samples.  Only the blocked/minimizer layouts support
    this: they colocate a k-mer's h rows in ONE tile by construction, so
    a k-mer's whole lookup lands on a single row shard and partial
    counts merge with one :func:`psum`.  (Classic spreads a k-mer's rows
    anywhere in [0, m): its scale-out axes remain d/k/s.)
    """
    devices = device_list(devices)
    d, r, s = _axes(axis_sizes, "row mesh")
    if d * r * s > len(devices):
        raise ValueError(
            "mesh axes %r need %d devices but only %d are available"
            % (tuple(axis_sizes), d * r * s, len(devices))
        )
    return Mesh(device_array(devices[: d * r * s], (d, r, s)),
                (AXIS_BATCH, AXIS_ROWS, AXIS_SAMPLES))


def grouped_mesh(mesh: Mesh) -> Mesh:
    """The (d·k, 1, s) mesh of the grouped, cols and seq steps over the
    positions of a (d, k, s) mesh: grouped streams do not split along
    k-mers, so the k axis joins the batch axis."""
    d, k, s = (mesh.shape[a] for a in (AXIS_BATCH, AXIS_KMERS, AXIS_SAMPLES))
    return Mesh(mesh.devices.reshape(d * k, 1, s), (AXIS_BATCH, AXIS_KMERS, AXIS_SAMPLES))


# -- the collectives -------------------------------------------------------


def psum(parts, home) -> torch.Tensor:
    # replaces jax.lax.psum over k (sharding.py:129) and over r (:395)
    total = parts[0].to(home, non_blocking=True)
    for p in parts[1:]:
        total = total + p.to(home, non_blocking=True)
    return total


def gather_samples(parts, home) -> torch.Tensor:
    # replaces jax.lax.all_gather(..., AXIS_SAMPLES, axis=1, tiled=True)
    return torch.cat([p.to(home, non_blocking=True) for p in parts], dim=1)


def and_all(parts, home) -> torch.Tensor:
    # replaces the all_gather of the exact words over k and their AND
    # (sharding.py:136-140): there is no bitwise collective
    out = parts[0].to(home, non_blocking=True)
    for p in parts[1:]:
        out = out & p.to(home, non_blocking=True)
    return out


# -- placement -------------------------------------------------------------


def shard_words(w: int, s: int) -> int:
    """Words per sample shard: W zero-padded to a multiple of s."""
    return -(-w // s)


def _distinct(devices) -> list:
    out = []
    for dev in np.asarray(devices, dtype=object).flat:
        if dev not in out:
            out.append(dev)
    return out


def _column_views(words: np.ndarray, s: int, w_l: int | None = None):
    """-> (W_l, [the words of sample shard j, a view]); the last shards'
    views may be narrower than W_l, or empty.  ``w_l`` None is
    :func:`shard_words` of ``words``' width."""
    w = words.shape[1]
    w_l = w_l or shard_words(w, s)
    return w_l, [words[:, min(w, j * w_l): min(w, (j + 1) * w_l)] for j in range(s)]


def _check_words(words) -> np.ndarray:
    words = np.asarray(words)
    if words.ndim != 2 or words.dtype != np.uint32:
        raise ValueError("words must be uint32 [m, W]")
    return words


def shard_matrix(words: np.ndarray, mesh: Mesh, tile_rows: int | None = None,
                 shard_w: int | None = None) -> dict:
    """Place the packed matrix uint32[m, W] with rows replicated over the
    batch and k-mer axes and the word axis sharded over ``s``: ->
    ``{(device, j): int32[m_pad, W_l]}``, one tensor per distinct device
    of sample shard j, W zero-padded to ``W_l * s`` (and m to whole
    tiles with ``tile_rows``).  ``shard_w`` sets W_l (default
    :func:`shard_words`): a rank's column block of a wider matrix."""
    words = _check_words(words)
    m = words.shape[0]
    m_pad = m if tile_rows is None else -(-m // tile_rows) * tile_rows
    w_l, views = _column_views(words, mesh.shape[AXIS_SAMPLES], shard_w)
    return {
        (dev, j): load_words(view, dev, tile_rows, shape=(m_pad, w_l))
        for j, view in enumerate(views)
        for dev in _distinct(mesh.devices[..., j])
    }


def shard_tiles(tiles: np.ndarray, mesh: Mesh, tile_rows: int = TILE_ROWS) -> dict:
    """Place a tile-major matrix uint32[T, tile_rows * W] (the same bits
    as the row-major words of T * tile_rows rows) with the word axis
    sharded over ``s``: -> ``{(device, j): int32[T * tile_rows, W_l]}``,
    each position's sample-column shard of every tile."""
    tiles = np.asarray(tiles)
    t, fat = tiles.shape
    return shard_matrix(tiles.reshape(t * tile_rows, fat // tile_rows), mesh, tile_rows)


def place_cols(words: np.ndarray, mesh: Mesh, tile_rows: int,
               shard_w: int | None = None) -> dict:
    """The cols layout of the row-major matrix, sample-sharded: ->
    ``{(device, j): [T, W_l * 32]}``, each shard packed by kernel D from
    its column slice of ``words``, chunk by chunk (``load_cols``);
    ``shard_w`` as in :func:`shard_matrix`."""
    words = _check_words(words)
    w_l, views = _column_views(words, mesh.shape[AXIS_SAMPLES], shard_w)
    return {
        (dev, j): load_cols(view, dev, tile_rows, width=w_l)
        for j, view in enumerate(views)
        for dev in _distinct(mesh.devices[..., j])
    }


def place_slabs(words: np.ndarray, mesh: Mesh, tile_rows: int,
                shard_w: int | None = None, slab_rows: int | None = None) -> dict:
    """Row-major words uint32[m, W] on a row mesh (d, r, s): the tile axis
    (m zero-padded to whole tiles, then to a multiple of r tiles) sharded
    over ``r`` and the word axis over ``s``: -> ``{(device, j, q):
    int32[T_l * tile_rows, W_l]}``, slab q holding tiles [q * T_l, (q + 1)
    * T_l).  Phantom tiles are never probed: tile ids stay below T.
    ``shard_w`` as in :func:`shard_matrix`; ``slab_rows`` sets T_l *
    tile_rows (a rank's slabs of a taller matrix)."""
    words = _check_words(words)
    r = mesh.shape[AXIS_ROWS]
    t = -(-words.shape[0] // tile_rows)
    rows = slab_rows or -(-t // r) * tile_rows  # rows of a slab
    w_l, views = _column_views(words, mesh.shape[AXIS_SAMPLES], shard_w)
    return {
        (dev, j, q): load_words(view[q * rows: (q + 1) * rows], dev, tile_rows,
                                shape=(rows, w_l))
        for j, view in enumerate(views)
        for q in range(r)
        for dev in _distinct(mesh.devices[:, q, j])
    }


def shard_tiles_rows(tiles: np.ndarray, mesh: Mesh, tile_rows: int = TILE_ROWS) -> dict:
    """Place a tile-major matrix uint32[T, tile_rows * W] on a row mesh:
    :func:`place_slabs` of the same bits read as row-major words."""
    tiles = np.asarray(tiles)
    t, fat = tiles.shape
    return place_slabs(tiles.reshape(t * tile_rows, fat // tile_rows), mesh, tile_rows)


# -- the steps -------------------------------------------------------------


NUMPY_TYPES = {torch.int32: np.int32, torch.int64: np.int64, torch.bool: np.bool_,
               torch.uint8: np.uint8}


def as_tensor(x, dtype: torch.dtype) -> torch.Tensor:
    """A step's input (numpy, any integer type, or a tensor on any
    device) as a ``dtype`` tensor; uint32 masks keep their value."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).astype(NUMPY_TYPES[dtype])))


def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError("%s %d does not split over %d positions" % (what, n, parts))
    return n // parts


class _Slices:
    """Per-device copies of slices of the step's inputs, made once: ``get(dev,
    key, make)`` returns ``make()`` moved to ``dev`` as a contiguous tensor."""

    def __init__(self):
        self.made = {}

    def get(self, dev, key, make):
        if (dev, key) not in self.made:
            self.made[(dev, key)] = make().contiguous().to(dev, non_blocking=True)
        return self.made[(dev, key)]


def make_sharded_query_step(mesh: Mesh, h: int):
    """The multi-device batched query step over a (d, k, s) mesh.

    step(words, row_idx, mask) with words from :func:`shard_matrix`,
    row_idx int[B, K, h] and mask bool[B, K] (B a multiple of d, K of k;
    numpy or tensors on any device) -> (counts int32[B, W_pad * 32],
    exact int32[B, W_pad]) on the mesh's first device.

    Each position runs kernel A on its query slice [B/d, K/k] and its
    column shard; counts :func:`psum` over k, the exact words
    :func:`and_all` over k (a slice without valid k-mers gives all ones),
    and both :func:`gather_samples` over s.
    """
    d, kk, s = (mesh.shape[a] for a in (AXIS_BATCH, AXIS_KMERS, AXIS_SAMPLES))

    def step(words, row_idx, mask):
        idx = as_tensor(row_idx, torch.int32)
        valid = as_tensor(mask, torch.bool)
        b, k, hh = idx.shape
        if hh != h:
            raise ValueError("the step takes %d rows per k-mer, got %d" % (h, hh))
        bl, kl = _split(b, d, "batch"), _split(k, kk, "k-mers")
        home, inputs = mesh.home, _Slices()
        counts, exact = [], []
        for a in range(d):
            cs, es = [], []
            for c in range(s):
                pc, pe = [], []
                for q in range(kk):
                    dev = mesh.devices[a, q, c]
                    sl = (slice(a * bl, (a + 1) * bl), slice(q * kl, (q + 1) * kl))
                    out = classic_counts(words[(dev, c)],
                                         inputs.get(dev, ("idx", a, q), lambda: idx[sl]),
                                         inputs.get(dev, ("mask", a, q), lambda: valid[sl]))
                    pc.append(out[0])
                    pe.append(out[1])
                cs.append(psum(pc, home))
                es.append(and_all(pe, home))
            counts.append(gather_samples(cs, home))
            exact.append(gather_samples(es, home))
        return torch.cat(counts), torch.cat(exact)

    return step


def _need_flat_k(mesh: Mesh, what: str) -> None:
    if mesh.shape[AXIS_KMERS] != 1:
        raise ValueError("%s step requires a (d, 1, s) mesh" % what)


def make_sharded_grouped_step(mesh: Mesh, tile_rows: int = TILE_ROWS):
    """Multi-device grouped (minimizer tile-dedup) batched counts.

    step(tiles, utile, gmask) with tiles from :func:`shard_tiles` (or
    :func:`shard_matrix` with ``tile_rows``), utile int[B, U] and gmask
    [B, U, R] (64-bit masks; B a multiple of d) -> (counts int32[B,
    W_pad * 32], exact int32[B, W_pad]) on the mesh's first device.
    Each position runs kernel C on its batch slice and column shard; the
    results :func:`gather_samples` over s.  Build meshes as (d, 1, s)
    (:func:`grouped_mesh`): grouped streams do not split along k-mers.
    """
    _need_flat_k(mesh, "grouped")
    return _streams_step(mesh, lambda tiles, dev, c, ut, gm, nv: grouped_tile_counts(
        tiles[(dev, c)], ut, gm, tile_rows))


def make_sharded_cols_step(mesh: Mesh):
    """Multi-device column-major (cols) minimizer counts.

    step(cols, utile, gmask, n_valid) with cols from :func:`place_cols`,
    utile int[B, U], gmask [B, U, R] and n_valid
    int[B] (B a multiple of d) -> (counts int32[B, W_pad * 32], exact
    int32[B, W_pad]) on the mesh's first device.  Each position runs
    kernel E against its own sample columns; samples partition cleanly,
    so the shards' results only :func:`gather_samples` over s.
    """
    _need_flat_k(mesh, "cols")
    return _streams_step(mesh, lambda cols, dev, c, ut, gm, nv: cols_counts(
        cols[(dev, c)], ut, gm, nv))


def _streams_step(mesh: Mesh, count):
    """A step over grouped streams on a (d, 1, s) mesh: ``count(shards,
    dev, c, utile, gmask, n_valid)`` runs one position's kernel (n_valid
    None for the grouped step)."""
    d, s = mesh.shape[AXIS_BATCH], mesh.shape[AXIS_SAMPLES]

    def step(shards, utile, gmask, n_valid=None):
        ut = as_tensor(utile, torch.int32)
        gm = as_tensor(gmask, torch.int64)
        nv = None if n_valid is None else as_tensor(n_valid, torch.int32)
        bl = _split(ut.shape[0], d, "batch")
        home, inputs = mesh.home, _Slices()
        counts, exact = [], []
        for a in range(d):
            rows = slice(a * bl, (a + 1) * bl)
            cs, es = [], []
            for c in range(s):
                dev = mesh.devices[a, 0, c]
                nv_dev = None if nv is None else inputs.get(dev, ("n_valid", a),
                                                            lambda: nv[rows])
                out = count(shards, dev, c,
                            inputs.get(dev, ("utile", a), lambda: ut[rows]),
                            inputs.get(dev, ("gmask", a), lambda: gm[rows]), nv_dev)
                cs.append(out[0])
                es.append(out[1])
            counts.append(gather_samples(cs, home))
            exact.append(gather_samples(es, home))
        return torch.cat(counts), torch.cat(exact)

    return step


def make_sharded_seq_step(
    mesh: Mesh, *, k: int, s: int, num_tiles: int, h: int,
    tile_rows: int, r: int, u_cap: int, seed: int = MINIMIZER_SEED,
):
    """Multi-device serving from raw query bytes to counts.

    step(cols, seqs, lens) with cols from :func:`place_cols`, seqs uint8[B, L] and lens int[B] (B a multiple
    of d) -> (counts int32[B, W_pad * 32], n_valid int32[B], ok bool[d])
    on the mesh's first device.  Kernel H builds each batch shard's
    grouped streams once per distinct device of its positions, kernel E
    counts them on each sample shard, and the counts
    :func:`gather_samples` over s.  ``ok`` holds one flag per batch
    shard: all() it before using any count; False is an entry-budget
    overflow, and the batch must take a host path.
    """
    _need_flat_k(mesh, "seq")
    d, s_axis = mesh.shape[AXIS_BATCH], mesh.shape[AXIS_SAMPLES]
    prep = dict(k=k, s=s, num_tiles=num_tiles, h=h, tile_rows=tile_rows, r=r,
                u_cap=u_cap, seed=seed)

    def step(cols, seqs, lens):
        sq = as_tensor(seqs, torch.uint8)
        ln = as_tensor(lens, torch.int32)
        bl = _split(sq.shape[0], d, "batch")
        home = mesh.home
        counts, n_valid, oks = [], [], []
        for a in range(d):
            rows = slice(a * bl, (a + 1) * bl)
            streams, cs = {}, []
            for c in range(s_axis):
                dev = mesh.devices[a, 0, c]
                if dev not in streams:
                    streams[dev] = seq_streams(sq[rows].contiguous().to(dev, non_blocking=True),
                                               ln[rows].contiguous().to(dev, non_blocking=True),
                                               **prep)
                ut, gm, nv, _ = streams[dev]
                cs.append(cols_counts(cols[(dev, c)], ut, gm, nv)[0])
            counts.append(gather_samples(cs, home))
            first = next(iter(streams.values()))
            n_valid.append(first[2].to(home, non_blocking=True))
            oks.append(and_all([st[3] for st in streams.values()], home))
        return torch.cat(counts), torch.cat(n_valid), torch.stack(oks)

    return step


def make_rowsharded_grouped_step(mesh: Mesh, tile_rows: int = TILE_ROWS):
    """Grouped batched counts over a ROW-sharded tile matrix.

    step(slabs, utile, gmask) with slabs from :func:`shard_tiles_rows`
    (or :func:`place_slabs`), utile int[B, U] and gmask [B, U, R] (B a
    multiple of d) -> (counts int32[B, W_pad * 32], exact int32[B,
    W_pad]) on the mesh's first device.

    Each position keeps only the entries whose tile falls in its slab:
    the others point at tile 0 with every slot mask zeroed, and kernel C
    skips a slot whose mask is 0 (kernel E would count it and subtract it
    back through n_valid, so the row-sharded step stays on C).  The
    per-slab counts :func:`psum` over r and the exact words
    :func:`and_all` over r, then both :func:`gather_samples` over s.
    """
    d, nr, s = (mesh.shape[a] for a in (AXIS_BATCH, AXIS_ROWS, AXIS_SAMPLES))

    def step(slabs, utile, gmask):
        ut = as_tensor(utile, torch.int32)
        gm = as_tensor(gmask, torch.int64)
        bl = _split(ut.shape[0], d, "batch")
        home, inputs = mesh.home, _Slices()
        counts, exact = [], []
        for a in range(d):
            rows = slice(a * bl, (a + 1) * bl)
            cs, es = [], []
            for c in range(s):
                pc, pe = [], []
                for q in range(nr):
                    dev = mesh.devices[a, q, c]
                    slab = slabs[(dev, c, q)]
                    t_loc = slab.shape[0] // tile_rows
                    local = inputs.get(dev, ("utile", a), lambda: ut[rows]) - q * t_loc
                    in_slab = (local >= 0) & (local < t_loc)
                    masks = inputs.get(dev, ("gmask", a), lambda: gm[rows])
                    out = grouped_tile_counts(
                        slab, torch.where(in_slab, local, 0).contiguous(),
                        torch.where(in_slab[..., None], masks, 0).contiguous(), tile_rows)
                    pc.append(out[0])
                    pe.append(out[1])
                cs.append(psum(pc, home))
                es.append(and_all(pe, home))
            counts.append(gather_samples(cs, home))
            exact.append(gather_samples(es, home))
        return torch.cat(counts), torch.cat(exact)

    return step


# -- the engine ------------------------------------------------------------


class MeshEngine:
    """Engine with the surface of the port's ``DeviceEngine`` (numpy in,
    numpy out), over a mesh.

    It holds only what its layout's steps read: classic and blocked the
    sample-sharded row-major words (the query step, kernel A, on row
    ids); minimizer with tile_rows up to 32 and no row shards the
    sample-sharded cols (kernel D at load; the cols step, kernel E, and
    the seq step, kernels H and E); other minimizer indexes the
    row-major tiles, on the (d·k, 1, s) mesh (the grouped step, kernel
    C) or, with ``row_shards`` > 1, in slabs on the (d·k, r, s) row mesh
    (the row-sharded step).  ``devices`` is the pool the engine's meshes
    are drawn from where it makes one (no ``mesh``, or row shards); None
    means the CUDA devices.  Single queries are a batch of one through
    the same step; scoring's presence rows are kernel L per shard.
    """

    def __init__(
        self, matrix, mesh: Mesh | None = None, layout: str = "classic",
        tile_rows: int = TILE_ROWS, row_shards: int = 1,
        minimizer_window: int | None = None, run_len: int | None = None,
        slot_scheme: int = 1, devices=None,
    ):
        if layout != "classic" and layout not in TILED_LAYOUTS:
            raise ValueError("unknown layout %r" % layout)
        if row_shards > 1 and layout not in TILED_LAYOUTS:
            raise ValueError(
                "row sharding needs a tile layout (blocked/minimizer): "
                "classic spreads a k-mer's rows over the whole index"
            )
        self.matrix = matrix
        self.mesh = mesh or make_mesh(devices=devices)
        self.layout = layout
        self.tile_rows = tile_rows
        if run_len is None and layout == "minimizer":
            run_len = default_run_len(minimizer_window)
        self.run_len = run_len
        self.row_shards = row_shards
        self.minimizer_window = minimizer_window
        self.slot_scheme = slot_scheme
        rows = matrix.num_rows
        if layout in TILED_LAYOUTS:
            rows = -(-rows // tile_rows) * tile_rows
        if rows >= 1 << 31:
            raise ValueError("row ids are int32: at most 2**31 - 1 rows")
        words = np.asarray(matrix.words)
        self.words = self.cols = self.tiles = None
        if layout != "minimizer":
            self.step_mesh = self.mesh
            self.words = shard_matrix(words, self.mesh)
            return
        flat = grouped_mesh(self.mesh)
        if row_shards > 1:
            d, _, s = flat.devices.shape
            self.step_mesh = make_row_mesh((d, row_shards, s), devices=devices)
            self.tiles = place_slabs(words, self.step_mesh, tile_rows)
        elif plain.cols_dtype(tile_rows) is not None:
            self.step_mesh = flat
            self.cols = place_cols(words, flat, tile_rows)
        else:
            self.step_mesh = flat
            self.tiles = shard_matrix(words, flat, tile_rows)

    def _check_rows(self, row_idx: np.ndarray) -> None:
        # an id past the matrix would read out of bounds on the card
        if row_idx.size and (row_idx.min() < 0 or row_idx.max() >= self.matrix.num_rows):
            raise IndexError("row ids must lie in [0, %d)" % self.matrix.num_rows)

    def _reduce(self, row_idx: np.ndarray, mask: np.ndarray):
        """row ids int[B, K, h], bool[B, K] -> (counts int32[B', W_pad *
        32], exact int32[B', W_pad]) on the mesh's first device, B' >= B
        (the batch padded to the step mesh's batch axis), through the
        layout's step."""
        self._check_rows(row_idx)
        mesh, home = self.step_mesh, self.step_mesh.home
        b, k, h = row_idx.shape
        db = mesh.shape[AXIS_BATCH]
        bb = -(-b // db) * db
        dk = 1 if self.layout == "minimizer" else mesh.shape[AXIS_KMERS]
        kk = -(-k // dk) * dk
        idx = torch.zeros((bb, kk, h), dtype=torch.int32)
        valid = torch.zeros((bb, kk), dtype=torch.bool)
        idx[:b, :k] = torch.from_numpy(np.ascontiguousarray(row_idx, dtype=np.int32))
        valid[:b, :k] = torch.from_numpy(np.ascontiguousarray(mask, dtype=bool))
        idx, valid = idx.to(home), valid.to(home)
        if self.layout != "minimizer":
            return make_sharded_query_step(mesh, h)(self.words, idx, valid)
        tile, smask = tile_streams(idx, valid, self.tile_rows)
        utile, gmask = plain.build_grouped_streams(tile, smask, self.run_len or plain.GROUP_R)
        if self.cols is not None:
            return make_sharded_cols_step(mesh)(self.cols, utile, gmask,
                                                valid.sum(dim=1, dtype=torch.int32))
        if self.row_shards > 1:
            return make_rowsharded_grouped_step(mesh, self.tile_rows)(self.tiles, utile, gmask)
        return make_sharded_grouped_step(mesh, self.tile_rows)(self.tiles, utile, gmask)

    # -- the seq serving arm over the mesh (minimizer cols, slot scheme 3)

    def supports_seq_batch(self) -> bool:
        """True when ``counts_batch_seqs`` serves: the cols layout, slot
        scheme 3, power-of-two tile_rows and fewer than 2^28 tiles (the
        JAX mesh engine's conditions)."""
        num_tiles = max(1, self.matrix.num_rows // self.tile_rows)
        return (
            self.cols is not None
            and self.slot_scheme == 3
            and self.tile_rows & (self.tile_rows - 1) == 0
            and num_tiles < (1 << 28)
        )

    def counts_batch_seqs(
        self, seqs: np.ndarray, lens: np.ndarray, k: int, h: int, num_cols: int
    ):
        """Padded ASCII query bytes to per-query hit counts over the mesh
        (:func:`make_sharded_seq_step`): the contract of
        ``DeviceEngine.counts_batch_seqs`` at the JAX mesh engine's one
        (safe) entry budget; None when the geometry guard refuses the
        batch or any batch shard overflows (the caller falls back to the
        host paths)."""
        b = seqs.shape[0]
        if b == 0:
            return np.zeros((0, num_cols), dtype=np.int64), np.zeros(0, dtype=np.int32)
        s_mer = window_to_s(k, self.minimizer_window) or default_minimizer_s(k)
        mesh = self.step_mesh
        geom = seq_batch_geometry(seqs, lens, k, k - s_mer + 1, db=mesh.shape[AXIS_BATCH])
        if geom is None:
            return None
        padded, lens_b, _, u_cap = geom
        step = make_sharded_seq_step(
            mesh, k=k, s=s_mer, num_tiles=max(1, self.matrix.num_rows // self.tile_rows), h=h,
            tile_rows=self.tile_rows, r=self.run_len or plain.GROUP_R, u_cap=u_cap,
        )
        with phase("engine.seq_in"):
            pd = torch.from_numpy(padded).to(mesh.home)
            ld = torch.from_numpy(lens_b).to(mesh.home)
        with phase("engine.seq_kernels"):  # kernels H and E, then the ok read
            counts, n_valid, ok = step(self.cols, pd, ld)
            fits = bool(ok.all())
        if not fits:
            return None
        with phase("engine.seq_out"):
            return counts_to_host(counts[:b, :num_cols]), n_valid[:b].cpu().numpy()

    # -- batched search

    def query_batch(self, row_idx_list):
        """List of int [K_i, h] -> (counts int64 [B, W_pad * 32], exact
        uint32 [B, W_pad])."""
        b = len(row_idx_list)
        h = row_idx_list[0].shape[1]
        kmax = max(r.shape[0] for r in row_idx_list)
        idx = np.zeros((b, kmax, h), dtype=np.int32)
        mask = np.zeros((b, kmax), dtype=bool)
        for i, r in enumerate(row_idx_list):
            idx[i, : r.shape[0]] = r
            mask[i, : r.shape[0]] = True
        counts, exact = self._reduce(idx, mask)
        return (counts[:b].cpu().numpy().astype(np.int64),
                exact[:b].cpu().numpy().view(np.uint32))

    def counts_batch(
        self, row_idx: np.ndarray, mask: np.ndarray, num_cols: int
    ) -> np.ndarray:
        """row ids int[B, K, h] (padding k-mers hold any in-range id),
        mask bool[B, K] -> int64[B, num_cols], one step over the mesh."""
        b, k = mask.shape
        if b == 0 or k == 0:
            return np.zeros((b, num_cols), dtype=np.int64)
        counts, _ = self._reduce(row_idx, mask)
        return counts_to_host(counts[:b, :num_cols])

    # -- the single-query surface: `packed` is an opaque handle the facade
    #    passes back; the empty query stays a numpy array

    def and_rows(self, row_idx: np.ndarray):
        if row_idx.shape[0] == 0:
            return np.empty((0, self.matrix.num_words), dtype=np.uint32)
        return _MeshQuery(self, np.asarray(row_idx))

    def exact_colours(self, packed) -> np.ndarray:
        if isinstance(packed, np.ndarray):
            return np.empty(0, dtype=np.int64)
        _, exact = packed.result()
        bits = np.unpackbits(exact[0].view(np.uint8), bitorder="little")
        return np.flatnonzero(bits[: self.matrix.num_cols]).astype(np.int64)

    def counts(self, packed, num_cols: int) -> np.ndarray:
        if isinstance(packed, np.ndarray):
            return np.zeros(num_cols, dtype=np.int64)
        counts, _ = packed.result()
        return counts[0, :num_cols]

    def presence_matrix(self, packed, num_cols: int) -> np.ndarray:
        """Scoring's per-k-mer presence [K, num_cols]: kernel L
        (``presence_rows``) once per sample shard, at the first position
        holding it (once per row slab of it with row shards), the shards
        concatenated."""
        if isinstance(packed, np.ndarray):
            return np.empty((0, num_cols), dtype=np.uint8)
        self._check_rows(packed.row_idx)
        mesh = self.step_mesh
        parts = []
        for c in range(mesh.shape[AXIS_SAMPLES]):
            dev = mesh.devices[0, 0, c]
            idx = torch.from_numpy(np.ascontiguousarray(packed.row_idx, dtype=np.int32)).to(dev)
            if self.words is not None:
                parts.append(presence_rows(self.words[(dev, c)], "classic", idx))
                continue
            tile, smask = tile_streams(idx, torch.ones(idx.shape[0], dtype=torch.bool,
                                                       device=dev), self.tile_rows)
            if self.cols is not None:
                parts.append(presence_rows(self.cols[(dev, c)], "cols", tile, smask))
            else:
                parts.append(self._slab_presence(c, tile, smask))
        rows = gather_samples(parts, mesh.home).cpu().numpy().view(np.uint32)
        bits = np.unpackbits(rows.view(np.uint8), axis=-1, bitorder="little")
        return bits[:, :num_cols]

    def _slab_presence(self, c: int, tile: torch.Tensor, smask: torch.Tensor) -> torch.Tensor:
        """Presence rows from sample shard c's tiles: one launch over its
        tiles, or one per row slab with the slab's tile window (a k-mer's
        tile lies in one slab, the others give 0), ORed."""
        mesh = self.step_mesh
        if self.row_shards == 1:
            return presence_rows(self.tiles[(mesh.devices[0, 0, c], c)], "slot", tile, smask,
                                 self.tile_rows)
        out = None
        for q in range(self.row_shards):
            dev = mesh.devices[0, q, c]
            slab = self.tiles[(dev, c, q)]
            t_loc = slab.shape[0] // self.tile_rows
            part = presence_rows(slab, "slot", tile.to(dev), smask.to(dev), self.tile_rows,
                                 window=(q * t_loc, (q + 1) * t_loc)).to(tile.device)
            out = part if out is None else out | part
        return out


class _MeshQuery:
    """One query's row ids; the engine reduces them on first use."""

    def __init__(self, engine: MeshEngine, row_idx: np.ndarray):
        self.engine = engine
        self.row_idx = row_idx
        self._result = None

    def result(self):
        if self._result is None:
            self._result = self.engine.query_batch([self.row_idx])
        return self._result


def mesh_engine_factory(axes=None, device=None):
    """The engine factory of ``engine: mesh``: ``axes`` is the config's
    ``mesh: [d, k, s(, r)]`` (None: every device on the sample axis),
    ``r`` the row shards.  ``device`` None draws the positions from the
    CUDA devices (too few raise); a given device (``"cpu"``, ``"cuda:0"``)
    holds every position."""
    axes = tuple(axes or ())
    row_shards = axes[3] if len(axes) > 3 else 1
    devices = None
    if device is not None:
        devices = [resolve_device(device)] * (math.prod(axes) if axes else 1)
    mesh = make_mesh(axis_sizes=axes[:3] or None, devices=devices)
    return functools.partial(MeshEngine, mesh=mesh, row_shards=row_shards, devices=devices)
