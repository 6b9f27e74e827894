"""The flagship one-program query steps, as one function with example inputs.

The counterpart of ``__graft_entry__.py:entry``: :func:`entry` returns
``(fn, example_args)``, where ``fn(words, kmers, mask, cols, seqs, lens)``
runs both serving steps of the port on the example's tensors and returns
``(classic_counts, seq_counts, ok)``:

(a) classic: raw ASCII k-mers through ``ops/lookup.py:make_full_query_step``
    (kernel I's canonical k-mers, murmur3 and rows, then kernel A's
    gather, AND and counts);
(b) the seq serving step: raw ACGT query bytes through kernel H
    (``fused_lookup.seq_streams``: 2-bit codes, minimizer tiles, the
    distinct-k-mer dedup and runs) into kernel E (``fused_lookup.cols_counts``).

The example inputs come from ``np.random.default_rng(0)`` in the JAX
entry's order, so both give the same arrays; the JAX uint16 cols are the
port's int16 cols holding the same bits.  ``device=None`` means CUDA;
``device="cpu"`` runs the plain versions.

:func:`dryrun_multichip` is the counterpart of
``__graft_entry__.py:dryrun_multichip``: each step of
:mod:`bigsi_tpu_torch.parallel.sharding` once on an n-position mesh,
value-checked against the host oracle and the single-device kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from bigsi_tpu_torch.hashing.scheme import MINIMIZER_SEED, TILE_ROWS
from bigsi_tpu_torch.index.device_engine import resolve_device
from bigsi_tpu_torch.index.host_engine import HostEngine, counts_batch_fallback
from bigsi_tpu_torch.matrix.bitmatrix import BitSliceMatrix
from bigsi_tpu_torch.ops.fused_lookup import cols_counts, pack_tile_cols, seq_streams
from bigsi_tpu_torch.ops.lookup import build_grouped_streams, make_full_query_step
from bigsi_tpu_torch.parallel import sharding as sh

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _tiny_problem(rng, m=512, n_samples=1000, B=8, K=64, h=3):
    """A random matrix of ``n_samples`` blooms of density 0.3, row ids and
    a mask, drawn in the JAX entry's order."""
    blooms = [rng.random(m) < 0.3 for _ in range(n_samples)]
    matrix = BitSliceMatrix.create(blooms, m, n_samples)
    row_idx = rng.integers(0, m, size=(B, K, h)).astype(np.int32)
    mask = rng.random((B, K)) < 0.9
    return matrix, row_idx, mask


def entry(device=None):
    """-> (fn, example_args): the classic step from k-mers and the seq
    step from query bytes, on ``device`` (None: CUDA)."""
    dev = resolve_device(device)
    m, h, klen = 512, 3, 31
    B, K = 8, 64
    tile_rows, window = 16, 19
    num_tiles = m // tile_rows
    classic_step = make_full_query_step(m, h)

    def full_query_step(words, kmers, mask, cols, seqs, lens):
        classic = classic_step(words, kmers, mask)
        utile, gmask, n_valid, ok = seq_streams(
            seqs, lens, k=klen, s=klen - window + 1, num_tiles=num_tiles, h=h,
            tile_rows=tile_rows, r=window + 1, u_cap=16,
        )
        seq_counts, _ = cols_counts(cols, utile, gmask, n_valid)
        return classic, seq_counts, ok

    rng = np.random.default_rng(0)
    matrix, _, mask = _tiny_problem(rng, m=m, B=B, K=K, h=h)
    kmers = rng.choice(ACGT, size=(B, K, klen))
    L = 64 + klen - 1
    seqs = rng.choice(ACGT, size=(B, L))
    lens = np.full(B, L, dtype=np.int32)
    cols = rng.integers(0, 1 << 16, size=(num_tiles, 128), dtype=np.uint16)
    example_args = tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in (matrix.words.view(np.int32), kmers, mask, cols.view(np.int16), seqs, lens)
    )
    return full_query_step, example_args


def grouped_oracle(tiles2d, ut, gm, tile_rows):
    """Grouped-stream counts by numpy loops: tiles uint32[T, tile_rows *
    W], utile [B, U], gmask [B, U, R] -> int64[B, W * 32]."""
    t3 = tiles2d.reshape(tiles2d.shape[0], tile_rows, -1)
    w = t3.shape[2]
    out = np.zeros((ut.shape[0], w * 32), dtype=np.int64)
    for i in range(ut.shape[0]):
        for e in range(ut.shape[1]):
            g = t3[ut[i, e]]
            for j in range(gm.shape[2]):
                sm = int(gm[i, e, j])
                if sm == 0:
                    continue
                acc = np.full(w, 0xFFFFFFFF, dtype=np.uint32)
                for bit in range(tile_rows):
                    if (sm >> bit) & 1:
                        acc &= g[bit]
                out[i] += np.unpackbits(acc.view(np.uint8), bitorder="little")
    return out


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError("dryrun_multichip: " + what)


def dryrun_multichip(n_devices: int, device=None, devices=None) -> dict:
    """Each sharded step once on an ``n_devices``-position mesh, inputs
    drawn from ``np.random.default_rng(0)`` in the JAX dry run's order:
    the query step (counts and exact) on a balanced (d, k, s) mesh, the
    grouped, cols and seq steps on (d·k, 1, s) and the row-sharded step
    on (d', r, s), each value-checked against the host oracle (counts and
    exact), the numpy grouped oracle (grouped, cols, row-sharded) or the
    single-device kernels H and E (seq).  ``devices`` lists the
    positions' devices; unset, every position sits on
    ``resolve_device(device)`` (None: CUDA).  -> {"inputs": ..., "outputs":
    ...}, numpy arrays, so a test can hold them to the JAX steps."""
    if devices is None:
        devices = [resolve_device(device)] * n_devices
    # a balanced factorization, so the dry run exercises all three axes
    # (batch x k-mers x samples) whenever n allows
    d, k, s = 1, 1, n_devices
    if n_devices % 2 == 0:
        d, rest = 2, n_devices // 2
        k = 2 if rest % 2 == 0 else 1
        s = rest // k
    mesh = sh.make_mesh(n_devices, (d, k, s), devices=devices)
    home = mesh.home
    rng = np.random.default_rng(0)
    B, K = 2 * d, 64 * k  # divisible by the mesh axes
    matrix, row_idx, mask = _tiny_problem(rng, m=512, n_samples=128 * 32 * s, B=B, K=K)
    counts, exact = sh.make_sharded_query_step(mesh, h=3)(
        sh.shard_matrix(matrix.words, mesh), row_idx, mask)
    w_pad = sh.shard_words(matrix.num_words, s) * s
    _check(tuple(counts.shape) == (B, w_pad * 32) and tuple(exact.shape) == (B, w_pad),
           "query step shapes %s %s" % (tuple(counts.shape), tuple(exact.shape)))
    counts, exact = counts.cpu().numpy(), exact.cpu().numpy().view(np.uint32)
    host = HostEngine(matrix)
    n_cols = matrix.num_cols
    _check(np.array_equal(counts[:, :n_cols].astype(np.int64),
                          counts_batch_fallback(host, row_idx, mask, n_cols)),
           "sharded counts != host oracle")
    for i in range(B):
        rows = host.and_rows(row_idx[i][mask[i]])
        if rows.size:
            _check(np.array_equal(exact[i, : matrix.num_words],
                                  np.bitwise_and.reduce(rows, axis=0)),
                   "sharded exact != host oracle at query %d" % i)

    # grouped streams (the minimizer layout's) on a (d * k, 1, s) mesh
    mesh_g = sh.make_mesh(n_devices, (d * k, 1, s), devices=devices)
    T = 16
    tiles = rng.integers(0, 2 ** 32, size=(T, TILE_ROWS * 4 * s), dtype=np.uint32)
    tile = rng.integers(0, T, size=(B, K)).astype(np.int32)
    tile[:, 1::2] = tile[:, 0::2]  # minimizer-style runs
    smask = rng.integers(1, 2 ** 32, size=(B, K), dtype=np.uint64).astype(np.uint32)
    utile, gmask = build_grouped_streams(torch.from_numpy(tile),
                                         torch.from_numpy(smask.astype(np.int64)))
    utile, gmask = utile.numpy(), gmask.numpy()
    gcounts = sh.make_sharded_grouped_step(mesh_g)(
        sh.shard_tiles(tiles, mesh_g), utile, gmask)[0].cpu().numpy()
    want_g = grouped_oracle(tiles, utile, gmask, TILE_ROWS)
    _check(np.array_equal(gcounts.astype(np.int64), want_g),
           "sharded grouped counts != host oracle")

    # the cols layout, sample axis sharded: kernel D packs each shard
    words_rm = tiles.reshape(T * TILE_ROWS, 4 * s)
    cols_g = sh.place_cols(words_rm, mesh_g, TILE_ROWS)
    n_valid = (gmask != 0).sum(axis=(1, 2)).astype(np.int32)
    ccounts = sh.make_sharded_cols_step(mesh_g)(cols_g, utile, gmask, n_valid)[0].cpu().numpy()
    _check(np.array_equal(ccounts.astype(np.int64), want_g),
           "sharded cols counts != host oracle")

    # ROW-sharded grouped step on a (d', r, s) mesh
    r = 2 if n_devices % 2 == 0 else 1
    dr = d * k if (d * k * r * s) <= n_devices else max(1, d * k // r)
    mesh_r = sh.make_row_mesh((dr, r, s), devices=devices)
    rcounts = sh.make_rowsharded_grouped_step(mesh_r, TILE_ROWS)(
        sh.shard_tiles_rows(tiles, mesh_r, TILE_ROWS), utile, gmask)[0].cpu().numpy()
    _check(np.array_equal(rcounts.astype(np.int64), want_g),
           "row-sharded grouped counts != host oracle")

    # bytes to counts (kernel H per batch shard, E per sample shard)
    klen, window = 31, 19
    L = 48 + klen - 1
    seqs = rng.choice(ACGT, size=(B, L))
    lens = np.full(B, L, dtype=np.int32)
    seq_kw = dict(k=klen, s=klen - window + 1, num_tiles=T, h=3, tile_rows=TILE_ROWS,
                  r=window + 1, u_cap=48, seed=MINIMIZER_SEED)
    scounts, s_nvalid, s_ok = sh.make_sharded_seq_step(mesh_g, **seq_kw)(cols_g, seqs, lens)
    _check(bool(s_ok.all()), "seq-step entry budget overflow")
    # the single-device reference: H and E over the whole cols
    cols = pack_tile_cols(torch.from_numpy(words_rm.view(np.int32)).to(home), TILE_ROWS)
    ut1, gm1, nv1, _ = seq_streams(torch.from_numpy(seqs).to(home),
                                   torch.from_numpy(lens).to(home), **seq_kw)
    want_s = cols_counts(cols, ut1, gm1, nv1)[0]
    _check(torch.equal(scounts, want_s) and torch.equal(s_nvalid, nv1),
           "sharded seq-step counts != single-device H + E")
    print("dryrun_multichip OK: mesh(d=%d,k=%d,s=%d) counts%s exact%s grouped%s cols%s "
          "row-sharded(r=%d)%s seq-serving%s, all value-checked against the host oracle / "
          "single-device kernels (array_equal)"
          % (d, k, s, counts.shape, exact.shape, gcounts.shape, ccounts.shape, r,
             rcounts.shape, tuple(scounts.shape)), flush=True)
    return {
        "inputs": {"words": matrix.words, "row_idx": row_idx, "mask": mask, "tiles": tiles,
                   "utile": utile, "gmask": gmask, "n_valid": n_valid, "seqs": seqs,
                   "lens": lens, "mesh": (d, k, s), "row_mesh": (dr, r, s)},
        "outputs": {"counts": counts, "exact": exact, "grouped": gcounts, "cols": ccounts,
                    "rowsharded": rcounts, "seq": scounts.cpu().numpy(),
                    "seq_n_valid": s_nvalid.cpu().numpy(), "seq_ok": s_ok.cpu().numpy()},
    }
