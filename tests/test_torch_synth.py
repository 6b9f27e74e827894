"""bigsi_tpu_torch.synth: a small index drawn on the CPU into a directory
reopens in bigsi_tpu with the layout's own parameters, its planted
columns are bigsi_tpu's blooms of the planted sequences, and the port
(device="cpu") answers on it exactly as bigsi_tpu's host engine does.
A verified config also gets its screen matrix.  Also the facade's
per-layer timers of one search_batch."""

import numpy as np
import pytest
import torch

import bigsi_tpu
import bigsi_tpu_torch
from bigsi_tpu.hashing.scheme import default_slot_scheme
from bigsi_tpu.kmers import seq_to_kmers
from bigsi_tpu_torch.synth import bloom_density, synth_index

K = 31
N_SAMPLES = 40  # not a multiple of 32: the last word has phantom columns


def random_seq(rng, n):
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, n)])


def make(tmp_path, layout, tile_rows=32, **extra):
    rng = np.random.default_rng(7)
    config = {
        "storage-engine": "bigsi-tpu", "storage-config": {"filename": str(tmp_path / layout)},
        "k": K, "m": 4096, "h": 3, "layout": layout, **extra,
    }
    if layout != "classic":
        config["tile-rows"] = tile_rows
    planted = [random_seq(rng, 400) for _ in range(3)]
    names = ["p%d" % i for i in range(3)] + ["s%d" % i for i in range(3, N_SAMPLES)]
    gen = torch.Generator(device="cpu").manual_seed(5)
    synth_index(config, names, planted, bloom_density(3, 50, 4096), gen, chunk_rows=1000)
    return config, planted


@pytest.mark.parametrize("layout,tile_rows", [("classic", 32), ("minimizer", 32),
                                              ("minimizer", 64)])
def test_synth_index_serves_like_the_host_engine(tmp_path, layout, tile_rows):
    config, planted = make(tmp_path, layout, tile_rows)
    host = bigsi_tpu.BIGSI(config)
    assert host.num_samples == N_SAMPLES
    assert (host.layout, host.bloomfilter_size) == (layout, 4096)
    if layout != "classic":
        assert host.tile_rows == tile_rows
    assert host.slot_scheme == default_slot_scheme(layout, config)
    words = np.asarray(host.bitmatrix.words)
    bits = np.unpackbits(words.view(np.uint8), axis=1, bitorder="little")
    for c, seq in enumerate(planted):
        want = np.asarray(bigsi_tpu.BIGSI.bloom(config, seq_to_kmers(seq, K)), dtype=bool)
        np.testing.assert_array_equal(bits[:, c].astype(bool), want)
    assert not bits[:, N_SAMPLES:].any(), "phantom columns stay zero"
    density = bits[:, len(planted):N_SAMPLES].mean()
    assert abs(density - bloom_density(3, 50, 4096)) < 0.01

    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    rng = np.random.default_rng(1)
    queries = [p[i:i + 120] for i, p in enumerate(planted)] + [random_seq(rng, 120)]
    for threshold in (1.0, 0.7):
        got = port.search_batch(queries, threshold)
        assert got == host.search_batch(queries, threshold)
        assert [port.search(q, threshold) for q in queries] == [
            host.search(q, threshold) for q in queries]
    for i in range(len(planted)):
        assert "p%d" % i in {r["sample_name"] for r in got[i]}


def test_synth_index_draws_verified_indexes(tmp_path):
    """A verified config: rows.bin as a classic index's, screen.bin at the
    screen's m with the planted blooms' screen halves and the density of
    blooms of as many k-mers over screen-m bits; the persisted screen
    keys reopen it in bigsi_tpu, and the port answers as bigsi_tpu does
    on both of its engines."""
    config, planted = make(tmp_path, "classic", screen="minimizer", **{"screen-m": 2048})
    host = bigsi_tpu.BIGSI(config)
    assert host.screen == {"m": 2048, "tile_rows": 16, "window": 19, "slot_scheme": 3,
                           "run_len": 20}
    assert host.screen_matrix.num_rows == 2048 and host.screen_matrix.num_cols == N_SAMPLES
    planes = {"rows": (np.asarray(host.bitmatrix.words), slice(0, 4096), 4096),
              "screen": (np.asarray(host.screen_matrix.words), slice(4096, None), 2048)}
    for name, (words, half, m) in planes.items():
        bits = np.unpackbits(words.view(np.uint8), axis=1, bitorder="little")
        for c, seq in enumerate(planted):
            want = np.asarray(bigsi_tpu.BIGSI.bloom(config, seq_to_kmers(seq, K)), dtype=bool)
            np.testing.assert_array_equal(bits[:, c].astype(bool), want[half], err_msg=name)
        assert not bits[:, N_SAMPLES:].any(), "phantom columns stay zero"
        density = bits[:, len(planted):N_SAMPLES].mean()
        assert abs(density - bloom_density(3, 50, m)) < 0.015, name

    rng = np.random.default_rng(1)
    queries = [p[i:i + 120] for i, p in enumerate(planted)] + [random_seq(rng, 120)]
    for engine in (None, "numpy"):
        port = bigsi_tpu_torch.BIGSI(dict(config, engine=engine), device="cpu")
        for threshold in (1.0, 0.7):
            got = port.search_batch(queries, threshold)
            assert got == host.search_batch(queries, threshold)
            assert [port.search(q, threshold) for q in queries] == [
                host.search(q, threshold) for q in queries]
        for i in range(len(planted)):
            assert "p%d" % i in {r["sample_name"] for r in got[i]}
        bigsi_tpu_torch.metrics.reset()
        port.search_batch(queries, 0.7)
        timers = bigsi_tpu_torch.metrics.snapshot()["timers"]
        for name in ("search.screen_counts", "search.candidates", "search.verify",
                     "search.batch_results"):
            assert timers[name]["count"] == 1, name


def test_search_batch_times_each_layer(tmp_path):
    """The facade times the engine's counts and, in the port, result
    building: both inside one search_batch, each once."""
    config, planted = make(tmp_path, "classic")
    port = bigsi_tpu_torch.BIGSI(config, device="cpu")
    bigsi_tpu_torch.metrics.reset()
    port.search_batch([p[:100] for p in planted], 0.7)
    timers = bigsi_tpu_torch.metrics.snapshot()["timers"]
    for name in ("search.batch_counts", "search.batch_results"):
        assert timers[name]["count"] == 1
        assert timers[name]["total_s"] >= 0.0
