"""bigsi_tpu_torch stands on its own.

* No module of the port, and not ``chip_smoke.py``, imports bigsi_tpu
  (the exact package) or jax: a static scan of every import statement,
  those inside functions included, and of every ``importlib`` /
  ``__import__`` call with a constant name.
* A fresh interpreter imports every module of the port and
  ``chip_smoke``, then runs every host verb of the port's CLI (bloom,
  build, search, bulk_search, variant_search, insert, compact, merge,
  delete) on a small on-disk index, once with ``engine: numpy`` and once
  on the CUDA engine's plain versions (``device="cpu"``); neither
  bigsi_tpu nor jax is loaded at the end, and every output equals the
  bigsi_tpu CLI's on the same steps.
* Indexes are interchangeable: each package's CLI builds classic,
  blocked/32 and minimizer/16 indexes from the same cortex graphs, the
  bloom and index files are byte-equal, and either package's searches
  on either index give equal result dicts.
* The copied pure functions equal bigsi_tpu's on seeded inputs, the
  port-built native library included.
"""

import ast
import importlib
import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

import bigsi_tpu.__main__ as ref_cli
import bigsi_tpu_torch.__main__ as port_cli
from bigsi_tpu_torch.io.cortex import encode_kmer

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "bigsi_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
K = 31


def forbidden(name: str) -> bool:
    return any(name == p or name.startswith(p + ".") for p in ("bigsi_tpu", "jax"))


def imported_names(tree: ast.AST):
    """Every module name an import statement or a constant-named
    importlib.import_module / __import__ call of ``tree`` loads."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__") and isinstance(node.args[0].value, str):
                yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_bigsi_tpu_or_jax(path):
    names = list(imported_names(ast.parse(path.read_text(), filename=str(path))))
    assert not [n for n in names if forbidden(n)]


def test_the_scan_finds_every_kind_of_import():
    tree = ast.parse(
        "import jax.numpy\nfrom bigsi_tpu import native\n"
        "def f():\n    import bigsi_tpu.kmers\n    importlib.import_module('jax')\n"
        "    __import__('bigsi_tpu.graph')\nfrom bigsi_tpu_torch import native\n")
    assert [n for n in imported_names(tree) if forbidden(n)] == [
        "jax.numpy", "bigsi_tpu", "bigsi_tpu.kmers", "jax", "bigsi_tpu.graph"]


# -- the CLI in a fresh interpreter ----------------------------------------------


def write_ctx(path, seq, k=K):
    """A one-colour cortex v6 graph of the k-mers of ``seq``."""
    head = b"CORTEX" + struct.pack("<IIII", 6, k, 1, 1)
    head += struct.pack("<IQ", 100, len(seq))  # mean read length, total sequence
    head += struct.pack("<I", 1) + b"s" + bytes(16)  # sample name, error rate
    head += bytes(12) + struct.pack("<I", 5) + b"clean" + b"CORTEX"  # cleaning info
    records = b"".join(encode_kmer(seq[i:i + k]) + struct.pack("<IB", 1, 0)
                       for i in range(len(seq) - k + 1))
    Path(path).write_bytes(head + records)


def random_seq(rng, n):
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, n)])


def ctx_kmers(ctx):
    from bigsi_tpu_torch.io.cortex import extract_kmers_from_ctx

    return list(extract_kmers_from_ctx(str(ctx), K))


def workspace(tmp_path, rng, extra):
    """Cortex graphs of three genomes, a query FASTA, a variant reference,
    a fake ``mykrobe`` that prints that variant's probes, and two index
    configs under ``tmp_path``; -> (paths, configs, probes' genomes)."""
    genomes = [random_seq(rng, 300) for _ in range(3)]
    for i, g in enumerate(genomes):
        write_ctx(tmp_path / ("g%d.ctx" % i), g)
    kmers = [ctx_kmers(tmp_path / ("g%d.ctx" % i)) for i in range(3)]
    (tmp_path / "q.fasta").write_text(
        "".join(">q%d\n%s\n" % (i, "".join(km[i * 7][j] for j in range(K)))
                for i, km in enumerate(kmers)))
    (tmp_path / "ref.fasta").write_text(">ref\n%s\n" % genomes[0])
    probe_ref, probe_alt = kmers[0][40], kmers[0][40][:15] + "T" + kmers[0][40][16:]
    mykrobe = tmp_path / "bin" / "mykrobe"
    mykrobe.parent.mkdir()
    mykrobe.write_text("#!/bin/sh\nprintf '>ref-A16T\\n%s\\n>alt-A16T\\n%s\\n'\n"
                       % (probe_ref, probe_alt))
    mykrobe.chmod(0o755)
    cfgs = []
    for name in ("idx", "idx2"):
        cfg = {"k": K, "m": 20000, "h": 3, "storage-engine": "bigsi-tpu",
               "storage-config": {"filename": str(tmp_path / name)}, **extra}
        path = tmp_path / (name + ".yaml")
        path.write_text(yaml.safe_dump(cfg))
        cfgs.append(str(path))
    return kmers, cfgs


def verbs(tmp_path, kmers, cfgs):
    t, (cfg, cfg2) = str(tmp_path), cfgs
    return [
        ["bloom", t + "/g0.ctx", t + "/b0.bloom", "-c", cfg],
        ["bloom", t + "/g1.ctx", t + "/b1.bloom", "-c", cfg],
        ["bloom", t + "/g2.ctx", t + "/b2.bloom", "-c", cfg],
        ["build", t + "/b0.bloom", t + "/b1.bloom", "-s", "s0", "s1", "-c", cfg],
        ["search", kmers[0][3], "-c", cfg],
        ["search", kmers[1][5], "-t", "0.5", "-c", cfg, "--format", "csv"],
        ["bulk_search", t + "/q.fasta", "-t", "0.5", "-c", cfg],
        ["variant_search", t + "/ref.fasta", "A", "16", "T", "-c", cfg],
        ["insert", t + "/b2.bloom", "s2", "-c", cfg],
        ["search", kmers[2][8], "-c", cfg],
        ["compact", "-c", cfg],
        ["build", t + "/b2.bloom", "-s", "s3", "-c", cfg2],
        ["merge", cfg2, "-c", cfg],
        ["bulk_search", t + "/q.fasta", "-c", cfg],
        ["delete", "-c", cfg],
    ]


CLI_SCRIPT = """
import importlib, json, pkgutil, sys
import bigsi_tpu_torch
names = [m.name for m in pkgutil.walk_packages(bigsi_tpu_torch.__path__, "bigsi_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from bigsi_tpu_torch.__main__ import make_parser, run
argvs, device = json.loads(sys.argv[1])
out = [run(make_parser().parse_args(argv), device=device) for argv in argvs]
loaded = sorted(m for m in sys.modules
                if m in ("bigsi_tpu", "jax") or m.startswith(("bigsi_tpu.", "jax.")))
print(json.dumps({"modules": len(names), "outputs": out, "loaded": loaded}))
"""


@pytest.mark.parametrize("engine", ["numpy", "cuda-on-cpu"])
def test_port_cli_runs_every_host_verb_alone(tmp_path, engine):
    extra = {"engine": "numpy"} if engine == "numpy" else {}
    runs = {}
    for who in ("port", "ref"):
        work = tmp_path / who
        work.mkdir()
        kmers, cfgs = workspace(work, np.random.default_rng(3), extra)
        runs[who] = (work, verbs(work, kmers, cfgs))
    work, argvs = runs["port"]
    env = dict(os.environ, PYTHONPATH=str(ROOT), PATH="%s/bin:%s" % (work, os.environ["PATH"]))
    proc = subprocess.run(
        [sys.executable, "-c", CLI_SCRIPT, json.dumps([argvs, "cpu"])],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["loaded"] == [] and got["modules"] > 40
    ref_work, ref_argvs = runs["ref"]
    old_path = os.environ["PATH"]
    os.environ["PATH"] = "%s/bin:%s" % (ref_work, old_path)
    try:
        want = [ref_cli.run(ref_cli.make_parser().parse_args(a)) for a in ref_argvs]
    finally:
        os.environ["PATH"] = old_path
    want = [None if w is None else w.replace(str(ref_work), str(work)) for w in want]
    assert got["outputs"] == want
    found = json.loads(want[4])["results"]
    assert [r["sample_name"] for r in found] == ["s0"]
    assert json.loads(want[7])["results"] == [{"sample_name": "s0", "genotype": "0/0"}]


def test_serve_distributed_is_not_ported():
    args = port_cli.make_parser().parse_args(["serve", "--distributed"])
    with pytest.raises(NotImplementedError, match="distributed"):
        port_cli.run(args, device="cpu")


# -- on-disk compatibility -------------------------------------------------------


LAYOUTS = {
    "classic": {},
    "blocked32": {"layout": "blocked", "tile-rows": 32},
    "minimizer16": {"layout": "minimizer", "tile-rows": 16, "minimizer-window": 19},
}


def dir_bytes(path):
    return {p.relative_to(path).as_posix(): p.read_bytes()
            for p in sorted(Path(path).rglob("*")) if p.is_file()}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_indexes_are_interchangeable(tmp_path, layout):
    rng = np.random.default_rng(len(layout))
    genomes = [random_seq(rng, 400) for _ in range(4)]
    for i, g in enumerate(genomes):
        write_ctx(tmp_path / ("g%d.ctx" % i), g)
    cfgs = {}
    for who, cli in (("ref", ref_cli), ("port", port_cli)):
        cfg = {"k": K, "m": 30000, "h": 3, "storage-engine": "bigsi-tpu",
               "storage-config": {"filename": str(tmp_path / who / "idx")}, **LAYOUTS[layout]}
        cfgs[who] = tmp_path / who / "config.yaml"
        cfgs[who].parent.mkdir()
        cfgs[who].write_text(yaml.safe_dump(cfg))
        blooms = [str(tmp_path / who / ("b%d.bloom" % i)) for i in range(4)]
        kw = {"device": "cpu"} if cli is port_cli else {}
        for i, b in enumerate(blooms):
            cli.run(cli.make_parser().parse_args(
                ["bloom", str(tmp_path / ("g%d.ctx" % i)), b, "-c", str(cfgs[who])]), **kw)
        cli.run(cli.make_parser().parse_args(
            ["build", *blooms, "-s", "a", "b", "c", "d", "-c", str(cfgs[who])]), **kw)
    ref_files, port_files = dir_bytes(tmp_path / "ref"), dir_bytes(tmp_path / "port")
    del ref_files["config.yaml"], port_files["config.yaml"]
    assert ref_files.keys() == port_files.keys() and ref_files == port_files

    kmers = ctx_kmers(tmp_path / "g1.ctx")
    queries = [[kmers[10], "-t", "1.0"], ["".join(kmers[20]) + kmers[21][-1], "-t", "0.5"],
               [random_seq(rng, 60), "-t", "0.3"]]
    for q in queries:
        results = []
        for cli, who, kw in ((ref_cli, "ref", {}), (ref_cli, "port", {}),
                             (port_cli, "ref", {"device": "cpu"}),
                             (port_cli, "port", {"device": "cpu"})):
            args = cli.make_parser().parse_args(["search", q[0], *q[1:], "-c", str(cfgs[who])])
            results.append(json.loads(cli.run(args, **kw)))
        assert all(r == results[0] for r in results[1:])
    assert json.loads(ref_cli.run(ref_cli.make_parser().parse_args(
        ["search", kmers[10], "-c", str(cfgs["port"])])))["results"]


# -- the copied pure functions ---------------------------------------------------


def kmer_matrix(rng, n, k=K, alphabet=b"ACGT"):
    return np.frombuffer(alphabet, dtype=np.uint8)[rng.integers(0, len(alphabet), (n, k))]


def parity_murmur3(ref, port, rng):
    for seed in (0, 1, 7, 2**31 + 5):
        data = bytes(rng.integers(0, 256, int(rng.integers(0, 40)), dtype=np.uint8))
        assert ref.hashing.murmur3.murmur3_32(data, seed) == port.hashing.murmur3.murmur3_32(data, seed)
    kmers = kmer_matrix(rng, 500)
    seeds = np.arange(5, dtype=np.uint32)
    np.testing.assert_array_equal(ref.hashing.murmur3.murmur3_32_batch(kmers, seeds),
                                  port.hashing.murmur3.murmur3_32_batch(kmers, seeds))
    np.testing.assert_array_equal(ref.hashing.murmur3.hash_kmer_matrix(kmers, 3, 25000),
                                  port.hashing.murmur3.hash_kmer_matrix(kmers, 3, 25000))
    assert ref.hashing.murmur3.generate_hashes("ACGTTGCA" * 4, 3, 1000) == \
        port.hashing.murmur3.generate_hashes("ACGTTGCA" * 4, 3, 1000)


def parity_row_indices(ref, port, rng):
    kmers = ref.kmers.canonicalize_kmer_matrix(kmer_matrix(rng, 400, alphabet=b"ACGTN"))
    for layout, tile_rows, window, scheme in (("classic", 32, None, 1), ("blocked", 32, None, 1),
                                              ("minimizer", 16, 19, 3), ("minimizer", 32, None, 2),
                                              ("minimizer", 64, 11, 1)):
        kw = dict(layout=layout, tile_rows=tile_rows, window=window, slot_scheme=scheme)
        np.testing.assert_array_equal(ref.hashing.scheme.row_indices(kmers, 3, 1 << 20, **kw),
                                      port.hashing.scheme.row_indices(kmers, 3, 1 << 20, **kw))


def parity_pack_codes_v3(ref, port, rng):
    kmers = kmer_matrix(rng, 300, alphabet=b"ACGTNacgt")
    for a, b in zip(ref.hashing.scheme.pack_codes_v3(kmers), port.hashing.scheme.pack_codes_v3(kmers)):
        np.testing.assert_array_equal(a, b)
    z = rng.integers(0, 2**63, 100, dtype=np.uint64) * np.uint64(2)
    np.testing.assert_array_equal(ref.hashing.scheme.splitmix64(z), port.hashing.scheme.splitmix64(z))


def parity_seq_to_kmers(ref, port, rng):
    seq = "".join(np.array(list("ACGTN"))[rng.integers(0, 5, 200)])
    assert list(ref.kmers.seq_to_kmers(seq, K)) == list(port.kmers.seq_to_kmers(seq, K))
    a, b = ref.kmers.seq_to_kmer_matrix(seq, K), port.kmers.seq_to_kmer_matrix(seq, K)
    np.testing.assert_array_equal(a, b)
    for x, y in zip(ref.kmers.unique_rows_with_inverse(a), port.kmers.unique_rows_with_inverse(b)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(ref.kmers.canonicalize_kmer_matrix(a),
                                  port.kmers.canonicalize_kmer_matrix(b))


def parity_packing(ref, port, rng):
    bits = rng.random((77, 45)) < 0.4
    words = ref.matrix.packing.pack_bits_lsb(bits)
    np.testing.assert_array_equal(words, port.matrix.packing.pack_bits_lsb(bits))
    np.testing.assert_array_equal(ref.matrix.packing.unpack_bits_lsb(words, 45),
                                  port.matrix.packing.unpack_bits_lsb(words, 45))
    bloom = rng.random(1003) < 0.3
    data = ref.matrix.packing.bools_to_bloom_bytes(bloom)
    assert data == port.matrix.packing.bools_to_bloom_bytes(bloom)
    np.testing.assert_array_equal(ref.matrix.packing.bloom_bytes_to_bools(data, 1003),
                                  port.matrix.packing.bloom_bytes_to_bools(data, 1003))


def parity_scorer(ref, port, rng):
    for n in (1, 50, 400):
        s = "".join("01"[int(b)] for b in (rng.random(n) < 0.85))
        assert ref.scoring.Scorer(1000).score(s) == port.scoring.Scorer(1000).score(s)


def parity_native_prep(ref, port, rng):
    assert port.native.available(), "the port builds its own native library"
    path = port.native._build.library_path(port.native.SOURCE, port.native.CXX_FLAGS)
    assert path.parent == ROOT / "build" / "bigsi_tpu_torch" and path.exists()
    kmers = kmer_matrix(rng, 600)
    qstart = np.array([0, 250, 250, 600], dtype=np.int64)
    for name in ("prep_minimizer_v3", "prep_minimizer_v2"):
        args = (kmers, qstart, 13, ref.hashing.scheme.MINIMIZER_SEED, 1 << 14, 3, 16, 20)
        want, got = getattr(ref.native, name)(*args), getattr(port.native, name)(*args)
        assert want is not None and got is not None
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)


PARITY = {name[len("parity_"):]: fn for name, fn in globals().items() if name.startswith("parity_")}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_copied_functions_match_bigsi_tpu(case):
    ref = importlib.import_module("bigsi_tpu")
    port = importlib.import_module("bigsi_tpu_torch")
    for mod in ("hashing.murmur3", "hashing.scheme", "kmers", "matrix.packing", "scoring",
                "native"):
        importlib.import_module("bigsi_tpu." + mod)
        importlib.import_module("bigsi_tpu_torch." + mod)
    PARITY[case](ref, port, np.random.default_rng(len(case)))
