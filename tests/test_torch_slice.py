"""The port's slice end to end on the CPU: the CLI in a process that
never loads jax, and the HTTP server against bigsi_tpu's."""

import json
import os
import subprocess
import sys
import threading
import urllib.parse
import urllib.request

import numpy as np
import pytest
import yaml

import bigsi_tpu
from bigsi_tpu.__main__ import make_parser
from bigsi_tpu.__main__ import run as host_run
from bigsi_tpu.http.server import make_server as host_make_server
from bigsi_tpu.kmers import seq_to_kmers
from bigsi_tpu.storage import get_storage
from bigsi_tpu_torch.http.server import make_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 31

# runs in a fresh interpreter, so tests/conftest.py (which imports jax)
# is never loaded: the port's CLI, with its engine on the CPU (the
# minimizer index's bulk_search takes the seq arm, kernel H's plain version)
CLI_SCRIPT = """
import json, sys
from bigsi_tpu_torch.ops import prep
from bigsi_tpu_torch.__main__ import make_parser, run
real, preps = prep.prep_streams, []
prep.prep_streams = lambda *a, **kw: preps.append(1) or real(*a, **kw)
out = [run(make_parser().parse_args(argv), device="cpu") for argv in json.loads(sys.argv[1])]
print(json.dumps({"outputs": out, "jax_loaded": "jax" in sys.modules, "seq_preps": len(preps)}))
"""


def random_seq(rng, n):
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, n)])


def build(config, rng, n=6):
    genomes = [random_seq(rng, 250) for _ in range(n)]
    blooms = [bigsi_tpu.BIGSI.bloom(config, seq_to_kmers(g, K)) for g in genomes]
    bigsi_tpu.BIGSI.build(config, blooms, ["g%d" % i for i in range(n)])
    return genomes


@pytest.mark.parametrize("layout", ["classic", "minimizer"])
def test_cli_search_and_bulk_search_without_jax(tmp_path, layout):
    rng = np.random.default_rng(11)
    config = {
        "storage-engine": "bigsi-tpu", "storage-config": {"filename": str(tmp_path / "idx")},
        "k": K, "m": 10000, "h": 3, "layout": layout,
    }
    if layout == "minimizer":
        config["tile-rows"] = 32
    genomes = build(config, rng)
    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump(config))
    fasta = tmp_path / "q.fasta"
    queries = [genomes[0][:100], genomes[1][50:200], random_seq(rng, 90)]
    fasta.write_text("".join(">q%d\n%s\n" % (i, q) for i, q in enumerate(queries)))
    argvs = [
        ["search", genomes[2][:80], "-c", str(cfg)],
        ["search", genomes[3], "-t", "0.7", "-c", str(cfg), "--format", "csv"],
        ["bulk_search", str(fasta), "-c", str(cfg)],
        ["bulk_search", str(fasta), "-t", "0.7", "-c", str(cfg)],
    ]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", CLI_SCRIPT, json.dumps(argvs)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["jax_loaded"] is False
    assert got["seq_preps"] == (2 if layout == "minimizer" else 0)  # the two bulk_searches
    want = [host_run(make_parser().parse_args(argv)) for argv in argvs]
    assert got["outputs"] == want
    assert json.loads(want[0])["results"], "the exact search hits"


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("layout", ["classic", "minimizer"])
def test_http_search_matches_jax_package_server(layout):
    rng = np.random.default_rng(12)
    config = {
        "storage-engine": "memory", "storage-config": {"filename": "ts-http-" + layout},
        "k": K, "m": 10000, "h": 3, "layout": layout,
    }
    if layout == "minimizer":
        config["tile-rows"] = 32
    get_storage(config).delete_all()
    genomes = build(config, rng)
    servers = [
        make_server(config, host="127.0.0.1", port=0, device="cpu"),
        host_make_server(config, host="127.0.0.1", port=0),
    ]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
    for t in threads:
        t.start()
    try:
        bases = ["http://127.0.0.1:%d/search" % s.server_address[1] for s in servers]
        for seq, threshold in ((genomes[0], 1.0), (genomes[1][:90], 0.7),
                               (random_seq(rng, 80), 0.7)):
            query = "?" + urllib.parse.urlencode({"seq": seq, "threshold": threshold})
            port_d, host_d = (_get(b + query) for b in bases)
            assert port_d == host_d
        body = {"seq": genomes[2], "threshold": 0.7, "score": True}
        port_d, host_d = (_post(b, body) for b in bases)
        assert port_d == host_d and port_d["results"]
        assert type(servers[0].bigsi).__module__.startswith("bigsi_tpu_torch")
    finally:
        for s in servers:
            s.shutdown()
            s.invalidate()
            s.server_close()
        for t in threads:
            t.join(timeout=30)
