"""Run one cell of the benchmark once, on the card:

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names its configuration and traffic mix.  The run draws
the index and the traffic from the seed, opens the index through the
program's own entry, warms up on the cell's traffic, measures for
``--seconds``, checks the window's answers against the plain reference
and prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, traced
with ``torch.profiler``), ``device`` and, last, ``checks``: each number
compared with its limit, also printed as the last lines of standard
error.  It exits non-zero, with no result, without enough CUDA devices,
without the program beside it, or when the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PROGRAM = "bigsi_tpu_torch"
# the math libraries' thread pools, fixed before numpy or torch loads, so
# that no idle pool spins beside the program's own native threads
HOST_THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(message: str) -> int:
    print("benchmark: " + message, file=sys.stderr)
    return 1


def main(argv=None) -> int:
    args = parse(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    if not (ROOT / PROGRAM / "__init__.py").is_file():
        return fail("the program %s is not in %s" % (PROGRAM, ROOT))
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ.update(HOST_THREADS)
    from benchmark.harness import spec as specs
    from benchmark.harness.guard import forbidden_loaded

    spec = specs.load(args.workload, bool(args.trace))
    import torch

    chips = spec.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return fail("the cell needs %d CUDA device(s); %d available"
                    % (chips, torch.cuda.device_count() if torch.cuda.is_available() else 0))
    import bigsi_tpu_torch

    if Path(bigsi_tpu_torch.__file__).resolve().parent != ROOT / PROGRAM:
        return fail("%s loaded from %s, not from this checkout"
                    % (PROGRAM, bigsi_tpu_torch.__file__))
    from benchmark.harness.cell import execute

    result = execute(spec, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    bad = forbidden_loaded()
    if bad:
        return fail("the JAX package was loaded: %s" % ", ".join(bad))
    for name, c in result["checks"].items():
        print("%s %s limit %s" % (name, c["value"], c["limit"]), file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
