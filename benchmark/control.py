"""The control of the check that decides ``correct``: the plain
reference put in the program's place with one guarantee of the
configuration broken (each k-mer's presence read from h - 1 of its h
rows, as a cheaper lookup would), held to the same comparison as a run's
answers, on the cell's own index and traffic for each seed.  It has to
come out wrong; its ``wrong_answers`` are the upper readings the limits
were set below.

    python benchmark/control.py --workload <name> --seeds <n> ... [--device cuda:0]

A JSON line a seed.  It runs no program code but the index's storage.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(spec, index, seed: int) -> dict:
    """The numbers a run compares, with the control's answers in place of
    the program's, for the answers a run of ``seed`` would check."""
    import numpy as np

    from benchmark.harness import check, traffic
    from benchmark.reference.search import Reference

    mix = spec.traffic
    rng = np.random.default_rng([seed, 6])
    cfg = spec.config["index"]
    if mix["loop"] == "closed":
        pool = traffic.closed_pool(mix, index.sources, seed)
        asked = [(q, pool.thresholds[j % len(pool.thresholds)])
                 for j, batch in enumerate(pool.batches) for q in batch]
    else:
        sched = traffic.open_schedule(mix, index.sources, seed, 10.0)
        asked = [(sched.queries[q], float(t)) for q, t in zip(sched.query, sched.thresholds)]
    asked = check.pick(rng, asked, [len(q) for q, _ in asked], mix.get("checked_answers", 128))
    score = bool(mix.get("score"))
    control = Reference(index.words, index.names, cfg, spec.config["reference"], cfg["h"] - 1)
    got = [control.answer(q, t, score) for q, t in asked]
    reference = Reference(index.words, index.names, cfg, spec.config["reference"])
    return check.compare(reference, asked, got, score)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import check, spec as specs
    from benchmark.harness.index import synthesize

    spec = specs.load(args.workload, False)
    for seed in args.seeds:
        index = synthesize(spec.config, seed, args.device)
        numbers = control_numbers(spec, index, seed)
        del index
        print(json.dumps({"workload": args.workload, "seed": seed, "control": numbers,
                          "correct": check.verdict(numbers)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
