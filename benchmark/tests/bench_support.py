"""Shared by the benchmark's tests: its cells, the mixes it keeps for
cells not yet in ``BENCHMARK.json`` (an open loop over HTTP, scored
batches), and each one's spec cut to a size the CPU holds."""

from __future__ import annotations

import copy
import json

CELLS = ("classic-n8192.genes", "minimizer16-n8192.short")
KEPT = ("minimizer16-n8192.http", "minimizer16-n8192.scored")


def load(workload: str, trace: bool = False):
    """A cell's spec from ``BENCHMARK.json``, or for ``<config>.<mix>`` of
    ``KEPT`` one built from the two files, with no metrics."""
    from benchmark.harness import spec as specs

    if workload not in KEPT:
        return specs.load(workload, trace)
    config, mix = workload.rsplit(".", 1)
    with open(specs.HERE / "configs" / (config + ".json")) as f:
        cfg = json.load(f)
    with open(specs.HERE / "traffic" / (mix + ".json")) as f:
        traffic = json.load(f)
    cell = {"name": workload, "config": config, "traffic": mix, "chips": 1}
    return specs.Spec(cell, cfg, traffic, [])


def tiny(workload: str, trace: bool = False):
    """The cell's spec at a size the CPU holds: 96 samples (64 planted),
    m = 2^18, small batches, a slow open loop."""
    spec = load(workload, trace)
    spec.config = copy.deepcopy(spec.config)
    spec.config["samples"] = 96
    spec.config["index"]["m"] = 1 << 18
    mix = dict(spec.traffic, checked_answers=16)
    if mix["loop"] == "closed":
        mix.update(batch=min(mix["batch"], 8), pool_batches=3)
    else:
        mix.update(rate_per_s=40, pool_queries=64, block=32, warmup_s=0.5)
    spec.traffic = mix
    return spec
