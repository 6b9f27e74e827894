"""Timing (and the kernel-against-plain check) shared by
``chip_smoke.py`` and the probe scripts.

On a CUDA device a time is device time from CUDA events, each call
started with a cold L2 (:func:`cuda_ms`), and it is printed beside the
card's name and power limit as ``nvidia-smi`` reports them.  On the CPU
(``--device cpu``, the plain PyTorch versions) it is the host clock, and
the label says so: no CPU number stands for a device time.
"""

from __future__ import annotations

import subprocess
import time

import torch

FLUSH_WORDS = 128 << 20  # int32s written before each timed call: 512 MB, ten times the L2


def gpu_name_and_power() -> str:
    """The first card's ``name, power.limit`` from nvidia-smi."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def device_label(device) -> str:
    """What a time on ``device`` was taken on: the card's name and power
    limit, or the CPU's host clock."""
    if torch.device(device).type == "cuda":
        return gpu_name_and_power()
    return "cpu, host clock (not a device time)"


def cuda_ms(fn, reps: int, device="cuda") -> float:
    """Mean device time of one call, each started with a cold L2, as a
    batch of new queries finds it: a 512 MB write (ten times the L2)
    runs before each call and keeps the device busy while the host
    enqueues it, so the time excludes the host's launch overhead."""
    flush = torch.empty(FLUSH_WORDS, dtype=torch.int32, device=device)
    fn()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def host_ms(fn, reps: int) -> float:
    """Mean host-clock time of one call after a warm-up call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def time_ms(fn, reps: int, device) -> float:
    """:func:`cuda_ms` on a CUDA device, :func:`host_ms` on the CPU."""
    if torch.device(device).type == "cuda":
        return cuda_ms(fn, reps, device)
    return host_ms(fn, reps)


def print_time(what: str, ms: float, label: str, extra: str = "") -> None:
    """One line: what was timed, its ms, derived rates, and where."""
    print("%-32s %10.4f ms  %s  [%s]" % (what, ms, extra, label), flush=True)


def same(got, want) -> bool:
    """Kernel and plain outputs (a tensor, or tuples of tensors and
    Nones) equal bit for bit."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    return len(got) == len(want) and all(
        (g is None and w is None) or (g is not None and w is not None and torch.equal(g, w))
        for g, w in zip(got, want))
