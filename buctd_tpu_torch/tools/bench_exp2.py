"""Transcendental throughput on one CUDA card: exp against exp2 against
exp2(x * log2 e), the kernel K6 (ops/exp_throughput.py).

    python -m buctd_tpu_torch.tools.bench_exp2 [--rounds 5]

Counterpart of tools/bench_exp2.py.  One launch runs INNER = 128 chained
``op(y * 0.03)`` over a (512, 1024) f32 tensor; OUTER = 8 launches are chained,
the variants run in turns over the rounds, medians printed.  A launch takes
tens of microseconds, as long as the host's work to issue it, so the time is
the device time of the chain run back to back (``device_ms``: the launches
queued behind a spin kernel, between two CUDA events); the CUDA-event time of
the chain issued on an idle card, host gaps included, is printed beside it.
The flash kernels' softmax (csrc/flash_fwd.cu) runs in exp2; this asks what
that choice is worth on the card's special-function units.  Beside each: the
same chain as torch.mul and torch.exp / torch.exp2 calls (two or three
kernels a step, replayed from a CUDA graph: ``captured``), and the bound: the transcendentals over
the SFU rate, 16 MUFU.EX2 a clock on each of the H100's 132 SMs at the card's
maximum SM clock (nvidia-smi's clocks.max.sm), or the bytes over 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch

from ..ops.exp_throughput import INNER, LOG2E, SCALE, VARIANTS, exp_chain

ROWS, COLS = 512, 1024
OUTER = 8
ROUNDS = 5
SMS, EX2_PER_SM_CLOCK = 132, 16          # H100 SXM: SMs; MUFU.EX2 a clock a SM
HBM_BYTES_PER_S = 3.35e12


def sm_clock_hz() -> float:
    """The card's maximum SM clock, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return float(out.splitlines()[0]) * 1e6


def bound(n_elements: int, inner: int, outer: int, clock_hz: float) -> dict:
    """Least time of ``outer`` launches, ms: one MUFU.EX2 per step and
    element over the SFU rate, or each launch's f32 in and out over the
    memory rate."""
    t_ops = n_elements * inner * outer / (SMS * EX2_PER_SM_CLOCK * clock_hz)
    t_bytes = 8.0 * n_elements * outer / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def library_chain(x, variant: str, inner: int = INNER):
    """The chain as PyTorch calls into preallocated buffers: torch.mul, then
    torch.exp or torch.exp2 (and a second torch.mul for exp2(x * log2 e))."""
    y, t = torch.empty_like(x), torch.empty_like(x)
    src = x
    for _ in range(inner):
        torch.mul(src, SCALE, out=t)
        if variant == "exp":
            torch.exp(t, out=y)
        elif variant == "exp2":
            torch.exp2(t, out=y)
        else:
            torch.exp2(torch.mul(t, LOG2E, out=t), out=y)
        src = y
    return y


def events_ms(fn) -> float:
    """Time of one call of ``fn`` between two CUDA events, ms (the gaps between
    its launches included)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def device_ms(fn, clock_hz: float, host_s: float) -> float:
    """Device time of one call of ``fn``, ms, without the host's gaps between
    its launches: a spin kernel (``torch.cuda._sleep``) holds the stream for
    twice ``host_s`` (the host's time to issue ``fn``) plus 1 ms while the
    host issues ``fn`` between two CUDA events, so the card runs its launches
    back to back.  Raises if the card reached the first event before the host
    had issued them all."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int((2 * host_s + 1e-3) * clock_hz))
    start.record()
    fn()
    end.record()
    if start.query():
        raise RuntimeError("the card caught up with the host inside the timed region")
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def host_s(fn) -> float:
    """The host's time to issue one call of ``fn``, s (after a warm-up call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t


def captured(fn):
    """``fn`` captured in a CUDA graph (after a warm-up call): its replay runs
    the launches back to back, none issued by the host.  For the torch chains,
    whose thousands of launches outrun the card's launch queue."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--outer", type=int, default=OUTER)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_exp2 measures the CUDA card; none is available")
    x = torch.ones(ROWS, COLS, device="cuda")

    def kernel_run(variant):
        y = x
        for _ in range(args.outer):
            y = exp_chain(y, variant)
        return y

    def library_run(variant):
        y = x
        for _ in range(args.outer):
            y = library_chain(y, variant)
        return y

    clock = sm_clock_hz()
    issue = {v: host_s(lambda: kernel_run(v)) for v in VARIANTS}
    graphs = {v: captured(lambda: library_run(v)) for v in VARIANTS}
    timers = {"kernel": lambda v: device_ms(lambda: kernel_run(v), clock, issue[v]),
              "events": lambda v: events_ms(lambda: kernel_run(v)),
              "library": lambda v: events_ms(graphs[v].replay)}
    runs = [(v, k) for k in timers for v in VARIANTS]
    times = {run: [] for run in runs}
    for r in range(args.rounds):
        for v, k in (runs if r % 2 == 0 else runs[::-1]):
            times[(v, k)].append(timers[k](v))
    n = ROWS * COLS
    b = bound(n, INNER, args.outer, clock)
    print(f"# {torch.cuda.get_device_name(0)}; ({ROWS}, {COLS}) f32, {INNER} chained ops "
          f"x {args.outer} launches, {args.rounds} rounds in turns; device time (launches "
          f"queued behind a spin kernel); SFU bound at {clock / 1e6:.0f} MHz: "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    results = {"clock_hz": clock, **b}
    base = statistics.median(times[("exp", "kernel")])
    for v in VARIANTS:
        ms = statistics.median(times[(v, "kernel")])
        res = {"ms": ms, "gops": n * INNER * args.outer / ms / 1e6,
               "events_ms": statistics.median(times[(v, "events")]),
               "library_ms": statistics.median(times[(v, "library")])}
        results[v] = res
        print(f"  {v:14s} K6 {ms:8.4f} ms [{min(times[(v, 'kernel')]):.4f}-"
              f"{max(times[(v, 'kernel')]):.4f}]  {res['gops']:8.1f} Gop/s  vs exp "
              f"{base / ms:.3f}x  bound share {b['bound_ms'] / ms:.3f}  events "
              f"{res['events_ms']:.4f} ms  torch chain {res['library_ms']:.4f} ms", flush=True)
    return results


if __name__ == "__main__":
    main()
