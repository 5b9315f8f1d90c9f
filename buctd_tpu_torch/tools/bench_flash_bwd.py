"""K2's bf16 tensor-core kernels (csrc/flash_bwd_tc.cuh, launched by
csrc/flash_bwd.cu) at the training step's shapes against variants of their
launch choices, on one CUDA card.

    python -m buctd_tpu_torch.tools.bench_flash_bwd [--rounds 2] [--seed 3]

Each variant is csrc/flash_bwd_tc.cuh with one choice changed, written beside
a copy of csrc/flash_bwd.cu into buctd_tpu_torch/_build/variants/<name>/ (git
ignores it) and built there with nvcc (tools/kernel_variants.py); ptxas's
registers and spills of the bf16 kernels are printed for each:

  shipped  the source as it is: dk/dv held to 3 blocks a SM at d <= 48;
  no_cap   dk/dv keeps its registers at every d (2 blocks a SM at d = 48);
  cap4     both kernels held to 4 blocks a SM (128 registers) at every d;
  tiles32  32-wide looped tiles (keys for dq, q rows for dk/dv) at every d.

dq and dk/dv are timed with CUDA events around 10 launches, the variants in
turns (the order reversed every other round) over ``--rounds`` rounds, at BH
32 and (L, d) = (6912, 48) and (1728, 96), bf16, with dropout 0.1 and 0 (the
difference is the dropout hash's share), on inputs from a seeded generator.
Every variant's gradients must match the shipped kernels' within 1e-3.
Returns {(L, d): {dropout: {variant: {"dq_ms", "dkv_ms"}}}}, medians.
"""

from __future__ import annotations

import argparse
import re
import statistics
import subprocess

import torch

from . import kernel_variants

SHAPES = [(32, 6912, 48), (32, 1728, 96)]
DROPOUTS = (0.1, 0.0)
ROUNDS = 2
LAUNCHES = 10
# (old, new) source substitutions of each variant
_CAP = "constexpr int kDkvMinBlocks = D <= 48 ? 3 : 1;"
_DQ_BOUNDS = "__launch_bounds__(kThreads)\nflash_bwd_dq_tc_kernel("
VARIANTS = {
    "shipped": [],
    "no_cap": [(_CAP, "constexpr int kDkvMinBlocks = 1;")],
    "cap4": [(_CAP, "constexpr int kDkvMinBlocks = 4;"),
             (_DQ_BOUNDS, "__launch_bounds__(kThreads, 4)\nflash_bwd_dq_tc_kernel(")],
    "tiles32": [("return D <= 64 ? 64 : 32;", "return 32;")],
}


HEADER = "flash_bwd_tc.cuh"


def variant_source(name: str) -> str:
    """csrc/flash_bwd_tc.cuh with the variant's substitutions, each of which
    must apply."""
    from .. import _build

    text = (_build.CSRC / HEADER).read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} is not in csrc/{HEADER}")
        text = text.replace(old, new)
    return text


def register_summary(log: str) -> str:
    """'dq48:167 dkv48:168 ...' for the bf16 kernels in a ptxas -v log, with
    their spills."""
    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        if fn is None or "_tc_kernel" not in fn:
            continue
        tag = ("dq" if "dq_tc" in fn else "dkv") + re.search(r"ILi(\d+)E", fn).group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and m.group(1) != "0":
            out.append(f"{tag}:spills {m.group(1)} B")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{tag}:{m.group(1)}")
    return " ".join(out)


def main(argv=None) -> dict:
    from .. import _build
    from ..ops import flash_attention as fa

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_flash_bwd measures the CUDA card; none is available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build(["flash_bwd", "flash_fwd"])
    others = {n: {HEADER: variant_source(n)} for n in VARIANTS if n != "shipped"}
    libs = {"shipped": (None, _build.build_log("flash_bwd")),
            **kernel_variants.build("flash_bwd", others)}
    print(f"# {card}; K2 bf16 at BH 32, {LAUNCHES} launches per timing, {args.rounds} "
          f"rounds in turns; ms (median)")
    for name, (_, log) in libs.items():
        print(f"# {name} registers: {register_summary(log)}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    results = {}
    for bh, l, d in SHAPES:
        q, k, v = (torch.randn(bh, l, d, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        do = torch.randn(bh, l, d, device="cuda", generator=gen)
        scale = d ** -0.5
        results[(l, d)] = {}
        for p in DROPOUTS:
            out, lse = fa.flash_attention(q, k, v, scale, p, 7)
            delta = (do * out).sum(-1)
            call = (q, k, v, do, lse, delta, scale, p, 7)
            times = {n: {"dq_ms": [], "dkv_ms": []} for n in libs}
            ref = None
            for r in range(args.rounds):
                for name in (list(libs) if r % 2 == 0 else list(libs)[::-1]):
                    with kernel_variants.loaded("flash_bwd", libs[name][0]):
                        got = (fa.flash_bwd_dq(*call), *fa.flash_bwd_dkv(*call))
                        times[name]["dq_ms"].append(kernel_variants.events_ms(
                            lambda: fa.flash_bwd_dq(*call), LAUNCHES))
                        times[name]["dkv_ms"].append(kernel_variants.events_ms(
                            lambda: fa.flash_bwd_dkv(*call), LAUNCHES))
                    ref = got if ref is None else ref   # round 0 starts with shipped
                    gap = max((a - b).abs().max().item() for a, b in zip(got, ref))
                    if gap > 1e-3:
                        raise AssertionError(f"variant {name} differs from shipped by {gap}")
            res = {n: {key: statistics.median(ts) for key, ts in t.items()}
                   for n, t in times.items()}
            results[(l, d)][p] = res
            print(f"({bh}, {l}, {d}) dropout {p}: " + "; ".join(
                f"{n} dq {t['dq_ms']:.4f} dkv {t['dkv_ms']:.4f}" for n, t in res.items()),
                flush=True)
            del out, lse, delta, call
        del q, k, v, do
        torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    main()
