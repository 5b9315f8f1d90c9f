"""f32 K1's 3xTF32 tensor-core kernel (csrc/flash_fwd_tf32.cuh, launched by
csrc/flash_fwd.cu) at the evaluation path's shapes against variants of its
launch choices, on one CUDA card.

    python -m buctd_tpu_torch.tools.bench_flash_fwd [--rounds 2] [--seed 3]

Each variant is csrc/flash_fwd_tf32.cuh and csrc/mma_tf32.cuh with one choice
changed, written beside a copy of csrc/flash_fwd.cu into
buctd_tpu_torch/_build/variants/fwd_<name>/ (git ignores it) and built there
with nvcc (tools/kernel_variants.py); ptxas's registers and spills of the f32
kernels are printed:

  shipped  the source as it is: 8 warps (128 query rows) a block share each
           K/V tile (64 keys below d = 96, 32 from there), split once a tile
           into shared memory, and below d = 96 two blocks an SM (128
           registers);
  one_sm   no register cap: one block an SM at d = 48;
  warps4   4 warps (64 rows) a block, as the bf16 kernel has;
  tiles32  32-key tiles at every d;
  cvtsplit every operand split by cvt.rna.tf32.f32 (mma_tf32.cuh's first
           split; the same values as the integer rounding shipped for
           finite operands);
  nanfree  the integer rounding without the fma that carries a NaN into lo
           (a NaN operand then reads as 0 or inf: what keeping NaN costs).

The forward is timed with CUDA events around 10 launches, the variants in
turns (the order reversed every other round) over ``--rounds`` rounds, at BH
64 and (L, d) = (6912, 48) and (1728, 96), f32, without dropout, on inputs
from a seeded generator.  Every variant's out and lse must match the shipped
kernel's within 2e-5, the f32 gate (another tile width sums in another
order).  Returns {(L, d): {variant: ms}}, medians.
"""

from __future__ import annotations

import argparse
import re
import statistics
import subprocess

import torch

from . import kernel_variants
from .kernel_variants import CVT_SPLIT, INT_SPLIT, NANFREE_SPLIT

SHAPES = [(64, 6912, 48), (64, 1728, 96)]
ROUNDS = 2
LAUNCHES = 10
HEADERS = ("flash_fwd_tf32.cuh", "mma_tf32.cuh")
# (header, old, new) source substitutions of each variant
VARIANTS = {
    "shipped": [],
    "one_sm": [("flash_fwd_tf32.cuh", "return D < 96 ? 2 : 1;", "return 1;")],
    "warps4": [("mma_tf32.cuh", "constexpr int kWarps = 8;", "constexpr int kWarps = 4;")],
    "tiles32": [("flash_fwd_tf32.cuh", "return D < 96 ? 64 : 32;", "return 32;")],
    "cvtsplit": [("mma_tf32.cuh", INT_SPLIT, CVT_SPLIT)],
    "nanfree": [("mma_tf32.cuh", INT_SPLIT, NANFREE_SPLIT)],
}


def variant_sources(name: str) -> dict:
    """The headers with the variant's substitutions, each of which must
    apply."""
    from .. import _build

    texts = {h: (_build.CSRC / h).read_text() for h in HEADERS}
    for header, old, new in VARIANTS[name]:
        if old not in texts[header]:
            raise RuntimeError(f"variant {name}: {old!r} is not in csrc/{header}")
        texts[header] = texts[header].replace(old, new)
    return texts


def register_summary(log: str) -> str:
    """'d48:128 d96:... ' for the two-stage f32 kernels in a ptxas -v log,
    with their spills."""
    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        if fn is None or "flash_fwd_tf32_kernel" not in fn or "Li2EE" not in fn:
            continue
        tag = "d" + re.search(r"ILi(\d+)E", fn).group(1)
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
        raise RuntimeError("bench_flash_fwd measures the CUDA card; none is available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build(["flash_fwd"])
    others = {f"fwd_{n}": variant_sources(n) for n in VARIANTS if n != "shipped"}
    built = kernel_variants.build("flash_fwd", others)
    libs = {"shipped": (None, _build.build_log("flash_fwd")),
            **{tag[len("fwd_"):]: lib for tag, lib in built.items()}}
    print(f"# {card}; f32 K1 at BH 64, {LAUNCHES} launches per timing, {args.rounds} "
          f"rounds in turns; ms (median)")
    for name, (_, log) in libs.items():
        print(f"# {name} registers: {register_summary(log)}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    results = {}
    for bh, l, d in SHAPES:
        q, k, v = (torch.randn(bh, l, d, device="cuda", generator=gen) for _ in range(3))
        scale = d ** -0.5
        times = {n: [] for n in libs}
        ref = None
        for r in range(args.rounds):
            for name in (list(libs) if r % 2 == 0 else list(libs)[::-1]):
                with kernel_variants.loaded("flash_fwd", libs[name][0]):
                    got = fa.flash_attention(q, k, v, scale)
                    times[name].append(kernel_variants.events_ms(
                        lambda: fa.flash_attention(q, k, v, scale), LAUNCHES))
                ref = got if ref is None else ref   # round 0 starts with shipped
                gap = max((a - b).abs().max().item() for a, b in zip(got, ref))
                if gap > 2e-5:
                    raise AssertionError(f"variant {name} differs from shipped by {gap}")
        results[(l, d)] = {n: statistics.median(t) for n, t in times.items()}
        print(f"({bh}, {l}, {d}): " + "; ".join(
            f"{n} {t:.4f}" for n, t in results[(l, d)].items()), flush=True)
        del q, k, v, ref, got
        torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    main()
