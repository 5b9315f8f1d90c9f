"""K1's kernels (launched by csrc/flash_fwd.cu) at the serving, evaluation
and training paths' shapes against variants of their launch choices, on one
CUDA card.

    python -m buctd_tpu_torch.tools.bench_flash_fwd [--dtype float32|bfloat16]
        [--rounds 2] [--seed 3] [--only NAME ...]

Each variant is the kernel's headers with one choice changed, written beside
a copy of csrc/flash_fwd.cu into buctd_tpu_torch/_build/variants/fwd_<name>/
(git ignores it) and built there with nvcc (tools/kernel_variants.py);
ptxas's registers and spills of the kernels are printed for each.  ``--only``
names the variants to build besides the shipped source (none given: all).

f32 (csrc/flash_fwd_tf32.cuh and csrc/mma_tf32.cuh, 3xTF32), at BH 64 and
(L, d) = (6912, 48) and (1728, 96), without dropout:

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

Every f32 variant's out and lse must match the shipped kernel's within 2e-5,
the f32 gate (another tile width sums in another order).

bf16 (csrc/flash_fwd_wgmma.cuh: TMA loads, wgmma), at the six shapes of the
bf16 paths: CoAM-W48 serving (BH 16 at (6912, 48) and (1728, 96)) and
TransPose-H serving (BH 16 at (6912, 112)) at dropout 0, and the training
shapes (BH 32 at (6912, 48), (1728, 96) and (6912, 112)) at dropout 0.1:

  shipped  the source as it is: two consumer warpgroups taking turns at
           the tensor cores (kPingPong), 128-key tiles up to d = 64 and 96
           above (kWideKeyTile), q' read from shared memory from d = 64
           (kQSmemFrom) and from registers below, a two-stage K/V ring
           (kStages);
  solo     no turns: each warpgroup issues its products when ready;
  ring3    a three-stage ring (K1''s depth);
  keys64   64-key tiles above d = 64;
  keys128  128-key tiles above d = 64 (S, P and O spill);
  qregs    q' in registers at every d, with 64-key tiles above d = 64 (what
           fits there then);
  qsmem_all q' from shared memory at every d (d = 48 too).

Beside them, in the same turns, the mma.sync kernel that bf16 K1 ran before
(``flash_attention_mma``) and SDPA's bf16 forward with the same dropout (the
library yardstick), and for each shape the wgmma kernel's grid (blocks,
blocks an SM, waves on the card's SMs).  A bf16 variant that changes no
arithmetic (solo, ring3) must equal the shipped kernel bit for bit; the
others (another key tile rounds p at other running maxima) must lie within
4e-3 x max |out| of it (chip_smoke.py's K1_BF16_RTOL).

The forward is timed with CUDA events around 10 launches, the variants in
turns (the order reversed every other round) over ``--rounds`` rounds, on
inputs from a seeded generator.  Returns {shape: {variant: ms}}, medians.
"""

from __future__ import annotations

import argparse
import re
import statistics
import subprocess

import torch

from . import kernel_variants
from .kernel_variants import CVT_SPLIT, INT_SPLIT, NANFREE_SPLIT

ROUNDS = 2
LAUNCHES = 10
K1_BF16_RTOL = 4e-3
# (BH, L, d, dropout) of each dtype's timed shapes
SHAPES = {"float32": [(64, 6912, 48, 0.0), (64, 1728, 96, 0.0)],
          "bfloat16": [(16, 6912, 48, 0.0), (16, 1728, 96, 0.0), (16, 6912, 112, 0.0),
                       (32, 6912, 48, 0.1), (32, 1728, 96, 0.1), (32, 6912, 112, 0.1)]}
HEADERS = {"float32": ("flash_fwd_tf32.cuh", "mma_tf32.cuh"),
           "bfloat16": ("flash_fwd_wgmma.cuh",)}
_WG = "flash_fwd_wgmma.cuh"
# (header, old, new) source substitutions of each variant: f32, bf16
VARIANTS = {
    "shipped": [],
    "one_sm": [("flash_fwd_tf32.cuh", "return D < 96 ? 2 : 1;", "return 1;")],
    "warps4": [("mma_tf32.cuh", "constexpr int kWarps = 8;", "constexpr int kWarps = 4;")],
    "tiles32": [("flash_fwd_tf32.cuh", "return D < 96 ? 64 : 32;", "return 32;")],
    "cvtsplit": [("mma_tf32.cuh", INT_SPLIT, CVT_SPLIT)],
    "nanfree": [("mma_tf32.cuh", INT_SPLIT, NANFREE_SPLIT)],
}
BF16_VARIANTS = {
    "shipped": [],
    "solo": [(_WG, "constexpr bool kPingPong = true;", "constexpr bool kPingPong = false;")],
    "ring3": [(_WG, "constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "keys64": [(_WG, "constexpr int kWideKeyTile = 96;", "constexpr int kWideKeyTile = 64;")],
    "keys128": [(_WG, "constexpr int kWideKeyTile = 96;", "constexpr int kWideKeyTile = 128;")],
    "qregs": [(_WG, "constexpr int kQSmemFrom = 64;", "constexpr int kQSmemFrom = 256;"),
              (_WG, "constexpr int kWideKeyTile = 96;", "constexpr int kWideKeyTile = 64;")],
    "qsmem_all": [(_WG, "constexpr int kQSmemFrom = 64;", "constexpr int kQSmemFrom = 16;")],
}
DTYPE_VARIANTS = {"float32": VARIANTS, "bfloat16": BF16_VARIANTS}
# variants whose arithmetic is the shipped kernel's
SAME_BITS = {"solo", "ring3"}
# the kernels whose ptxas lines register_summary reads, by dtype
KERNELS = {"float32": "flash_fwd_tf32_kernel", "bfloat16": "flash_fwd_wgmma_kernel"}


def variant_sources(name: str, dtype: str = "float32") -> dict:
    """The headers with the variant's substitutions, each of which must
    apply."""
    from .. import _build

    texts = {h: (_build.CSRC / h).read_text() for h in HEADERS[dtype]}
    for header, old, new in DTYPE_VARIANTS[dtype][name]:
        if old not in texts[header]:
            raise RuntimeError(f"variant {name}: {old!r} is not in csrc/{header}")
        texts[header] = texts[header].replace(old, new)
    return texts


def register_summary(log: str, kernel: str = KERNELS["float32"]) -> str:
    """'d48:128 d96:... ' for the two-stage instantiations of ``kernel`` in a
    ptxas -v log (without dropout where it is a parameter), with their spills
    and, for the wgmma kernel, whether ptxas serialized its wgmma."""
    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        if fn is None or kernel not in fn or "Li2E" not in fn or "Lb1E" in fn:
            continue
        tag = "d" + re.search(r"ILi(\d+)E", fn).group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and m.group(1) != "0":
            out.append(f"{tag}:spills {m.group(1)} B")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{tag}:{m.group(1)}")
    for m in re.finditer(r"\((C75\d\d)\)[^']*'(\S+)'", log):
        if kernel in m.group(2) and "Li2E" in m.group(2) and "Lb1E" not in m.group(2):
            out.append(f"d{re.search(r'ILi(\d+)E', m.group(2)).group(1)}:serialized "
                       f"{m.group(1)}")
    return " ".join(out)


def main(argv=None) -> dict:
    from .. import _build
    from ..ops import flash_attention as fa

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=tuple(SHAPES), default="float32")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--only", nargs="*", help="variants to build besides the shipped source")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_flash_fwd measures the CUDA card; none is available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    dtype = getattr(torch, args.dtype)
    names = [n for n in DTYPE_VARIANTS[args.dtype] if n != "shipped"
             and (args.only is None or n in args.only)]
    _build.build(["flash_fwd"])
    built = kernel_variants.build(
        "flash_fwd", {f"fwd_{n}": variant_sources(n, args.dtype) for n in names})
    libs = {"shipped": (None, _build.build_log("flash_fwd")),
            **{tag[len("fwd_"):]: lib for tag, lib in built.items()}}
    print(f"# {card}; {args.dtype} K1 at {SHAPES[args.dtype]} (BH, L, d, dropout), "
          f"{LAUNCHES} launches per timing, {args.rounds} rounds in turns; ms (median)")
    for name, (_, log) in libs.items():
        print(f"# {name} registers: {register_summary(log, KERNELS[args.dtype])}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    results = {}
    for bh, l, d, p in SHAPES[args.dtype]:
        q, k, v = (torch.randn(bh, l, d, device="cuda", generator=gen).to(dtype)
                   for _ in range(3))
        scale = d ** -0.5
        runs = {n: (lambda lib=lib: (lib, fa.flash_attention)) for n, (lib, _) in libs.items()}
        if dtype == torch.bfloat16:
            q4, k4, v4 = q[:, None], k[:, None], v[:, None]

            def sdpa():
                with torch.no_grad():
                    return torch.nn.functional.scaled_dot_product_attention(
                        q4, k4, v4, dropout_p=p, scale=scale)

            runs["mma"] = lambda: (None, fa.flash_attention_mma)
            runs["sdpa"] = lambda: (None, None)
        times = {n: [] for n in runs}
        ref = None
        for r in range(args.rounds):
            for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                lib, fn = runs[name]()
                with kernel_variants.loaded("flash_fwd", lib):
                    if fn is None:
                        times[name].append(kernel_variants.events_ms(sdpa, LAUNCHES))
                        continue
                    got = fn(q, k, v, scale, p, 7)
                    times[name].append(kernel_variants.events_ms(
                        lambda: fn(q, k, v, scale, p, 7), LAUNCHES))
                if name == "shipped":
                    ref = got
                elif r == 0 and ref is not None:
                    check(dtype, name, got, ref)
        results[(bh, l, d, p)] = {n: statistics.median(t) for n, t in times.items()}
        grid = (f"; wgmma grid {fa.wgmma_waves(bh, l, d, p)}" if dtype == torch.bfloat16
                else "")
        print(f"({bh}, {l}, {d}) dropout {p}: " + "; ".join(
            f"{n} {t:.4f}" for n, t in results[(bh, l, d, p)].items()) + grid, flush=True)
        del q, k, v, ref, got
        torch.cuda.empty_cache()
    return results


def check(dtype, name: str, got, ref) -> None:
    """A variant (or the mma.sync kernel) against the shipped kernel: f32
    within 2e-5; bf16 bit for bit where the variant changes no arithmetic,
    else out within K1_BF16_RTOL x max |out| and lse at 2e-5."""
    if dtype == torch.float32 or name in SAME_BITS:
        gap = max((a - b).abs().max().item() for a, b in zip(got, ref))
        limit = 2e-5 if dtype == torch.float32 else 0.0
        if gap > limit:
            raise AssertionError(f"variant {name} differs from shipped by {gap}")
        return
    out_gap = (got[0] - ref[0]).abs().max().item() / ref[0].abs().max().item()
    lse_gap = (got[1] - ref[1]).abs().max().item()
    if out_gap > K1_BF16_RTOL or lse_gap > 2e-5 * (1 + ref[1].abs().max().item()):
        raise AssertionError(f"{name} differs from shipped: out {out_gap:.3e} of max, lse "
                             f"{lse_gap:.3e}")


if __name__ == "__main__":
    main()
