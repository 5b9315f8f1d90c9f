"""K4, the fused warp (csrc/warp_resample.cu::warp_fused_kernel), at the
training loader's shape against variants of its choices and against the
two-pass form it replaced, on one CUDA card.

    python -m buctd_tpu_torch.tools.bench_warp [--rounds 3] [--seed 1]
                                                [--only NAME ...]

Each variant is csrc/warp_resample.cu with one choice changed, written into
buctd_tpu_torch/_build/variants/warp_<name>/ (git ignores it) and built there
with nvcc (tools/kernel_variants.py); ptxas's registers and spills of the
fused kernels are printed:

  shipped    the source as it is: tiles of 32 output rows x 32 columns, 256
             threads, the source read through L1 where pass 1 needs it,
             untransposed with a warp's lanes along columns at one source row;
  tile16     tiles of 16 rows (twice the blocks, twice the halo a row);
  walk2      tiles of 64 rows, walked in two chunks of 32 (half the blocks,
             the sample's scalars computed once for both chunks);
  walk4      tiles of 128 rows in four chunks of 32;
  occ8       the fused kernel held to 32 registers (8 blocks an SM);
  bandrow    untransposed, lanes along columns at one band row (each lane in
             its own source row where the crop is rotated);
  ko_source  pass 1 reads no source pixel (each tap takes a value made from
             its address): what the source reads cost, and so the most that
             staging them (cp.async or TMA) could gain;
  two_pass   the two-pass form the fused kernel replaced (the shipped
             library's pass-1 and pass-2 kernels, f32 only).

Inputs are chip_smoke.py's draw: WARP_BATCH (32, 512, 640, 3) -> (384, 288),
rotations -90..90 (both decompositions), scales 0.6-1.8, f32 0..255 noise; and
the loaders' input, a uint8 bucket with mask rectangles.  Each is timed with
CUDA events around 20 launches, the variants in turns (the order reversed
every other round) over ``--rounds`` rounds.  Every variant but ko_source must
equal the shipped kernel bit for bit.  Returns {variant: {"f32": ms, "uint8":
ms}} (medians; two_pass has no uint8 time) and "card".
"""

from __future__ import annotations

import argparse
import re
import statistics
import subprocess

import torch

from . import kernel_variants

ROUNDS = 3
LAUNCHES = 20
SOURCE = "warp_resample.cu"
LOAD = "dst[ch] = tent_sum(t, q0 ? (float)q0[ch] : 0.f, q1 ? (float)q1[ch] : 0.f);"
NO_LOAD = ("dst[ch] = tent_sum(t, q0 ? (float)(((size_t)q0 >> 2) & 255) : 0.f, "
           "q1 ? (float)(((size_t)q1 >> 2) & 255) : 0.f);")
# the untransposed fill: the shipped one, and one with lanes at one band row
ROW_FILL = """      for (int r = span[0] + warp; r < span[1]; r += kWarps)
        if ((unsigned)(r - lo) < (unsigned)n)
          s.pass1(p, r, ao, band + lane * stride + (r - lo) * C);"""
BAND_ROW_FILL = """      for (int j = warp; j < n; j += kWarps)
        s.pass1(p, lo + j, ao, band + lane * stride + j * C);"""
CHUNK = "if (q >= (float)(kTileY - 1)) return kTileY;"
# (old, new) substitutions of csrc/warp_resample.cu for each variant
VARIANTS = {
    "shipped": [],
    "tile16": [("constexpr int kTileY = 32;", "constexpr int kTileY = 16;")],
    "walk2": [("constexpr int kTileY = 32;", "constexpr int kTileY = 64;"),
              (CHUNK, "if (q >= 31.f) return 32;")],
    "walk4": [("constexpr int kTileY = 32;", "constexpr int kTileY = 128;"),
              (CHUNK, "if (q >= 31.f) return 32;")],
    "occ8": [("__global__ void __launch_bounds__(kFusedThreads)\nwarp_fused_kernel",
              "__global__ void __launch_bounds__(kFusedThreads, 8)\nwarp_fused_kernel")],
    "bandrow": [(ROW_FILL, BAND_ROW_FILL)],
    "ko_source": [(LOAD, NO_LOAD)],
}


def register_summary(log: str) -> str:
    """ptxas's registers and spills of each fused-kernel instantiation."""
    out = []
    for m in re.finditer(r"warp_fused_kernelI(\w)Li(\d)E.*?Used (\d+) registers", log, re.S):
        elt = "u8+mask" if m.group(1) == "h" else "f32"
        out.append(f"{elt} C{m.group(2) if m.group(2) != '0' else '(run time)'}: {m.group(3)}")
    spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)))
    return f"{', '.join(out)} registers; spill stores {'/'.join(spills) or '0'} B"


def main(argv=None) -> dict:
    from .. import _build
    from ..geometry import make_affine
    from ..ops import warp as tw

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--only", nargs="*", default=None,
                    help="variants to build besides shipped and two_pass")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_warp measures the CUDA card; none is available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build(["warp_resample"])
    names = [n for n in VARIANTS if n != "shipped" and (args.only is None or n in args.only)]
    built = kernel_variants.build("warp_resample", {
        f"warp_{n}": {SOURCE: kernel_variants.substituted(SOURCE, VARIANTS[n], n)}
        for n in names})
    libs = {"shipped": (None, _build.build_log("warp_resample")),
            **{tag[len("warp_"):]: lib for tag, lib in built.items()}}
    print(f"# {card}; K4 at (32, 512, 640, 3) -> (384, 288), {LAUNCHES} launches per "
          f"timing, {args.rounds} rounds in turns; ms (median)")
    for name, (_, log) in libs.items():
        print(f"# {name}: {register_summary(log)}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    B, H, W, out_hw = 32, 512, 640, (384, 288)
    images = torch.rand(B, H, W, 3, device="cuda", generator=gen) * 255.0
    centers = torch.rand(B, 2, device="cuda", generator=gen) * torch.tensor(
        [440.0, 280.0], device="cuda") + 100.0
    scales = torch.rand(B, 2, device="cuda", generator=gen) * 1.2 + 0.6
    rots = torch.rand(B, device="cuda", generator=gen) * 180.0 - 90.0
    trans = make_affine(centers, scales, rots, out_hw[::-1], inv=True).contiguous()
    u8 = torch.randint(0, 256, (B, H, W, 3), dtype=torch.uint8, device="cuda", generator=gen)
    boxes = torch.cat([torch.rand(B, 2, device="cuda", generator=gen) * 300.0,
                       torch.rand(B, 2, device="cuda", generator=gen) * 300.0 + 40.0],
                      1).contiguous()
    calls = {"f32": lambda: tw.warp_resample(images, trans, out_hw),
             "uint8": lambda: tw.warp_resample(u8, trans, out_hw, boxes)}
    ref = {k: f() for k, f in calls.items()}
    rows = list(libs) + ["two_pass"]
    times = {n: {"f32": [], "uint8": []} for n in rows}
    for r in range(args.rounds):
        for name in (rows if r % 2 == 0 else rows[::-1]):
            if name == "two_pass":
                times[name]["f32"].append(kernel_variants.events_ms(
                    lambda: tw.warp_resample_two_pass(images, trans, out_hw), LAUNCHES))
                continue
            with kernel_variants.loaded("warp_resample", libs[name][0]):
                for kind, fn in calls.items():
                    got = fn()
                    if name != "ko_source" and not torch.equal(
                            got.view(torch.int32), ref[kind].view(torch.int32)):
                        raise AssertionError(f"variant {name} ({kind}) differs from shipped")
                    times[name][kind].append(kernel_variants.events_ms(fn, LAUNCHES))
    results = {n: {k: statistics.median(t) for k, t in kinds.items() if t}
               for n, kinds in times.items()}
    for name, res in results.items():
        print(f"{name:10s} " + "  ".join(f"{k} {v:.4f}" for k, v in res.items()), flush=True)
    results["card"] = card
    return results


if __name__ == "__main__":
    main()
