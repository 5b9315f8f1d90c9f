"""K2's kernels (launched by csrc/flash_bwd.cu) at the training steps' shapes
against variants of their design choices, on one CUDA card; beside them, in
the same turns, SDPA's backward alone (dq, dk and dv from a saved
``F.scaled_dot_product_attention`` forward with the same dropout: the
library yardstick of dq + dk/dv) and, in f32, the SIMT kernels.

    python -m buctd_tpu_torch.tools.bench_flash_bwd [--dtype bfloat16|float32]
        [--rounds 2] [--seed 3] [--only NAME ...]

Each variant is a kernel header with one choice changed, written beside a
copy of csrc/flash_bwd.cu into buctd_tpu_torch/_build/variants/<name>/ (git
ignores it) and built there with nvcc (tools/kernel_variants.py); ptxas's
registers and spills of the kernels are printed for each, and where ptxas
serialized a kernel's wgmma (its C7512, C7515).  bf16, the TMA + wgmma
kernels (csrc/flash_bwd_wgmma.cuh), which the bf16 paths run:

  shipped    the source as it is: two consumer warpgroups, dq's 64-key
             tiles, dk/dv's 64-row q tiles up to d = 64 and 32 above, two
             helper warps, a three-stage ring, S and G committed as two
             groups;
  ring4      a four-stage ring (K2''s depth);
  one_wg     one consumer warpgroup a block (64 rows);
  no_overlap S and G waited for together;
  bk96       96-key tiles in dq;
  bq32       32-row q tiles in dk/dv at every d;
  bq64       64-row q tiles in dk/dv at every d;
  bq16       16-row q tiles in dk/dv above d = 64;
  helper1    one helper warp in dk/dv;

the mma.sync kernels (csrc/flash_bwd_tc.cuh), the bf16 backward before
them, timed through ``flash_bwd_dq_mma`` and ``flash_bwd_dkv_mma``: ``mma``
the source as it is (dk/dv held to 3 blocks a SM at d <= 48), and its
variants

  no_cap   dk/dv keeps its registers at every d (2 blocks a SM at d = 48);
  cap4     both kernels held to 4 blocks a SM (128 registers) at every d;
  tiles32  32-wide looped tiles (keys for dq, q rows for dk/dv) at every d.

f32 (3xTF32), the TMA + wgmma kernels (csrc/flash_bwd_tf32_wgmma.cuh),
which the f32 paths run:

  shipped     the source as it is: the plans (consumer warpgroups, looped
              tile) of flash_bwd_tf32_wgmma.cuh, four split warps in dq and
              six in dk/dv, a two-stage ring, each tile product waited for
              at once, the own operands' addresses opaque at every looped
              tile;
  overlap     dq's tile product in flight across the next tile's s and g,
              folded once g is done (its slot freed then);
  stale_desc  the own operands' addresses left to the compiler (it keeps
              their descriptors live across the loop);
  split3      three split warps in each kernel;
  dq_split8   eight in dq;
  dkv_split4  four in dk/dv;
  ring3       a three-stage ring (K2''s depth; where it does not fit, the
              plan takes a narrower tile or one consumer warpgroup);

the mma.sync kernels (csrc/flash_bwd_tf32.cuh), the f32 backward before
them, timed through ``flash_bwd_dq_mma`` and ``flash_bwd_dkv_mma``: ``mma``
the source as it is (dq's own operands, q' and do, as register fragments,
split once, at d <= 48; dk/dv's, K and V, read from shared memory and split
each looped tile), and its variants

  smem_a   dq's read from shared memory too, at every d;
  cvtsplit every operand split by cvt.rna.tf32.f32 (csrc/mma_tf32.cuh's first
           split; the same values as the integer rounding shipped for
           finite operands);
  nanfree  the integer rounding without the fma that carries a NaN into lo
           (a NaN operand then reads as 0 or inf: what keeping NaN costs);

beside them the SIMT kernels that f32 ran before (``flash_bwd_dq_simt``,
``flash_bwd_dkv_simt``) and SDPA's f32 backward with TF32 off.  ``--only``
names the variants to build besides the shipped source (``--only`` alone:
none, the shipped source and the mma.sync kernels; without it: all).

dq and dk/dv are timed with CUDA events around 10 launches, the variants in
turns (the order reversed every other round) over ``--rounds`` rounds, at BH
32 and the (L, d) of SHAPES, with dropout 0.1 and 0 (the difference is the
dropout hash's share), on inputs from a seeded generator.  A bf16 variant
that changes no arithmetic (SAME_BITS) must equal the shipped kernels bit for
bit; the others, and the mma.sync kernels, within K2_BF16_RTOL x max |grad|
of them (other tiles sum in another order); f32 variants and the SIMT kernels
within 1e-3.  The wgmma kernels' grids (blocks, blocks an SM, waves) are
printed for each shape.  The card's name and power limit head the output.  Returns {(L, d): {dropout: {impl: {"dq_ms",
"dkv_ms"}, "sdpa_ms": ms}}}, medians.
"""

from __future__ import annotations

import argparse
import re
import statistics
import subprocess

import torch

from . import kernel_variants
from .kernel_variants import CVT_SPLIT, INT_SPLIT, NANFREE_SPLIT, substituted

# (BH, L, d): CoAM-W48's two calls and TransPose-H's, in both dtypes
SHAPES = {"bfloat16": [(32, 6912, 48), (32, 1728, 96), (32, 6912, 112)],
          "float32": [(32, 6912, 48), (32, 1728, 96), (32, 6912, 112)]}
DROPOUTS = (0.1, 0.0)
ROUNDS = 2
LAUNCHES = 10
K2_BF16_RTOL = 2e-3   # chip_smoke.py's
_TC, _WG, _TW = "flash_bwd_tc.cuh", "flash_bwd_wgmma.cuh", "flash_bwd_tf32_wgmma.cuh"
# (old, new) source substitutions of each variant: the mma.sync kernels'
_CAP = "constexpr int kDkvMinBlocks = D <= 48 ? 3 : 1;"
_DQ_BOUNDS = "__launch_bounds__(kThreads)\nflash_bwd_dq_tc_kernel("
VARIANTS = {
    "shipped": [],
    "no_cap": [(_CAP, "constexpr int kDkvMinBlocks = 1;")],
    "cap4": [(_CAP, "constexpr int kDkvMinBlocks = 4;"),
             (_DQ_BOUNDS, "__launch_bounds__(kThreads, 4)\nflash_bwd_dq_tc_kernel(")],
    "tiles32": [("return D <= 64 ? 64 : 32;", "return 32;")],
}
# the wgmma kernels'
WGMMA_VARIANTS = {
    "ring4": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    "one_wg": [("constexpr int kConsumers = 2;", "constexpr int kConsumers = 1;")],
    "no_overlap": [("constexpr bool kOverlap = true;", "constexpr bool kOverlap = false;")],
    "bk96": [("constexpr int kDqKeyTile = 64;", "constexpr int kDqKeyTile = 96;")],
    "bq32": [("constexpr int kDkvNarrowTile = 64;", "constexpr int kDkvNarrowTile = 32;")],
    "bq64": [("constexpr int kDkvWideTile = 32;", "constexpr int kDkvWideTile = 64;")],
    "bq16": [("constexpr int kDkvWideTile = 32;", "constexpr int kDkvWideTile = 16;")],
    "helper1": [("constexpr int kHelpers = 64;", "constexpr int kHelpers = 32;")],
}
# wgmma variants whose arithmetic is the shipped kernels'
SAME_BITS = {"ring4", "one_wg", "no_overlap", "helper1"}
# the f32 wgmma kernels'
F32_WGMMA_VARIANTS = {
    "overlap": [("constexpr bool kDqOverlap = false;", "constexpr bool kDqOverlap = true;")],
    "stale_desc": [("constexpr bool kFreshDescriptors = true;",
                    "constexpr bool kFreshDescriptors = false;")],
    "split3": [("constexpr int kDqSplitWarps = 4;", "constexpr int kDqSplitWarps = 3;"),
               ("constexpr int kDkvSplitWarps = 6;", "constexpr int kDkvSplitWarps = 3;")],
    "dq_split8": [("constexpr int kDqSplitWarps = 4;", "constexpr int kDqSplitWarps = 8;")],
    "dkv_split4": [("constexpr int kDkvSplitWarps = 6;", "constexpr int kDkvSplitWarps = 4;")],
    "ring3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
}
# the f32 mma.sync kernels'
F32_VARIANTS = {
    "shipped": [],
    "smem_a": [("constexpr bool bwd_reg_a() { return D <= 48; }",
                "constexpr bool bwd_reg_a() { return false; }")],
    "cvtsplit": {"mma_tf32.cuh": [(INT_SPLIT, CVT_SPLIT)]},
    "nanfree": {"mma_tf32.cuh": [(INT_SPLIT, NANFREE_SPLIT)]},
}
# each dtype's kernel header, variants and kernels (by a part of their name)
DTYPES = {"bfloat16": (_TC, {**VARIANTS, **WGMMA_VARIANTS}, ("_wgmma_kernel", "_tc_kernel")),
          "float32": ("flash_bwd_tf32.cuh", {**F32_VARIANTS, **F32_WGMMA_VARIANTS},
                      ("_tf32_wgmma_kernel", "_tf32_kernel"))}


def variant_sources(name: str, dtype: str = "bfloat16") -> dict:
    """{header: text} of a variant: its substitutions in the header they
    apply to (a wgmma variant's in flash_bwd_wgmma.cuh or, f32,
    flash_bwd_tf32_wgmma.cuh; any other bf16 variant's in flash_bwd_tc.cuh;
    any other f32 variant's in flash_bwd_tf32.cuh or in the headers it
    names, a dict of them, with the kernel header unchanged beside them)."""
    header, variants, _ = DTYPES[dtype]
    subs = variants[name]
    if name in WGMMA_VARIANTS and dtype == "bfloat16":
        return {_WG: substituted(_WG, subs, name)}
    if name in F32_WGMMA_VARIANTS and dtype == "float32":
        return {_TW: substituted(_TW, subs, name)}
    if isinstance(subs, dict):
        # the kernel header goes beside the changed ones unchanged: its quoted
        # includes then find them in the variant's directory, not in csrc/
        return {header: substituted(header, [], name),
                **{h: substituted(h, s, name) for h, s in subs.items()}}
    return {header: substituted(header, subs, name)}


def variant_source(name: str, dtype: str = "bfloat16") -> str:
    """The dtype's mma.sync kernel header with the variant's substitutions,
    each of which must apply."""
    return variant_sources(name, dtype)[DTYPES[dtype][0]]


def register_summary(log: str, kinds=("_wgmma_kernel", "_tc_kernel")) -> str:
    """'wg_dq48:168 wg_dkv48p:168 dq48:167 ...' for the kernels whose name
    holds one of ``kinds`` in a ptxas -v log of one ring depth ("wg_": the wgmma
    kernels; "p": the dropout instantiation, where it is a template
    parameter), with their spills and the kernels whose wgmma ptxas
    serialized."""
    if isinstance(kinds, str):
        kinds = (kinds,)

    def tag(fn):
        m = re.search(r"ILi(\d+)ELi(\d+)E(Lb1E)?", fn)
        if m is None:
            return None
        return (("wg_" if "_wgmma_" in fn else "") + ("dq" if "_dq_" in fn else "dkv") +
                m.group(1) + ("p" if m.group(3) else ""))

    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        if fn is None or not any(k in fn for k in kinds) or tag(fn) is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and m.group(1) != "0":
            out.append(f"{tag(fn)}:spills {m.group(1)} B")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{tag(fn)}:{m.group(1)}")
    for m in re.finditer(r"\((C75\d\d)\)[^']*'(\S+)'", log):
        if any(k in m.group(2) for k in kinds) and tag(m.group(2)) is not None:
            out.append(f"{tag(m.group(2))}:serialized {m.group(1)}")
    return " ".join(out)


def sdpa_backward(q, k, v, do, scale: float, p: float):
    """A call of SDPA's backward alone: dq, dk, dv from a saved forward of
    F.scaled_dot_product_attention with dropout p (one head a batch row)."""
    q4, k4, v4 = (x[:, None].detach().clone().requires_grad_() for x in (q, k, v))
    out4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, dropout_p=p,
                                                            scale=scale)
    do4 = do[:, None].to(q.dtype)
    return lambda: torch.autograd.grad(out4, (q4, k4, v4), do4, retain_graph=True)


def check(name: str, got, ref, f32: bool) -> None:
    """A variant (or another kernel) against the shipped kernels' gradients."""
    if f32:
        gap = max((a - b).abs().max().item() for a, b in zip(got, ref))
        if gap > 1e-3:
            raise AssertionError(f"{name} differs from shipped by {gap}")
        return
    if name in SAME_BITS:
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"{name} changes no arithmetic but differs from shipped")
        return
    rel = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, ref))
    if rel > K2_BF16_RTOL:
        raise AssertionError(f"{name} differs from shipped by {rel:.3e} of max |grad|")


def main(argv=None) -> dict:
    from .. import _build
    from ..ops import flash_attention as fa

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="bfloat16")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--only", nargs="*", help="variants to build besides the shipped source")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_flash_bwd measures the CUDA card; none is available")
    _, variants, kinds = DTYPES[args.dtype]
    if args.only is not None and set(args.only) - set(variants):
        raise ValueError(f"unknown {args.dtype} variants {sorted(set(args.only) - set(variants))}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build(["flash_bwd", "flash_fwd"])
    others = {n: variant_sources(n, args.dtype) for n in variants
              if n != "shipped" and (args.only is None or n in args.only)}
    built = kernel_variants.build("flash_bwd", others)
    dtype = getattr(torch, args.dtype)
    f32 = dtype == torch.float32
    # impl: (library, dq wrapper, dk/dv wrapper)
    impls = {"shipped": (None, fa.flash_bwd_dq, fa.flash_bwd_dkv),
             "mma": (None, fa.flash_bwd_dq_mma, fa.flash_bwd_dkv_mma)}
    if f32:
        impls["simt"] = (None, fa.flash_bwd_dq_simt, fa.flash_bwd_dkv_simt)
    for name, (path, _) in built.items():
        wgmma = name in (F32_WGMMA_VARIANTS if f32 else WGMMA_VARIANTS)
        impls[name if wgmma else f"mma_{name}"] = (
            path, fa.flash_bwd_dq if wgmma else fa.flash_bwd_dq_mma,
            fa.flash_bwd_dkv if wgmma else fa.flash_bwd_dkv_mma)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"# {card}; K2 {args.dtype} at {SHAPES[args.dtype]} (BH, L, d), {LAUNCHES} launches "
          f"per timing, {args.rounds} rounds in turns; ms (median)")
    for name, (_, log) in {"shipped": (None, _build.build_log("flash_bwd")),
                           **built}.items():
        print(f"# {name} registers: {register_summary(log, kinds)}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    results = {}
    try:
        for bh, l, d in SHAPES[args.dtype]:
            q, k, v = (torch.randn(bh, l, d, device="cuda", generator=gen).to(dtype)
                       for _ in range(3))
            do = torch.randn(bh, l, d, device="cuda", generator=gen)
            scale = d ** -0.5
            results[(l, d)] = {}
            for p in DROPOUTS:
                out, lse = fa.flash_attention(q, k, v, scale, p, 7)
                delta = (do * out).sum(-1)
                call = (q, k, v, do, lse, delta, scale, p, 7)
                sdpa, sdpa_ms = sdpa_backward(q, k, v, do, scale, p), []
                times = {n: {"dq_ms": [], "dkv_ms": []} for n in impls}
                ref = None
                for r in range(args.rounds):
                    for name in (list(impls) if r % 2 == 0 else list(impls)[::-1]):
                        path, dq_fn, dkv_fn = impls[name]
                        with kernel_variants.loaded("flash_bwd", path):
                            got = (dq_fn(*call), *dkv_fn(*call))
                            times[name]["dq_ms"].append(kernel_variants.events_ms(
                                lambda: dq_fn(*call), LAUNCHES))
                            times[name]["dkv_ms"].append(kernel_variants.events_ms(
                                lambda: dkv_fn(*call), LAUNCHES))
                        if name == "shipped":
                            ref = got
                        elif r == 0 and ref is not None:
                            check(name, got, ref, f32)
                    sdpa_ms.append(kernel_variants.events_ms(sdpa, LAUNCHES))
                res = {n: {key: statistics.median(ts) for key, ts in t.items()}
                       for n, t in times.items()}
                res["sdpa_ms"] = statistics.median(sdpa_ms)
                text = "; ".join(f"{n} dq {t['dq_ms']:.4f} dkv {t['dkv_ms']:.4f}"
                                 for n, t in res.items() if n != "sdpa_ms")
                text += f"; SDPA {args.dtype} backward alone {res['sdpa_ms']:.4f}"
                grids = fa.wgmma_bwd_waves(bh, l, d, p, f32=f32)
                text += "; wgmma grids " + ", ".join(
                    f"{kind} {g['blocks']} blocks, {g['blocks_per_sm']} an SM, "
                    f"{g['waves']:.2f} waves, {g['tile']}-row tiles" for kind, g in grids.items())
                results[(l, d)][p] = res
                print(f"({bh}, {l}, {d}) dropout {p}: {text}", flush=True)
                del out, lse, delta, call, sdpa, ref, got
            del q, k, v, do
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return results


if __name__ == "__main__":
    main()
