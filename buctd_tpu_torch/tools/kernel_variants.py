"""Variants of a kernel's source for the benchmarks that A/B its launch
choices (tools/bench_flash_fwd.py, tools/bench_flash_bwd.py) or its
arithmetic.

A variant is csrc/<lib>.cu with some of its headers, or the source itself,
rewritten.  The copies
are written into buctd_tpu_torch/_build/variants/<tag>/ (git ignores it) and
built there with nvcc, all at once; ``loaded`` makes the kernel wrappers
launch from a variant's library for a block of calls, and ``events_ms`` times
a call with CUDA events.
"""

from __future__ import annotations

import contextlib
import ctypes
import subprocess

import torch


# csrc/mma_tf32.cuh's split; by cvt.rna (the f32 kernels' first), for the
# cvtsplit variants of bench_block_variants.py, bench_flash_bwd.py and
# bench_flash_fwd.py; and by the integer rounding without the fma that
# carries a NaN into lo, for their nanfree variants (what keeping NaN costs)
INT_SPLIT = """  hi = rna(__float_as_uint(x));
  const float rest = x - __uint_as_float(hi);
  lo = __float_as_uint(__fmaf_rn(rest, 0.f, __uint_as_float(rna(__float_as_uint(rest)))));"""
CVT_SPLIT = """  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));
  hi &= 0xffffe000u;
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(rest));"""
NANFREE_SPLIT = """  hi = rna(__float_as_uint(x));
  lo = rna(__float_as_uint(x - __uint_as_float(hi)));"""


def substituted(header: str, subs, name: str) -> str:
    """csrc/<header> with the (old, new) substitutions of variant ``name``,
    each of which must apply."""
    from .. import _build

    text = (_build.CSRC / header).read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} is not in csrc/{header}")
        text = text.replace(old, new)
    return text


def build(lib: str, sources: dict) -> dict:
    """``sources`` {tag: {header: text}} -> {tag: (library path, nvcc's
    ptxas log)}, one nvcc per variant, all started together."""
    from .. import _build

    jobs = {}
    for tag, headers in sources.items():
        out = _build.BUILD_DIR / "variants" / tag
        out.mkdir(parents=True, exist_ok=True)
        # the quoted includes find the variant's headers beside <lib>.cu
        # first; the other headers come from csrc/
        for header, text in headers.items():
            (out / header).write_text(text)
        if f"{lib}.cu" not in headers:
            (out / f"{lib}.cu").write_text((_build.CSRC / f"{lib}.cu").read_text())
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(out / f"lib{lib}.so"), str(out / f"{lib}.cu")]
        jobs[tag] = (out / f"lib{lib}.so",
                     subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    built = {}
    for tag, (path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {tag}:\n{log}")
        built[tag] = (path, log)
    return built


@contextlib.contextmanager
def loaded(lib: str, lib_path):
    """The wrappers of csrc/<lib>.cu launch from ``lib_path`` (a variant's
    library; None: the package's own) inside the block, from the package's
    build again after it."""
    from .. import _build
    from ..ops import flash_attention as fa
    from ..ops import fused_block as fb
    from ..ops import warp as tw

    caches = (fa._fn, fb._fn, tw._warp_fn)
    shipped = _build.load(lib)
    _build._loaded[lib] = ctypes.CDLL(str(lib_path)) if lib_path else shipped
    for cache in caches:
        cache.cache_clear()
    try:
        yield
    finally:
        _build._loaded[lib] = shipped
        for cache in caches:
            cache.cache_clear()


def events_ms(fn, n: int) -> float:
    """Mean device time of ``fn()`` over ``n`` calls after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n
