"""The port's tools.  Benchmarks on one CUDA card, counterparts of the JAX
package's tools/bench_block.py, tools/bench_exp2.py and tools/bench_stem.py:

    python -m buctd_tpu_torch.tools.bench_block [--fused] [--simt] [--dtype float32]
    python -m buctd_tpu_torch.tools.bench_exp2 [--rounds N]
    python -m buctd_tpu_torch.tools.bench_stem [BATCHES ...]

Each ``main(argv)`` returns its numbers as a dict (chip_smoke.py runs them in
reduced form) and raises where CUDA is absent: a measurement never falls back
to the CPU.  The user tools, counterparts of tools/inference.py,
tools/analysis.py, tools/vis.py and tools/parity_eval.py:

    python -m buctd_tpu_torch.tools.inference --cfg <yaml> --image <path> [--device cpu]
    python -m buctd_tpu_torch.tools.analysis {binned,rank,qualitative} --gt ... --dt ...
    python -m buctd_tpu_torch.tools.parity_eval --cfg <yaml> --pth <checkpoint>
        --ann <json> --img-dir <dir> [--refine-iters N] [--expected-ap X] [--device cpu]
"""
