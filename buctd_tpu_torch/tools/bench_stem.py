"""PreNet stem on one CUDA card: the canonical PreNet against its eval-time
fused form (models/fuse.py), then the full BUCTD-preNet-W48 forward both ways.

    python -m buctd_tpu_torch.tools.bench_stem [BATCHES ...] [--steps 5]
        [--rounds 3]

Counterpart of tools/bench_stem.py: the card's answer to whether
``TPU.FUSED_PRENET`` pays.  The model is the crowdpose preNet-W48 384x288 of
experiments/crowdpose/buctd/prenet_w48_384x288.yaml at full width and depth,
with N(0, 1/fan_in) weights and random BN statistics (models/hrnet.py::
random_init, seed 0), in f32 with TF32 off as the port serves it.  Each time
is the device time (CUDA events) of ``--steps`` forwards, the variants in
turns over ``--rounds`` rounds, the median printed in ms per forward; the
fused output is held against the canonical one (relative to its max).
"""

from __future__ import annotations

import argparse
import statistics
import types
from pathlib import Path

import torch

CONFIG = (Path(__file__).resolve().parents[2] / "experiments" / "crowdpose" / "buctd"
          / "prenet_w48_384x288.yaml")
STEPS = 5
ROUNDS = 3


def _timed(fn, x, steps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        fn(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def main(argv=None) -> dict:
    from ..config import default_config, update_config
    from ..models import get_model
    from ..models.fuse import maybe_fuse_prenet
    from ..models.hrnet import random_init

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batches", nargs="*", type=int, default=[32, 128])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_stem measures the CUDA card; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = default_config()
    update_config(cfg, types.SimpleNamespace(
        cfg=str(CONFIG), opts=["TPU.FUSED_PRENET", "auto"]))
    torch.manual_seed(0)
    model = get_model(cfg)                                     # device="cuda"
    random_init(model)
    fused = maybe_fuse_prenet(cfg, model)
    img_w, img_h = cfg.MODEL.IMAGE_SIZE
    print(f"# {torch.cuda.get_device_name(0)}; preNet-W48 {img_h}x{img_w}, f32, TF32 off; "
          f"ms per forward, median of {args.rounds} rounds of {args.steps}")
    runs = {
        "prenet": lambda x: model.rgb_preNet(x[:, :3]) + model.cond_preNet(x[:, 3:6]),
        "fused_prenet": lambda x: fused.prenet_fused(x[:, :3], x[:, 3:6]),
        "forward": model,
        "fused_forward": fused,
    }
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for batch in args.batches:
        x = torch.rand(batch, 6, img_h, img_w, generator=gen, device="cuda")
        with torch.inference_mode():
            ref, got = model(x), fused(x)
            gap = ((got - ref).abs().max() / ref.abs().max()).item()
            for fn in runs.values():                           # warm-up, cuDNN's choice
                fn(x)
            torch.cuda.synchronize()
            times = {k: [] for k in runs}
            for r in range(args.rounds):
                for k in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                    times[k].append(_timed(runs[k], x, args.steps))
        res = {f"{k}_ms": statistics.median(v) for k, v in times.items()}
        res["rel_gap"] = gap
        results[batch] = res
        print(f"b{batch:4d}: preNet {res['prenet_ms']:.4f} ms -> fused "
              f"{res['fused_prenet_ms']:.4f} ms ({res['prenet_ms'] / res['fused_prenet_ms']:.3f}x)"
              f" | W48 forward {res['forward_ms']:.4f} -> {res['fused_forward_ms']:.4f} ms "
              f"({batch * 1e3 / res['fused_forward_ms']:.1f} crops/s fused, "
              f"{(res['forward_ms'] / res['fused_forward_ms'] - 1) * 100:+.2f}%) | fused vs "
              f"canonical output: max |diff| / max {gap:.2e}", flush=True)
        del x, ref, got
        torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    main()
