"""One-command AP-parity runner: the published evaluation protocol from a
checkpoint, its AP beside the README table, and a PASS/FAIL verdict.

Counterpart of the repository's tools/parity_eval.py:

    python -m buctd_tpu_torch.tools.parity_eval --cfg <yaml> --pth <.pth|.pt|orbax dir>
        --ann <json> --img-dir <dir> [--refine-iters N] [--expected-ap X]
        [--out parity_out] [--device cuda]
        [--coordinator host:port --num-processes N --process-id R] [KEY VALUE ...]

The config is the yaml and its overrides, then the flags (the annotation
json, the image directory, the checkpoint as ``TEST.MODEL_FILE``, ``--out``
as ``OUTPUT_DIR``, ``--refine-iters`` as ``TEST.REFINE_ITERS``), then the
protocol's switches forced on: ``TEST.FLIP_TEST``, ``TEST.POST_PROCESS``,
``TEST.SHIFT_HEATMAP``.  The run is valid/run.py's ``evaluate`` under the
phase name "parity", with what tools/parity_eval.py does otherwise:

* the weights (``convert.py::load_checkpoint``: a ``.pth``/``.pt`` by its
  name, anything else an orbax directory) load into the cfg's model without
  a lambda head, strictly: a checkpoint with keys the model lacks (such as
  pose_hrnet's ``lambda_fc.*``) or without keys it has is refused;
* the preNet is never fused, whatever ``TPU.FUSED_PRENET`` says;
* every round evaluates through the host cv2 ``Loader``
  (data/pipeline.py), whatever ``TPU.DEVICE_PIPELINE`` says, with plain
  ``validate``: no ``TEST.LAMBDA_SWEEP``;
* the model runs in ``TPU.EVAL_DTYPE`` (bf16 under autocast, as valid/run.py).

``TEST.REFINE_ITERS`` rounds feed back as valid/run.py's: round ``it``
writes ``results/keypoints_test_results_epoch{it}.json``, the next round's
``TEST.COCO_BBOX_FILE`` (process i > 0 its own under ``proc{i}/``).  It
prints the refine trajectory (more than one round), the verdict table and,
unless no target is known, the ``# target:`` line and a last line of JSON
(``ap``, ``expected``, ``delta``, ``pass``, ``refine_trajectory``).  The
exit code is 0 on PASS and NO-TARGET, 1 on FAIL.

It runs on one CUDA card (``--device cuda``, the default; it raises where
CUDA is absent) or, with ``--device cpu``, on the plain kernels.  Several
cards take one process a card, with the process flags of valid/run.py.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..train.run import add_process_flags, start_processes

# the README table's rows keyed by (DATASET.DATASET, MODEL.NAME): (AP, note)
REFERENCE_AP = {
    ("coco", "pose_hrnet"): (77.8, "BUCTD-preNet-W48 384x288, PETR conditions "
                                   "(README.md:97)"),
    ("ochuman", "pose_hrnet_coam"): (49.0, "BUCTD-CoAM-W48 384x288, CID-W32 "
                                           "conditions, 3x refinement (val; "
                                           "README.md:104)"),
    ("crowdpose", "pose_hrnet_coam"): (78.5, "BUCTD-CoAM-W48 384x288, PETR "
                                             "conditions (test; README.md:111)"),
}
AP_TOLERANCE = 0.3  # BASELINE.json north star


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="AP parity vs reference checkpoints "
                                            "(PyTorch/CUDA)")
    p.add_argument("--cfg", required=True)
    p.add_argument("--pth", required=True,
                   help="reference torch checkpoint (.pth/.pt) or orbax dir")
    p.add_argument("--ann", required=True, help="annotation json with cond_kpts "
                   "(or a BU-prediction/pose-results json via TEST.COCO_BBOX_FILE)")
    p.add_argument("--img-dir", required=True)
    p.add_argument("--refine-iters", type=int, default=None,
                   help="override TEST.REFINE_ITERS (OCHuman protocol: 3)")
    p.add_argument("--expected-ap", type=float, default=None,
                   help="override the builtin README table target")
    p.add_argument("--out", default="parity_out")
    p.add_argument("--device", type=str, default="cuda")
    add_process_flags(p)
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def protocol_config(args):
    """The yaml and its overrides, the flags, then the published protocol's
    switches (the reference's scripts/test/*.sh pass them)."""
    from ..config import default_config, update_config

    cfg = default_config()
    update_config(cfg, args)
    cfg.defrost()
    cfg.DATASET.TEST_ANNOTATION_FILE = args.ann
    cfg.DATASET.TEST_IMAGE_DIR = args.img_dir
    cfg.TEST.MODEL_FILE = args.pth
    cfg.OUTPUT_DIR = args.out
    if args.refine_iters is not None:
        cfg.TEST.REFINE_ITERS = int(args.refine_iters)
    cfg.TEST.FLIP_TEST = True
    cfg.TEST.POST_PROCESS = True
    cfg.TEST.SHIFT_HEATMAP = True
    cfg.freeze()
    return cfg


def main(argv=None) -> tuple:
    """Run the protocol and print the verdict; returns (verdict, exit code).
    The verdict holds the last line's keys (``expected``, ``delta`` and
    ``pass`` None without a target), ``verdict`` (PASS, FAIL or NO-TARGET)
    and ``run``, valid/run.py's ``evaluate`` dict."""
    from ..core.function import check_eval_options
    from ..data.pipeline import Loader
    from ..parallel.mesh import make_mesh
    from ..valid.run import evaluate

    args = parse_args(argv)
    device = start_processes(args, "buctd_tpu_torch.tools.parity_eval")
    cfg = protocol_config(args)
    mesh = make_mesh(cfg, devices=[device])
    check_eval_options(cfg)
    run = evaluate(cfg, args.cfg, device, mesh, loader_cls=Loader, fuse_prenet=False,
                   lambda_options=False, phase="parity")
    trajectory = [float(ap) * 100.0 if ap <= 1.0 else float(ap) for ap in run["ap"]]

    key = (cfg.DATASET.DATASET, cfg.MODEL.NAME)
    expected, note = REFERENCE_AP.get(key, (None, "no README row for this "
                                                  "dataset/model pair"))
    if args.expected_ap is not None:
        expected, note = args.expected_ap, "user-provided target"

    ap = trajectory[-1]
    verdict = {"ap": ap, "expected": expected, "delta": None, "pass": None,
               "refine_trajectory": trajectory, "verdict": "NO-TARGET", "run": run}
    if len(trajectory) > 1:
        print("# refine trajectory: AP "
              + " -> ".join(f"{t:.2f}" for t in trajectory))
    print("\n| dataset | model | ours (AP) | reference (AP) | delta | verdict |")
    print("|---|---|---|---|---|---|")
    if expected is None:
        print(f"| {key[0]} | {key[1]} | {ap:.2f} | n/a | n/a | NO-TARGET |")
        print(f"# {note}")
        return verdict, 0
    delta = ap - expected
    ok = abs(delta) <= AP_TOLERANCE or delta > 0
    verdict.update({"delta": delta, "pass": bool(ok), "verdict": "PASS" if ok else "FAIL"})
    print(f"| {key[0]} | {key[1]} | {ap:.2f} | {expected:.1f} | {delta:+.2f} | "
          f"{verdict['verdict']} |")
    print(f"# target: {note}; tolerance {AP_TOLERANCE} AP (BASELINE.json)")
    print(json.dumps({k: verdict[k] for k in ("ap", "expected", "delta", "pass",
                                              "refine_trajectory")}), flush=True)
    return verdict, 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main()[1])
