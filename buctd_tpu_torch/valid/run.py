"""Evaluation entry point (the counterpart of tools/test.py), with the
in-process iterative refinement.

    python -m buctd_tpu_torch.valid.run --cfg <yaml> [--device cuda] [KEY VAL ...]

Same surface as the reference's tools/test.py: a YAML plus ``KEY value``
overrides.  It evaluates on one CUDA card (``--device cuda``, the default; it
raises where CUDA is absent; ``--device cpu`` runs the plain kernels) with the
device loader in test mode (``TPU.DEVICE_PIPELINE True``), the flip test and
``dataset.evaluate`` (rescoring, OKS-NMS, the results json, COCOeval).

Weights: ``TEST.MODEL_FILE`` (a BUCTD ``.pth``/``.pt``, loaded with
``strict=True``), else ``<output dir>/model_best.pth``, else the reference's
random init with a warning (tools/test.py:44-67); then the preNet fusion of
``TPU.FUSED_PRENET`` (models/fuse.py), as tools/test.py:87-88.

``TEST.REFINE_ITERS`` > 1 runs the 3x refinement loop in one process: round
``it`` writes ``results/keypoints_test_results_epoch{it}.json``, which becomes
the next round's ``TEST.COCO_BBOX_FILE`` (with ``TEST.USE_BU_BBOX True``), the
protocol the reference runs as three invocations; ``OUTPUT_JSON`` applies to
the last round only (tools/test.py:94-152).  ``TPU.EVAL_DTYPE bfloat16``
evaluates every round with the model under bf16 autocast and the decode on
its bf16 heatmaps (core/function.py::make_validate_step), as tools/test.py:85
builds its model in that dtype; the loader's inputs stay f32.  Not ported (see
``core/function.py::check_eval_options``): the lambda sweep, DEBUG dumps, the
host cv2 loader and a sharded eval set.
"""

from __future__ import annotations

import argparse
import logging

import torch

logger = logging.getLogger("buctd_tpu_torch.valid")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Test keypoints network (PyTorch/CUDA)")
    parser.add_argument("--cfg", required=True, type=str)
    parser.add_argument("--modelDir", type=str, default="")
    parser.add_argument("--logDir", type=str, default="")
    parser.add_argument("--dataDir", type=str, default="")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="Modify config options using the command-line")
    return parser.parse_args(argv)


def load_model(cfg, device, out_dir):
    """The cfg's model with TEST.MODEL_FILE's weights, else model_best.pth in
    the output directory, else the random init (with a warning)."""
    from ..convert import load_torch_checkpoint
    from ..models import get_model

    model = get_model(cfg, device=device)
    path = cfg.TEST.MODEL_FILE
    best = out_dir / "model_best.pth"
    if path and not path.endswith((".pth", ".pt")):
        raise NotImplementedError(f"TEST.MODEL_FILE {path!r}: buctd_tpu_torch loads "
                                  ".pth/.pt checkpoints only (orbax directories are "
                                  "ROADMAP Queue 1 item 7, 'Evaluation: the rest')")
    if path or best.exists():
        model.load_state_dict(load_torch_checkpoint(path or str(best)), strict=True)
        logger.info("=> weights from %s", path or best)
    else:
        logger.warning("=> no checkpoint found (TEST.MODEL_FILE empty, no %s); "
                       "evaluating randomly-initialized weights", best)
    return model.eval()


def main(argv=None) -> dict:
    """Evaluate; returns {'ap': [AP per round], 'rounds': [per-round dicts:
    AP, name_values, loop_s, evaluate_s, crops, results], 'output_dir',
    'model'}."""
    from ..config import default_config, update_config
    from ..core.function import check_eval_options, validate
    from ..data.datasets import get_dataset
    from ..data.device_pipeline import DeviceLoader
    from ..train.run import output_dir

    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("buctd_tpu_torch.valid.run: CUDA is not available; "
                           "pass --device cpu to evaluate on the CPU")
    cfg = default_config()
    update_config(cfg, args)
    check_eval_options(cfg)
    if device.type == "cuda":
        # f32 means f32 (the JAX path evaluates at Precision.HIGHEST); a bf16
        # model's convs and linears run in bf16 whatever these say
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out_dir = output_dir(cfg, args.cfg)
    model = load_model(cfg, device, out_dir)
    from ..models.fuse import maybe_fuse_prenet
    model = maybe_fuse_prenet(cfg, model)        # as tools/test.py:87-88

    refine_iters = max(int(cfg.TEST.REFINE_ITERS), 1)
    user_output_json = cfg.OUTPUT_JSON
    rounds = []
    for it in range(refine_iters):
        if refine_iters > 1:
            # intermediate rounds write the epoch-numbered results (the next
            # round reads them); OUTPUT_JSON applies to the last one
            cfg.defrost()
            cfg.OUTPUT_JSON = user_output_json if it == refine_iters - 1 else None
            cfg.freeze()
        dataset = get_dataset(cfg, is_train=False)
        loader = DeviceLoader(dataset, cfg, batch_size=cfg.TEST.BATCH_SIZE_PER_GPU,
                              num_workers=cfg.WORKERS, device=device)
        stats = {}
        try:
            name_values, perf = validate(cfg, loader, dataset, model, out_dir, epoch=it,
                                         print_prefix=f"refine{it}", stats=stats)
        finally:
            loader.close()
        results = cfg.OUTPUT_JSON or str(
            out_dir / "results" / f"keypoints_test_results_epoch{it}.json")
        logger.info("=> refinement round %d: AP %.4f", it, perf)
        rounds.append({"AP": perf, "name_values": name_values, "results": results,
                       **stats})
        if it < refine_iters - 1:
            cfg.defrost()
            cfg.TEST.COCO_BBOX_FILE = results
            cfg.TEST.USE_BU_BBOX = True
            cfg.freeze()
    return {"ap": [r["AP"] for r in rounds], "rounds": rounds, "output_dir": out_dir,
            "model": model}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)-15s %(message)s")
    main()
