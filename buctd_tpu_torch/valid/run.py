"""Evaluation entry point (the counterpart of tools/test.py), with the
in-process iterative refinement.

    python -m buctd_tpu_torch.valid.run --cfg <yaml> [--device cuda] [KEY VAL ...]

Same surface as the reference's tools/test.py: a YAML plus ``KEY value``
overrides.  It evaluates on one CUDA card (``--device cuda``, the default; it
raises where CUDA is absent; ``--device cpu`` runs the plain kernels) with the
loader tools/test.py:109-118 picks: the host cv2 ``Loader``
(``TPU.DEVICE_PIPELINE False``, the default and every stock yaml's) or the
device loader (``TPU.DEVICE_PIPELINE True``), then the flip test and
``dataset.evaluate`` (rescoring, OKS-NMS, the results json, COCOeval).  As
tools/test.py, it logs under ``<OUTPUT_DIR>/<dataset>/<model>/<yaml stem>``
(utils/logging_utils.py), writes the validation's metrics to
``metrics.jsonl`` in the tensorboard directory, logs the model summary
(utils/summary.py) and, with ``BUCTD_PROFILE_DIR`` set, writes a Chrome
trace of each evaluation round there (utils/profiler.py).

Weights: ``TEST.MODEL_FILE`` (a BUCTD ``.pth``/``.pt``, or an orbax
directory of JAX's ``save_params``; loaded with ``strict=True``), else ``<output dir>/model_best.pth``, else the reference's
random init with a warning (tools/test.py:44-67); then the preNet fusion of
``TPU.FUSED_PRENET`` (models/fuse.py), as tools/test.py:87-88.

``TEST.REFINE_ITERS`` > 1 runs the 3x refinement loop in one process: round
``it`` writes ``results/keypoints_test_results_epoch{it}.json``, which becomes
the next round's ``TEST.COCO_BBOX_FILE`` (with ``TEST.USE_BU_BBOX True``), the
protocol the reference runs as three invocations; ``OUTPUT_JSON`` applies to
the last round only (tools/test.py:94-152).  ``TPU.EVAL_DTYPE bfloat16``
evaluates every round with the model under bf16 autocast and the decode on
its bf16 heatmaps (core/function.py::make_validate_step), as tools/test.py:85
builds its model in that dtype; the loader's inputs stay f32.
``TEST.LAMBDA_SWEEP`` evaluates each round with
``core/function.py::validate_lambda_quantitative`` (lambda 0 and 1, their
``_l0``/``_l1`` results and the ``_merged`` one); it cannot feed a refinement
round, so with ``TEST.REFINE_ITERS`` > 1 it raises, as tools/test.py:95-98.
A checkpoint with pose_hrnet's lambda head (``lambda_fc.*``) builds the
model with it.  ``DEBUG.DEBUG`` writes utils/vis.py's debug images beside the
results.

Several cards, one process a card, as tools/test.py:75-133: the flags
``--coordinator host:port --num-processes N --process-id R`` (or
``torchrun``'s environment) join the processes before any CUDA work
(train/run.py::start_processes); the mesh (``TPU.MESH_SHAPE``) must match
the cards; the loaders take ``TEST.BATCH_SIZE_PER_GPU x mesh.size`` and
serve each process its shard; the weights are broadcast from process 0;
``validate`` merges every process's rows and each process evaluates the
whole set, process i > 0 under ``<output dir>/proc{i}``, whose results the
next refinement round of that process reads.
"""

from __future__ import annotations

import argparse
import logging
import pprint
from pathlib import Path

import torch

from ..train.run import add_process_flags, start_processes
from ..utils import distributed

logger = logging.getLogger("buctd_tpu_torch.valid")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Test keypoints network (PyTorch/CUDA)")
    parser.add_argument("--cfg", required=True, type=str)
    parser.add_argument("--modelDir", type=str, default="")
    parser.add_argument("--logDir", type=str, default="")
    parser.add_argument("--dataDir", type=str, default="")
    parser.add_argument("--device", type=str, default="cuda")
    add_process_flags(parser)
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="Modify config options using the command-line")
    return parser.parse_args(argv)


def load_model(cfg, device, out_dir):
    """The cfg's model with TEST.MODEL_FILE's weights, else model_best.pth in
    the output directory, else the random init (with a warning)."""
    from ..convert import load_checkpoint
    from ..models import get_model

    path = cfg.TEST.MODEL_FILE
    best = out_dir / "model_best.pth"
    if path or best.exists():
        sd = load_checkpoint(path or best)
        model = get_model(cfg, device=device,
                          lambda_head=any(k.startswith("lambda_fc.") for k in sd))
        model.load_state_dict(sd, strict=True)
        logger.info("=> weights from %s", path or best)
    else:
        model = get_model(cfg, device=device)
        logger.warning("=> no checkpoint found (TEST.MODEL_FILE empty, no %s); "
                       "evaluating randomly-initialized weights", best)
    return model.eval()


def main(argv=None) -> dict:
    """Evaluate; returns {'ap': [AP per round], 'rounds': [per-round dicts:
    AP, name_values, loop_s, evaluate_s, crops, results], 'output_dir',
    'log_dir' (metrics.jsonl), 'summary' (utils/summary.py::model_summary),
    'model'}."""
    from ..config import default_config, update_config
    from ..core.function import (check_eval_options, validate,
                                 validate_lambda_quantitative)
    from ..data.datasets import get_dataset
    from ..data.device_pipeline import DeviceLoader
    from ..data.pipeline import Loader, num_input_channels
    from ..models.fuse import maybe_fuse_prenet
    from ..parallel.mesh import make_mesh, replicate
    from ..utils.logging_utils import MetricWriter, create_logger
    from ..utils.profiler import trace_context
    from ..utils.summary import model_summary

    args = parse_args(argv)
    device = start_processes(args, "buctd_tpu_torch.valid.run")
    cfg = default_config()
    update_config(cfg, args)
    mesh = make_mesh(cfg, devices=[device])     # raises where it does not match the cards
    check_eval_options(cfg)
    if device.type == "cuda":
        # f32 means f32 (the JAX path evaluates at Precision.HIGHEST); a bf16
        # model's convs and linears run in bf16 whatever these say
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    _, out_dir, log_dir = create_logger(cfg, args.cfg, "valid")
    out_dir = Path(out_dir)
    logger.info(pprint.pformat(cfg))
    writer = MetricWriter(log_dir)
    model = load_model(cfg, device, out_dir)
    replicate(model, mesh)                      # process 0's weights on every process
    model = maybe_fuse_prenet(cfg, model)        # as tools/test.py:87-88
    img_w, img_h = int(cfg.MODEL.IMAGE_SIZE[0]), int(cfg.MODEL.IMAGE_SIZE[1])
    summary = model_summary(model, (1, num_input_channels(cfg), img_h, img_w))
    logger.info(summary["text"])

    refine_iters = max(int(cfg.TEST.REFINE_ITERS), 1)
    if cfg.TEST.LAMBDA_SWEEP and refine_iters > 1:
        raise ValueError("TEST.LAMBDA_SWEEP writes per-mode/_merged results, "
                         "which the refinement feedback loop cannot consume; "
                         "use one or the other")
    user_output_json = cfg.OUTPUT_JSON
    rounds = []
    try:
        for it in range(refine_iters):
            if refine_iters > 1:
                # intermediate rounds write the epoch-numbered results (the next
                # round reads them); OUTPUT_JSON applies to the last one
                cfg.defrost()
                cfg.OUTPUT_JSON = user_output_json if it == refine_iters - 1 else None
                cfg.freeze()
            dataset = get_dataset(cfg, is_train=False)
            cls = DeviceLoader if cfg.TPU.DEVICE_PIPELINE else Loader
            loader = cls(dataset, cfg, batch_size=cfg.TEST.BATCH_SIZE_PER_GPU * mesh.size,
                         num_workers=cfg.WORKERS, device=device)
            stats = {}
            try:
                with trace_context():       # BUCTD_PROFILE_DIR: a Chrome trace of the round
                    if cfg.TEST.LAMBDA_SWEEP:
                        perf = validate_lambda_quantitative(
                            cfg, loader, dataset, model, out_dir, epoch=it, writer=writer,
                            print_prefix=f"refine{it}", stats=stats)
                        name_values = stats.pop("name_values")[0]
                    else:
                        name_values, perf = validate(cfg, loader, dataset, model, out_dir,
                                                     epoch=it, writer=writer,
                                                     print_prefix=f"refine{it}", stats=stats)
            finally:
                loader.close()
            suffix = "_merged" if cfg.TEST.LAMBDA_SWEEP else ""
            rank = distributed.process_info()[0]
            # each process reads back what its own evaluate wrote
            own_dir = out_dir / f"proc{rank}" if rank > 0 else out_dir
            results = cfg.OUTPUT_JSON or str(
                own_dir / "results" / f"keypoints_test_results_epoch{it}{suffix}.json")
            logger.info("=> refinement round %d: AP %.4f", it, perf)
            rounds.append({"AP": perf, "name_values": name_values, "results": results,
                           **stats})
            if it < refine_iters - 1:
                cfg.defrost()
                cfg.TEST.COCO_BBOX_FILE = results
                cfg.TEST.USE_BU_BBOX = True
                cfg.freeze()
    finally:
        writer.close()
    return {"ap": [r["AP"] for r in rounds], "rounds": rounds, "output_dir": out_dir,
            "log_dir": Path(log_dir), "summary": summary, "model": model}


if __name__ == "__main__":
    main()
