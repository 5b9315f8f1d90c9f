"""Training entry point (the counterpart of tools/train.py).

    python -m buctd_tpu_torch.train.run --cfg <yaml> [--steps N] [--no-eval] [KEY VAL ...]

Same surface as the reference's tools/train.py: a YAML plus ``KEY value``
overrides.  It trains on one CUDA card (``--device cuda``, the default; it
raises where CUDA is absent) with the device loader (``TPU.DEVICE_PIPELINE
True``: host planning, then the warp (K4), renders and targets on the card),
Adam or SGD with MultiStepLR on optimizer steps, bf16 autocast when
``TPU.COMPUTE_DTYPE`` says so, and the attention dropout through the flash
kernels (K1 forward, K2 backward).  ``--steps N`` stops after N optimizer
steps.  Checkpoints are ``.pth`` files with the reference's state-dict keys
(``checkpoint.pth`` per epoch, ``final_state.pth`` at the end), so
``PoseEstimator(checkpoint=...)`` serves them.

Every ``EPOCH_EVAL_FREQ`` epochs and after the last one it validates, as
tools/train.py:164-176 does: ``core/function.py::validate`` over the test set
through the device loader in test mode, with the best AP so far tracked and
its weights in ``model_best.pth`` beside ``checkpoint.pth`` (``--no-eval``
skips validation).

Not ported yet, and refused with the ROADMAP item named: the host cv2
``Loader`` (``TPU.DEVICE_PIPELINE False``), ``MODEL.PRETRAINED``/
``TEST.MODEL_FILE`` warm starts, and the options
``train/state.py::check_train_options`` and
``core/function.py::check_eval_options`` list.
"""

from __future__ import annotations

import argparse
import logging
import random
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger("buctd_tpu_torch.train")

_TRAIN_ITEM = "ROADMAP Queue 1 item 8, 'training: the rest'"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train keypoints network (PyTorch/CUDA)")
    parser.add_argument("--cfg", required=True, type=str)
    parser.add_argument("--modelDir", type=str, default="")
    parser.add_argument("--logDir", type=str, default="")
    parser.add_argument("--dataDir", type=str, default="")
    parser.add_argument("--seed", type=int, default=22)
    parser.add_argument("--steps", type=int, default=None,
                        help="stop after this many optimizer steps")
    parser.add_argument("--no-eval", dest="no_eval", action="store_true",
                        help="skip validation")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="Modify config options using the command-line")
    return parser.parse_args(argv)


def output_dir(cfg, cfg_path: str) -> Path:
    """<OUTPUT_DIR>/<dataset>/<model name>/<yaml stem>, made if absent (the
    JAX package's create_logger layout)."""
    out = (Path(cfg.OUTPUT_DIR or "output") / cfg.DATASET.DATASET / cfg.MODEL.NAME
           / Path(cfg_path).stem)
    out.mkdir(parents=True, exist_ok=True)
    return out


def _refuse_unported(cfg) -> None:
    if not cfg.TPU.DEVICE_PIPELINE:
        raise NotImplementedError(
            "TPU.DEVICE_PIPELINE False (the host cv2 Loader) is not ported to "
            f"buctd_tpu_torch yet: {_TRAIN_ITEM}; pass TPU.DEVICE_PIPELINE True")
    if (cfg.MODEL.INIT_WEIGHTS and cfg.MODEL.PRETRAINED.strip("/")) or cfg.TEST.MODEL_FILE:
        raise NotImplementedError("warm starts (MODEL.PRETRAINED, TEST.MODEL_FILE) "
                                  f"are not ported yet: {_TRAIN_ITEM}")


def save_checkpoint(model, optimizer, epoch: int, out_dir: Path, perf: float = 0.0,
                    is_best: bool = False):
    """checkpoint.pth in the reference's layout (lib/utils/utils.py:
    save_checkpoint): epoch, model name, state_dict, best_state_dict, perf,
    optimizer; with ``is_best`` the state dict alone as model_best.pth."""
    sd = model.state_dict()
    torch.save({"epoch": epoch, "model": type(model).__name__, "state_dict": sd,
                "best_state_dict": sd, "perf": perf,
                "optimizer": optimizer.state_dict()}, out_dir / "checkpoint.pth")
    if is_best:
        torch.save(sd, out_dir / "model_best.pth")


def main(argv=None) -> dict:
    """Train; returns {'steps', 'begin_epoch', 'stats' (per epoch), 'perf'
    (the AP of each validation), 'output_dir', 'model'}."""
    from ..config import default_config, update_config
    from ..core.function import check_eval_options, train_epoch, validate
    from ..data.datasets import get_dataset
    from ..data.device_pipeline import DeviceLoader
    from ..models import get_model
    from .state import TrainStep, check_train_options, make_lr_schedule, make_optimizer

    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("buctd_tpu_torch.train.run: CUDA is not available; "
                           "pass --device cpu to train on the CPU")
    cfg = default_config()
    update_config(cfg, args)
    check_train_options(cfg)
    _refuse_unported(cfg)
    if not args.no_eval:
        check_eval_options(cfg)
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    if device.type == "cuda":
        # f32 means f32 for the parameters' master copies and any f32 layer
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = bool(cfg.CUDNN.BENCHMARK)

    out_dir = output_dir(cfg, args.cfg)
    model = get_model(cfg, device=device)
    dataset = get_dataset(cfg, is_train=True)
    loader = DeviceLoader(dataset, cfg, batch_size=cfg.TRAIN.BATCH_SIZE_PER_GPU,
                          shuffle=cfg.TRAIN.SHUFFLE, num_workers=cfg.WORKERS,
                          seed=args.seed, device=device)
    steps_per_epoch = max(len(loader), 1)
    optimizer = make_optimizer(cfg, model)
    scheduler = make_lr_schedule(cfg, optimizer, steps_per_epoch)
    begin_epoch = int(cfg.TRAIN.BEGIN_EPOCH)
    ckpt = out_dir / "checkpoint.pth"
    if cfg.AUTO_RESUME and ckpt.exists():
        state = torch.load(ckpt, map_location=device, weights_only=False)
        model.load_state_dict(state["state_dict"])
        optimizer.load_state_dict(state["optimizer"])
        begin_epoch = int(state["epoch"])
        for group in optimizer.param_groups:   # replayed below from the base LR
            group["lr"] = group["initial_lr"]
        scheduler = make_lr_schedule(cfg, optimizer, steps_per_epoch)
        for _ in range(begin_epoch * steps_per_epoch):
            scheduler.step()
        logger.info("=> auto-resumed at epoch %d from %s", begin_epoch, ckpt)
    generator = torch.Generator().manual_seed(args.seed)
    step = TrainStep(cfg, model, optimizer, scheduler, generator)
    logger.info("=> %s on %s: %d samples, %d steps per epoch, batch %d, %s",
                cfg.MODEL.NAME, device, len(dataset), steps_per_epoch, loader.batch,
                cfg.TPU.COMPUTE_DTYPE)

    valid_set = None if args.no_eval else get_dataset(cfg, is_train=False)
    done, all_stats, perfs, best_perf = 0, [], [], 0.0
    try:
        for epoch in range(begin_epoch, int(cfg.TRAIN.END_EPOCH)):
            left = None if args.steps is None else args.steps - done
            stats = train_epoch(cfg, loader, step, epoch, max_steps=left)
            all_stats.append(stats)
            done += len(stats["step_s"])
            if args.steps is not None and done >= args.steps:
                break
            perf = 0.0
            if ((epoch + 1) % cfg.EPOCH_EVAL_FREQ == 0
                    or epoch == cfg.TRAIN.END_EPOCH - 1) and valid_set is not None:
                valid_loader = DeviceLoader(valid_set, cfg,
                                            batch_size=cfg.TEST.BATCH_SIZE_PER_GPU,
                                            num_workers=cfg.WORKERS, device=device)
                try:
                    _, perf = validate(cfg, valid_loader, valid_set, model, out_dir,
                                       epoch=epoch)
                finally:
                    valid_loader.close()
                perfs.append(perf)
            is_best = perf > best_perf
            best_perf = max(perf, best_perf)
            save_checkpoint(model, optimizer, epoch + 1, out_dir, perf, is_best)
    finally:
        loader.close()
    torch.save(model.state_dict(), out_dir / "final_state.pth")
    logger.info("=> %d steps; final state in %s", done, out_dir / "final_state.pth")
    return {"steps": done, "begin_epoch": begin_epoch, "stats": all_stats,
            "perf": perfs, "output_dir": out_dir, "model": model}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)-15s %(message)s")
    main()
