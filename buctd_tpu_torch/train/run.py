"""Training entry point (the counterpart of tools/train.py).

    python -m buctd_tpu_torch.train.run --cfg <yaml> [--steps N] [--no-eval] [KEY VAL ...]

Same surface as the reference's tools/train.py: a YAML plus ``KEY value``
overrides.  It trains on one CUDA card (``--device cuda``, the default; it
raises where CUDA is absent) with the loader tools/train.py:116-125 picks:
the host cv2 ``Loader`` (``TPU.DEVICE_PIPELINE False``, the default and
every stock yaml's: crops by cv2 on the host, normalisation, renders and
targets on the card) or the device loader (``TPU.DEVICE_PIPELINE True``:
host planning, then the warp (K4, or the banded-matmul engine with
``TPU.WARP_ENGINE matmul``), renders and targets on the card).  With
``TPU.DEVICE_SYNTHESIS`` either takes its condition poses from the batched
sampler on the card.  Adam or SGD (``TPU.FUSED_OPTIMIZER``: their fused
form) with MultiStepLR on optimizer steps, ``TRAIN.GRAD_ACCUM_STEPS``
micro-batches a step, bf16 autocast when ``TPU.COMPUTE_DTYPE`` says so,
``TPU.REMAT``, the cutmix/mixup step with ``TRAIN.MIX``, and the attention
dropout through the flash kernels (K1 forward, K2 backward).  ``--steps N``
stops after N loader batches (micro-steps).  Warm starts as
tools/train.py:53-77: ``MODEL.PRETRAINED`` loads the
``MODEL.EXTRA.PRETRAINED_LAYERS`` subset of a ``.pth``, ``TEST.MODEL_FILE`` a
whole ``.pth``.  Checkpoints are ``.pth`` files with the reference's
state-dict keys (``checkpoint.pth`` per epoch, ``checkpoint_ep{epoch}.pth``
every 20, ``final_state.pth`` at the end), so ``PoseEstimator(checkpoint=...)``
serves them.

Around the loop, as tools/train.py: ``utils/logging_utils.py`` sets the
seeds, the output layout ``<OUTPUT_DIR>/<dataset>/<model>/<yaml stem>`` with
its timestamped log, and the metric writer (``metrics.jsonl`` in the
tensorboard directory under ``LOG_DIR``: train_loss and train_acc every
PRINT_FREQ steps, the validation's loss, accuracy and AP);
``utils/summary.py`` logs the parameter count and forward FLOPs; with
``BUCTD_PROFILE_DIR`` set, ``utils/profiler.py`` writes a Chrome trace of the
first epoch there; ``DEBUG.DEBUG`` writes the train debug images every
PRINT_FREQ steps of every 50th epoch.

Every ``EPOCH_EVAL_FREQ`` epochs and after the last one it validates, as
tools/train.py:126-128 and :164-176 do: ``core/function.py::validate`` over
the test set through the host ``Loader``, whatever ``TPU.DEVICE_PIPELINE``
says, with the best AP so far tracked and its weights in ``model_best.pth``
beside ``checkpoint.pth`` (``--no-eval`` skips validation).

Not ported yet, and refused with the ROADMAP item named: an orbax
``TEST.MODEL_FILE`` and a mesh over more than one card
(``train/state.py::check_train_options``,
``core/function.py::check_eval_options``).
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import pprint
from pathlib import Path

import torch

logger = logging.getLogger("buctd_tpu_torch.train")

_ORBAX_ITEM = "ROADMAP Queue 1 items 7 and 8, 'the orbax reader'"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train keypoints network (PyTorch/CUDA)")
    parser.add_argument("--cfg", required=True, type=str)
    parser.add_argument("--modelDir", type=str, default="")
    parser.add_argument("--logDir", type=str, default="")
    parser.add_argument("--dataDir", type=str, default="")
    parser.add_argument("--seed", type=int, default=22)
    parser.add_argument("--steps", type=int, default=None,
                        help="stop after this many loader batches (micro-steps)")
    parser.add_argument("--no-eval", dest="no_eval", action="store_true",
                        help="skip validation")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="Modify config options using the command-line")
    return parser.parse_args(argv)


def _refuse_unported(cfg) -> None:
    path = cfg.TEST.MODEL_FILE
    if path and not path.endswith((".pth", ".pt")):
        raise NotImplementedError(
            f"TEST.MODEL_FILE {path!r}: an orbax checkpoint directory is not ported "
            f"to buctd_tpu_torch yet: {_ORBAX_ITEM}; pass a .pth")


def load_warm_start(cfg, model) -> None:
    """MODEL.PRETRAINED (a subset by PRETRAINED_LAYERS), then TEST.MODEL_FILE
    (the whole model), as tools/train.py:53-77."""
    from ..convert import load_pretrained_subset, load_torch_checkpoint

    if cfg.MODEL.INIT_WEIGHTS and cfg.MODEL.PRETRAINED.strip("/"):
        path = cfg.MODEL.PRETRAINED
        if not Path(path).is_file():
            raise ValueError(f"MODEL.PRETRAINED not found: {path}")
        layers = list(cfg.MODEL.EXTRA.get("PRETRAINED_LAYERS", ["*"]))
        keys = load_pretrained_subset(model, load_torch_checkpoint(path), layers)
        logger.info("=> %d tensors of %s loaded (layers %s)", len(keys), path, layers)
    if cfg.TEST.MODEL_FILE:
        model.load_state_dict(load_torch_checkpoint(cfg.TEST.MODEL_FILE), strict=True)
        logger.info("=> weights from %s", cfg.TEST.MODEL_FILE)


def save_checkpoint(model, optimizer, epoch: int, out_dir: Path, perf: float = 0.0,
                    is_best: bool = False, name: str = "checkpoint.pth"):
    """``name`` (checkpoint.pth) in the reference's layout (lib/utils/utils.py:
    save_checkpoint): epoch, model name, state_dict, best_state_dict, perf,
    optimizer; with ``is_best`` the state dict alone as model_best.pth."""
    sd = model.state_dict()
    torch.save({"epoch": epoch, "model": type(model).__name__, "state_dict": sd,
                "best_state_dict": sd, "perf": perf,
                "optimizer": optimizer.state_dict()}, out_dir / name)
    if is_best:
        torch.save(sd, out_dir / "model_best.pth")


def make_loader(cfg, dataset, device, train: bool, seed: int = 0):
    """The loader tools/train.py:116-128 builds: for training the device
    loader with ``TPU.DEVICE_PIPELINE``, else the host cv2 ``Loader``; for
    validation (``train`` False) always the host ``Loader``."""
    from ..data.device_pipeline import DeviceLoader
    from ..data.pipeline import Loader

    if not train:
        return Loader(dataset, cfg, batch_size=cfg.TEST.BATCH_SIZE_PER_GPU,
                      num_workers=cfg.WORKERS, device=device)
    cls = DeviceLoader if cfg.TPU.DEVICE_PIPELINE else Loader
    return cls(dataset, cfg, batch_size=cfg.TRAIN.BATCH_SIZE_PER_GPU,
               shuffle=cfg.TRAIN.SHUFFLE, num_workers=cfg.WORKERS, seed=seed, device=device)


def main(argv=None) -> dict:
    """Train; returns {'steps', 'begin_epoch', 'stats' (per epoch), 'perf'
    (the AP of each validation), 'output_dir', 'log_dir' (metrics.jsonl),
    'summary' (utils/summary.py::model_summary), 'model'}."""
    from ..config import default_config, update_config
    from ..core.function import check_eval_options, train_epoch, validate
    from ..data.datasets import get_dataset
    from ..data.pipeline import num_input_channels
    from ..models import get_model
    from ..utils.logging_utils import MetricWriter, create_logger, set_seed
    from ..utils.profiler import trace_context
    from ..utils.summary import model_summary
    from .state import (accum_steps, check_train_options, make_lr_schedule, make_optimizer,
                        make_train_step)

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
    set_seed(args.seed)
    if device.type == "cuda":
        # f32 means f32 for the parameters' master copies and any f32 layer
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = bool(cfg.CUDNN.BENCHMARK)

    _, out_dir, log_dir = create_logger(cfg, args.cfg, "train")
    out_dir = Path(out_dir)
    logger.info(pprint.pformat(cfg))
    writer = MetricWriter(log_dir)
    model = get_model(cfg, device=device)
    img_w, img_h = int(cfg.MODEL.IMAGE_SIZE[0]), int(cfg.MODEL.IMAGE_SIZE[1])
    summary = model_summary(model, (1, num_input_channels(cfg), img_h, img_w))
    logger.info(summary["text"])
    load_warm_start(cfg, model)
    dataset = get_dataset(cfg, is_train=True)
    loader = make_loader(cfg, dataset, device, train=True, seed=args.seed)
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
        for _ in range(begin_epoch * max(steps_per_epoch // accum_steps(cfg), 1)):
            scheduler.step()
        logger.info("=> auto-resumed at epoch %d from %s", begin_epoch, ckpt)
    generator = torch.Generator().manual_seed(args.seed)
    step = make_train_step(cfg, model, optimizer, scheduler, generator, args.seed)
    logger.info("=> %s on %s: %d samples, %d steps per epoch, batch %d, %s, %s",
                cfg.MODEL.NAME, device, len(dataset), steps_per_epoch, loader.batch,
                cfg.TPU.COMPUTE_DTYPE, type(loader).__name__)

    valid_set = None if args.no_eval else get_dataset(cfg, is_train=False)
    done, all_stats, perfs, best_perf = 0, [], [], 0.0
    try:
        for epoch in range(begin_epoch, int(cfg.TRAIN.END_EPOCH)):
            left = None if args.steps is None else args.steps - done
            # BUCTD_PROFILE_DIR: a Chrome trace of the first epoch trained
            with trace_context() if epoch == begin_epoch else contextlib.nullcontext():
                stats = train_epoch(cfg, loader, step, epoch, max_steps=left, writer=writer,
                                    output_dir=out_dir)
            all_stats.append(stats)
            done += len(stats["step_s"])
            if args.steps is not None and done >= args.steps:
                break
            perf = 0.0
            if ((epoch + 1) % cfg.EPOCH_EVAL_FREQ == 0
                    or epoch == cfg.TRAIN.END_EPOCH - 1) and valid_set is not None:
                valid_loader = make_loader(cfg, valid_set, device, train=False)
                try:
                    _, perf = validate(cfg, valid_loader, valid_set, model, out_dir,
                                       epoch=epoch, writer=writer)
                finally:
                    valid_loader.close()
                perfs.append(perf)
            is_best = perf > best_perf
            best_perf = max(perf, best_perf)
            save_checkpoint(model, optimizer, epoch + 1, out_dir, perf, is_best)
            if (epoch + 1) % 20 == 0:
                save_checkpoint(model, optimizer, epoch + 1, out_dir, perf,
                                name=f"checkpoint_ep{epoch}.pth")
    finally:
        loader.close()
        writer.close()
    torch.save(model.state_dict(), out_dir / "final_state.pth")
    logger.info("=> %d steps; final state in %s", done, out_dir / "final_state.pth")
    return {"steps": done, "begin_epoch": begin_epoch, "stats": all_stats,
            "perf": perfs, "output_dir": out_dir, "log_dir": Path(log_dir),
            "summary": summary, "model": model}


if __name__ == "__main__":
    main()
