"""Logger, metric writer and seeding (reference: lib/utils/utils.py:84,
220-255).

Counterpart of buctd_tpu/utils/logging_utils.py.  ``create_logger`` keeps
the reference's layout: ``{OUTPUT_DIR}/{dataset}/{model}/{cfg_name}/`` with
a timestamped log file, and a tensorboard directory
``{LOG_DIR}/{dataset}/{model}/{cfg_name}_{time}``.  ``MetricWriter``
streams scalars to ``metrics.jsonl`` there, and to tensorboardX too where
it can be imported.  Only process 0 writes the log file and the metrics
(``torch.distributed``'s rank; one process: always).
"""

from __future__ import annotations

import json
import logging
import os
import random
import time
from pathlib import Path

import numpy as np

from ..parallel.distributed import is_primary as _is_primary
from . import distributed


def create_logger(cfg, cfg_name: str, phase: str = "train"):
    """(logger, final output dir, tensorboard dir) for ``cfg`` and its yaml
    ``cfg_name``; the root logger gets a file handler on the timestamped
    log and a console handler (process 0; other processes log warnings to
    the console).  In a run of several processes every console line is
    tagged with its process."""
    root_output_dir = Path(cfg.OUTPUT_DIR or "output")
    dataset, model = cfg.DATASET.DATASET, cfg.MODEL.NAME
    cfg_name = os.path.basename(cfg_name).split(".")[0]
    final_output_dir = root_output_dir / dataset / model / cfg_name
    final_output_dir.mkdir(parents=True, exist_ok=True)

    time_str = time.strftime("%Y-%m-%d-%H-%M")
    log_file = final_output_dir / f"{cfg_name}_{time_str}_{phase}.log"
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    # a later call in the same process (tests, chip_smoke.py) replaces the
    # handlers an earlier one added, and closes its log file
    for h in [h for h in logger.handlers if getattr(h, "_buctd_logger", False)]:
        logger.removeHandler(h)
        h.close()
    rank, world = distributed.process_info()
    sh = logging.StreamHandler()
    if world > 1:
        sh.setFormatter(logging.Formatter(f"[proc {rank}] %(asctime)-15s %(message)s"))
    if _is_primary():
        fh = logging.FileHandler(str(log_file))
        fh.setFormatter(logging.Formatter("%(asctime)-15s %(message)s"))
        handlers = [fh, sh]
    else:
        sh.setLevel(logging.WARNING)
        handlers = [sh]
    for h in handlers:
        h._buctd_logger = True
        logger.addHandler(h)

    tb_log_dir = Path(cfg.LOG_DIR or "log") / dataset / model / f"{cfg_name}_{time_str}"
    tb_log_dir.mkdir(parents=True, exist_ok=True)
    return logger, str(final_output_dir), str(tb_log_dir)


class MetricWriter:
    """Scalars -> ``{log_dir}/metrics.jsonl`` (one JSON object a line: tag,
    value, step, ts), and tensorboardX where it imports.  A scalar written
    without a step takes its tag's next one, from 0, as the reference's
    ``writer_dict`` counters."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._steps: dict = {}
        self._f = (open(os.path.join(log_dir, "metrics.jsonl"), "a")
                   if _is_primary() else None)
        self._tb = None
        if self._f is not None:
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except Exception:        # tensorboardX is optional, as in JAX's writer
                self._tb = None

    def add_scalar(self, tag: str, value, step: int | None = None):
        if step is None:
            step = self._steps.get(tag, 0)
            self._steps[tag] = step + 1
        if self._f is None:
            return
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                  "ts": time.time()}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None


def set_seed(seed: int) -> int:
    """Seed the host RNGs the loaders draw from (utils.py:84-90) and torch's
    default generators; the dropout seeds come from the trainer's own
    ``torch.Generator``."""
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed
