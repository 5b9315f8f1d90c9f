"""The host cv2 loader, condition-render dispatch, input-channel rules,
batched synthesis and the loaders' sharding helpers.

Counterpart of buctd_tpu/data/pipeline.py, all of it:

  * ``Loader`` (:191-265), the loader of ``TPU.DEVICE_PIPELINE False`` (the
    JAX default): ``JointsDataset.get_sample`` in a thread pool (decode,
    planning, the cv2 crop), then the batch's uint8 crops as one pinned
    buffer copied to the card with ``non_blocking``, and there the ImageNet
    normalisation, the condition render, the channel concat and the target
    Gaussians (``make_input_fn`` :144, ``make_target_fn`` :168).  It yields
    the device loader's batch: 'input' (B, 3 + c, H, W), 'target' (B, J, h,
    w) and 'target_weight' (B, J) on the device, meta in numpy, 'valid' and
    'db_index';
  * ``collate`` (:30), ``condition_mode``, ``num_input_channels`` and
    ``render_condition`` (:39-69), ``device_synthesize_batch`` (:72,
    TPU.DEVICE_SYNTHESIS, for both loaders);
  * ``local_batch_size`` (:98), ``shard_epoch_order`` (:115) and
    ``shard_length`` (:138): a process's share of a global batch and of an
    epoch's order, from utils/distributed.py::process_info (JAX's
    ``_process_info`` :90);
  * ``BatchLoader``, what ``Loader`` and data/device_pipeline.py's
    ``DeviceLoader`` share: the batch sizes, the epoch order with its
    padding, 'valid' and 'db_index', the pool, ``make_input_fn`` and
    ``make_target_fn``, and TPU.DEVICE_SYNTHESIS.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops.heatmap import (generate_target, render_condition_colored,
                           render_condition_plain, render_condition_stacked)
from ..utils import distributed
from .joints_dataset import IMAGENET_MEAN, IMAGENET_STD

META_KEYS = ("center", "scale", "rotation", "score", "annotation_id",
             "cond_max_iou", "joints", "joints_vis", "cond_joints",
             "cond_joints_vis", "has_cond")


def collate(samples: list) -> dict:
    """Stack sample dicts into fixed-shape numpy batch arrays."""
    batch = {"image": np.stack([s["image"] for s in samples]),
             "image_path": [s["image_path"] for s in samples]}
    for k in META_KEYS:
        batch[k] = np.stack([np.asarray(s[k]) for s in samples])
    return batch


def condition_mode(cfg) -> str:
    if cfg.DATASET.STACKED_CONDITION:
        return "stacked"
    if cfg.DATASET.COLORED:
        return "colored"
    return "plain"


def num_input_channels(cfg) -> int:
    """3 / 6 / 3+J input channels (tools/train.py:109-121)."""
    if not cfg.MODEL.CONDITIONAL_TOPDOWN:
        return 3
    if cfg.DATASET.STACKED_CONDITION:
        return 3 + int(cfg.MODEL.NUM_JOINTS)
    return 6


def render_condition(cond_joints, mode: str, out_hw, colors=None, tf32: bool = False):
    """Dispatch to the three condition encodings (all return (B, H, W, c));
    ``tf32``: the sums over joints take TF32 operands (ops/heatmap.py)."""
    if mode == "stacked":
        return render_condition_stacked(cond_joints, out_hw)
    if mode == "colored":
        return render_condition_colored(cond_joints, colors, out_hw, tf32)
    return render_condition_plain(cond_joints, out_hw, tf32)


def synthesis_generator(device, seed: int, step: int) -> torch.Generator:
    """The sampler's generator for one batch, on ``device``: its seed derives
    from (loader seed, step), as JAX's ``fold_in(PRNGKey(seed), step)``."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def attach_device_synthesis(loader, cfg, dataset, seed: int) -> None:
    """Give ``loader`` the batched condition sampler on its device where
    TPU.DEVICE_SYNTHESIS applies (training a dataset that synthesizes
    conditions), else ``device_synth`` None: the host sampler stays."""
    loader.device_synth = None
    if (bool(cfg.TPU.DEVICE_SYNTHESIS) and loader.is_train
            and getattr(dataset, "synthesis_pose", False)
            and getattr(dataset, "condition_topdown", False)):
        from .pose_synthesis_device import make_synthesize_fn

        dev = loader.device
        loader.device_synth = make_synthesize_fn(cfg, device=dev)
        loader.synth_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        loader._synth_step = 0
        loader._synth_seed = seed


def device_synthesize_batch(loader, idxs):
    """One batched condition synthesis for a whole batch (TPU.DEVICE_SYNTHESIS):
    (J, 3) numpy rows for plan_sample's cond_override, or Nones where the
    loader keeps the host sampler (``loader.device_synth`` unset).

    ``plan_sample`` needs the poses on the host: the BU box and the crop
    affine derive from them.  The loader runs in the prefetch thread while
    the trainer queues steps on the default stream, and a device-to-host copy
    there would wait for every step already queued.  So on CUDA the sampler
    runs on the loader's own stream, its result is copied into pinned memory
    on that stream, and only that stream's event is waited on."""
    if loader.device_synth is None:
        return [None] * len(idxs)
    seeds = [loader.ds.synthesis_seed(loader.ds.db[i]) for i in idxs]
    args = (np.stack([s[0] for s in seeds]), np.stack([s[1] for s in seeds]),
            [s[2] for s in seeds], np.array([s[3] for s in seeds]))
    gen = synthesis_generator(loader.device, loader._synth_seed, loader._synth_step)
    loader._synth_step += 1
    if loader.device.type != "cuda":
        return list(loader.device_synth(gen, *args).numpy())
    stream = loader.synth_stream
    with torch.cuda.stream(stream):
        out = loader.device_synth(gen, *args)
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return list(host.numpy())


def to_device(array, device):
    """numpy -> ``device``: on CUDA through pinned memory and a non-blocking
    copy (the caching host allocator holds the pinned buffer until the copy
    is done); on the CPU the array's own memory."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def local_batch_size(global_batch: int) -> int:
    """This process's share of a global batch: the loaders take the GLOBAL
    batch (the reference's BATCH_SIZE_PER_GPU x cards) and serve this
    process's contiguous rows of it."""
    _, k = distributed.process_info()
    if k == 1:
        return global_batch
    if global_batch % k:
        raise ValueError(f"global batch {global_batch} not divisible by process count {k}")
    return global_batch // k


def shard_epoch_order(order: np.ndarray):
    """This process's contiguous slice of a GLOBAL epoch order: (local_order,
    n_valid), the slice padded by repeating its last index to ceil(n / k), so
    that every process runs the same number of steps; rows past n_valid are
    padding.  Every process must build the global order alike (one seed)."""
    p, k = distributed.process_info()
    if k == 1:
        return order, len(order)
    per = -(-len(order) // k)
    shard = order[p * per:(p + 1) * per]
    n_valid = len(shard)
    if n_valid == 0:          # more processes than samples
        shard = order[-1:]
        n_valid = 0
    if len(shard) < per:
        shard = np.concatenate([shard, np.repeat(shard[-1:], per - len(shard))])
    return shard, n_valid


def shard_length(n_total: int) -> int:
    """A process's padded shard length of an n_total-sample dataset."""
    _, k = distributed.process_info()
    return n_total if k == 1 else -(-n_total // k)


def make_input_fn(cfg, colors, device):
    """(B, H, W, 3) uint8 crops and (B, J, 3) condition joints, on ``device``
    -> model input (B, 3 + c, H, W) f32: the RGB ToTensor + ImageNet
    normalisation, the condition channels raw 0..255, as the reference
    concatenates them (JointsDataset.py:345, tools/train.py:167-183)."""
    img_w, img_h = int(cfg.MODEL.IMAGE_SIZE[0]), int(cfg.MODEL.IMAGE_SIZE[1])
    mode = condition_mode(cfg)
    conditional = bool(cfg.MODEL.CONDITIONAL_TOPDOWN)
    colors = torch.as_tensor(np.asarray(colors, np.float32), device=device)
    mean = torch.as_tensor(IMAGENET_MEAN, device=device)
    std = torch.as_tensor(IMAGENET_STD, device=device)

    def input_fn(images, cond_joints):
        x = (images.float() / 255.0 - mean) / std
        if conditional:
            cond = render_condition(cond_joints, mode, (img_h, img_w), colors)
            x = torch.cat([x, cond], dim=-1)
        return x.permute(0, 3, 1, 2).contiguous()

    return input_fn


def make_target_fn(cfg, joints_weight=None):
    """Crop-frame joints (B, J, 2+) and visibility (B, J) -> target (B, J, h,
    w) and weight (B, J), with the USE_DIFFERENT_JOINTS_WEIGHT multiply
    (JointsDataset.py:449-451); on the joints' device."""
    image_size = (int(cfg.MODEL.IMAGE_SIZE[0]), int(cfg.MODEL.IMAGE_SIZE[1]))
    heatmap_size = (int(cfg.MODEL.HEATMAP_SIZE[0]), int(cfg.MODEL.HEATMAP_SIZE[1]))
    sigma = int(cfg.MODEL.SIGMA)
    jw = (np.asarray(joints_weight, np.float32).reshape(1, -1)
          if bool(cfg.LOSS.USE_DIFFERENT_JOINTS_WEIGHT) and joints_weight is not None
          else None)

    def target_fn(joints, joints_vis):
        tgt, w = generate_target(joints, joints_vis, image_size, heatmap_size, sigma)
        if jw is not None:
            w = w * torch.as_tensor(jw, device=w.device)
        return tgt, w

    return target_fn


class BatchLoader:
    """What both loaders share.  ``batch_size`` is the GLOBAL batch; a
    process serves its contiguous rows of it over its shard of the epoch
    order.  The last partial batch is padded by repeating its last sample,
    'valid' marking the real rows.  ``device`` defaults to "cuda" and the
    constructor raises where CUDA is absent; ``device="cpu"`` runs
    everything on the CPU (tests).  A subclass yields batches from
    ``_index_batches``."""

    def __init__(self, dataset, cfg, batch_size=None, shuffle=False, num_workers=8,
                 is_train=None, seed=0, drop_last=False, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{type(self).__name__}: CUDA is not available; pass "
                               "device='cpu' to run on the CPU")
        self.ds = dataset
        self.cfg = cfg
        self.is_train = dataset.is_train if is_train is None else is_train
        self.global_batch = int(batch_size or (
            cfg.TRAIN.BATCH_SIZE_PER_GPU if self.is_train
            else cfg.TEST.BATCH_SIZE_PER_GPU))
        self.batch = local_batch_size(self.global_batch)
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.pool = ThreadPoolExecutor(max_workers=num_workers)
        self.drop_last = drop_last
        self.img_w, self.img_h = int(cfg.MODEL.IMAGE_SIZE[0]), int(cfg.MODEL.IMAGE_SIZE[1])
        self.input_fn = make_input_fn(cfg, dataset.kpt_colors, self.device)
        self.target_fn = make_target_fn(cfg, getattr(dataset, "joints_weight", None))
        attach_device_synthesis(self, cfg, dataset, seed)

    def close(self) -> None:
        self.pool.shutdown(wait=True)

    def __len__(self):
        n = shard_length(len(self.ds))
        return n // self.batch if self.drop_last else -(-n // self.batch)

    def _index_batches(self):
        """(db rows, their condition overrides, the batch's meta so far) for
        each batch of this process's shard of the epoch order: the meta
        holds 'db_index' (validate's merge of processes) and 'valid'."""
        # the GLOBAL order is built alike on every process (one seed);
        # shard_epoch_order slices this process's piece of it
        order = np.arange(len(self.ds))
        if self.shuffle:
            self.rng.shuffle(order)
        order, n_valid = shard_epoch_order(order)
        for i in range(0, len(order), self.batch):
            idxs = order[i:i + self.batch]
            if len(idxs) < self.batch:
                if self.drop_last:
                    return
                idxs = np.concatenate([idxs, np.repeat(idxs[-1:], self.batch - len(idxs))])
            meta = {"db_index": idxs.astype(np.int64),
                    "valid": (np.arange(self.batch)
                              < max(0, min(self.batch, n_valid - i))).astype(np.float32)}
            yield idxs, device_synthesize_batch(self, idxs), meta

    def _dense(self, batch, crops) -> dict:
        """The batch's 'input' from its crops (B, H, W, 3) on the device, and
        its targets: at train AND eval, the reference's val loop computes
        its loss and PCK against them (core/function.py:239-248)."""
        joints, joints_vis, cond_joints = (to_device(batch[k], self.device) for k in (
            "joints", "joints_vis", "cond_joints"))
        batch["input"] = self.input_fn(crops, cond_joints)
        batch["target"], batch["target_weight"] = self.target_fn(joints, joints_vis[..., 0])
        return batch


class Loader(BatchLoader):
    """Threaded batch loader over a JointsDataset with the crop on the host
    (cv2) and the dense work on ``device`` (``BatchLoader``)."""

    def __iter__(self):
        for idxs, conds, meta in self._index_batches():
            samples = list(self.pool.map(
                lambda a: self.ds.get_sample(a[0], cond_override=a[1]), zip(idxs, conds)))
            batch = collate(samples)
            batch.update(meta)
            # the crops cross as one pinned uint8 batch, copied non-blocking
            yield self._dense(batch, to_device(batch.pop("image"), self.device))
