"""Training batches with the dense preprocessing on the card.

Counterpart of buctd_tpu/data/device_pipeline.py::DeviceLoader (:42-179):

  synth  : with TPU.DEVICE_SYNTHESIS (training), the batch's condition
           poses from the batched sampler on the loader's device and its
           own stream (data/pose_synthesis_device.py,
           pipeline.py::device_synthesize_batch); plan_sample takes them as
           ``cond_override`` in place of its host sampler;
  host   : JointsDataset.plan_sample in a thread pool (decode, condition
           choice / synthesis, box and augmentation draws, crop affine, joint
           transforms), then the padding of the images into one uint8 bucket,
           copied to the card through pinned memory;
  device : rotated warp of the uint8 bucket with the crop-aug rectangle
           mask (K4, ops/warp.py::warp_affine_general: one fused kernel
           launch that reads the bytes and the rectangle itself) -> round ->
           ImageNet normalization -> colored condition render -> channel
           concat -> target Gaussians (ops/heatmap.py::generate_target).

Images pad into the JAX package's buckets.  A batch is the JAX loader's dict,
with the model's NCHW layout: 'input' (B, 3 + c, H, W), 'target'
(B, J, h, w) and 'target_weight' (B, J) on the device, meta in numpy.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops.heatmap import generate_target
from ..ops.warp import warp_affine_general
from .joints_dataset import IMAGENET_MEAN, IMAGENET_STD
from .pipeline import condition_mode, device_synthesize_batch, render_condition

BUCKETS = (256, 384, 512, 640, 768, 1024, 1536, 2048)


def _bucket(v: int) -> int:
    for b in BUCKETS:
        if v <= b:
            return b
    return -(-v // 512) * 512


class DeviceLoader:
    """Batch loader with on-device preprocessing.

    ``device`` defaults to "cuda" and the constructor raises where CUDA is
    absent; ``device="cpu"`` runs the plain versions of the kernels (tests).
    """

    def __init__(self, dataset, cfg, batch_size=None, shuffle=False, num_workers=8,
                 seed=0, drop_last=False, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DeviceLoader: CUDA is not available; pass "
                               "device='cpu' to run on the CPU")
        self.ds = dataset
        self.cfg = cfg
        self.is_train = dataset.is_train
        self.batch = int(batch_size or (
            cfg.TRAIN.BATCH_SIZE_PER_GPU if self.is_train
            else cfg.TEST.BATCH_SIZE_PER_GPU))
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.pool = ThreadPoolExecutor(max_workers=num_workers)
        self.drop_last = drop_last
        self.img_w, self.img_h = int(cfg.MODEL.IMAGE_SIZE[0]), int(cfg.MODEL.IMAGE_SIZE[1])
        self.hm_w, self.hm_h = int(cfg.MODEL.HEATMAP_SIZE[0]), int(cfg.MODEL.HEATMAP_SIZE[1])
        self.sigma = int(cfg.MODEL.SIGMA)
        self.mode = condition_mode(cfg)
        self.conditional = bool(cfg.MODEL.CONDITIONAL_TOPDOWN)
        self.engine = str(cfg.TPU.WARP_ENGINE)
        dev = self.device
        self.colors = torch.as_tensor(np.asarray(dataset.kpt_colors, np.float32), device=dev)
        self.mean = torch.as_tensor(IMAGENET_MEAN, device=dev)
        self.std = torch.as_tensor(IMAGENET_STD, device=dev)
        jw = getattr(dataset, "joints_weight", None)
        self.joints_weight = (
            torch.as_tensor(np.asarray(jw, np.float32).reshape(1, -1), device=dev)
            if bool(cfg.LOSS.USE_DIFFERENT_JOINTS_WEIGHT) and jw is not None else None)
        self.device_synth = None
        if (bool(cfg.TPU.DEVICE_SYNTHESIS) and self.is_train
                and getattr(dataset, "synthesis_pose", False)
                and getattr(dataset, "condition_topdown", False)):
            # the batched sampler on the loader's device replaces the host
            # sampler; plan_sample takes its poses through cond_override
            from .pose_synthesis_device import make_synthesize_fn
            self.device_synth = make_synthesize_fn(cfg, device=dev)
            self.synth_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
            self._synth_step = 0
            self._synth_seed = seed

    def close(self) -> None:
        self.pool.shutdown(wait=True)

    def _host_sample(self, idx, cond_override=None):
        """plan_sample plus packaging; the dict keeps the possibly flipped
        source view, which the bucket padding copies anyway."""
        plan = self.ds.plan_sample(idx, cond_override=cond_override)
        H, W = plan["image"].shape[:2]
        mask_box = (np.array(plan["mask_box"], np.float64)
                    if plan["mask_box"] is not None
                    else np.array([0, 0, W, H], np.float64))
        plan["mask_box"] = mask_box.astype(np.float32)
        plan["trans_inv"] = plan["trans_inv"].astype(np.float32)
        plan.pop("trans")
        return plan

    def _to_device(self, array):
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _device_batch(self, images, trans_inv, mask_box, joints, joints_vis, cond_joints):
        """The dense per-batch work, on the card (the JAX jitted ``fn``)."""
        # the warp reads the uint8 bucket and zeroes the pixels outside each
        # mask rectangle itself: images.float() * inside, never materialised
        crops = warp_affine_general(images, trans_inv, (self.img_h, self.img_w), self.engine,
                                    mask_box=mask_box)
        crops = torch.round(crops)   # the host path warps uint8 (cv2 rounds)
        inp = (crops / 255.0 - self.mean) / self.std
        if self.conditional:
            cond = render_condition(cond_joints, self.mode, (self.img_h, self.img_w),
                                    self.colors)
            inp = torch.cat([inp, cond], dim=-1)
        tgt, tw = generate_target(joints, joints_vis[..., 0], (self.img_w, self.img_h),
                                  (self.hm_w, self.hm_h), self.sigma)
        if self.joints_weight is not None:
            tw = tw * self.joints_weight
        return inp.permute(0, 3, 1, 2).contiguous(), tgt, tw

    def __len__(self):
        n = len(self.ds)
        return n // self.batch if self.drop_last else -(-n // self.batch)

    def __iter__(self):
        order = np.arange(len(self.ds))
        if self.shuffle:
            self.rng.shuffle(order)
        n_valid = len(order)
        for i in range(0, len(order), self.batch):
            idxs = order[i:i + self.batch]
            if len(idxs) < self.batch:
                if self.drop_last:
                    return
                idxs = np.concatenate([idxs, np.repeat(idxs[-1:], self.batch - len(idxs))])
            conds = device_synthesize_batch(self, idxs)
            samples = list(self.pool.map(self._host_sample, idxs, conds))

            hb = _bucket(max(s["image"].shape[0] for s in samples))
            wb = _bucket(max(s["image"].shape[1] for s in samples))
            images = np.zeros((self.batch, hb, wb, 3), np.uint8)
            for k, s in enumerate(samples):
                im = s["image"]
                images[k, :im.shape[0], :im.shape[1]] = im

            batch = {k: np.stack([s[k] for s in samples])
                     for k in samples[0] if k not in ("image", "image_path")}
            batch["image_path"] = [s["image_path"] for s in samples]
            batch["db_index"] = idxs.astype(np.int64)
            batch["valid"] = (np.arange(self.batch)
                              < max(0, min(self.batch, n_valid - i))).astype(np.float32)
            dev = {k: self._to_device(batch[k]) for k in
                   ("trans_inv", "mask_box", "joints", "joints_vis", "cond_joints")}
            inp, tgt, tw = self._device_batch(self._to_device(images), **dev)
            batch["input"], batch["target"], batch["target_weight"] = inp, tgt, tw
            yield batch
