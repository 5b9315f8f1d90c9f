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
           the host Loader's chain (pipeline.py::make_input_fn: ImageNet
           normalization, condition render, channel concat; make_target_fn:
           the target Gaussians).

Images pad into the JAX package's buckets.  A batch is the JAX loader's dict,
with the model's NCHW layout: 'input' (B, 3 + c, H, W), 'target'
(B, J, h, w) and 'target_weight' (B, J) on the device, meta in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.warp import warp_affine_general
from .pipeline import BatchLoader, to_device

BUCKETS = (256, 384, 512, 640, 768, 1024, 1536, 2048)


def _bucket(v: int) -> int:
    for b in BUCKETS:
        if v <= b:
            return b
    return -(-v // 512) * 512


class DeviceLoader(BatchLoader):
    """Batch loader with on-device preprocessing; the batch sizes, the epoch
    order, the device and TPU.DEVICE_SYNTHESIS are ``BatchLoader``'s.
    ``device="cpu"`` runs the plain versions of the kernels (tests)."""

    def __init__(self, dataset, cfg, **kwargs):
        super().__init__(dataset, cfg, **kwargs)
        self.engine = str(cfg.TPU.WARP_ENGINE)

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

    def _crops(self, images, trans_inv, mask_box):
        """The batch's crops (B, H, W, 3) f32 on the card, from the uint8
        bucket: the warp zeroes the pixels outside each mask rectangle
        itself (images.float() * inside, never materialised), then the
        rounding of the host path's uint8 warp (cv2 rounds)."""
        crops = warp_affine_general(images, trans_inv, (self.img_h, self.img_w), self.engine,
                                    mask_box=mask_box)
        return torch.round(crops)

    def __iter__(self):
        for idxs, conds, meta in self._index_batches():
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
            batch.update(meta)
            crops = self._crops(to_device(images, self.device),
                                *(to_device(batch[k], self.device)
                                  for k in ("trans_inv", "mask_box")))
            yield self._dense(batch, crops)
