"""Serving API: conditioned top-down pose estimation on one CUDA device.

Counterpart of buctd_tpu/serving.py::PoseEstimator.  Each call pads its image
and its condition poses to the bucket tables and runs the refinement loop
(core/refine.py) on the device; ``predict_batch`` runs the crops of several
same-bucket images as one N*P batch.

    est = PoseEstimator(cfg, checkpoint="model.pth", refine_iters=3)
    preds = est.predict(image_rgb, condition_poses)   # (P, J, 3) image coords

The model is the cfg's: BUCTD-CoAM (``pose_hrnet_coam``), BUCTD-TransPose-H
(``transpose_h``) or BUCTD-preNet (``pose_hrnet`` with ``USE_PRE_NET``), whose
preNet is fused after the checkpoint load when ``TPU.FUSED_PRENET`` is not
"off" (models/fuse.py).  It runs in ``TPU.EVAL_DTYPE``: float32 (exact: the
constructor turns TF32 off for cuBLAS and cuDNN) or bfloat16 (f32 parameters
under bf16 autocast, bf16 heatmaps, the warp and the render on TF32
operands, core/refine.py), as JAX's estimator builds its model with that
dtype.  No call reads or sets the TF32 flags, so an f32 and a bf16
estimator keep their own numerics in one process.

The JAX estimator's ``max_compiles`` and ``precompile`` bound XLA compiles; an
eager PyTorch model compiles nothing, so they do not exist here.  The bucket
tables stay, so that a later per-bucket CUDA graph has a bounded shape set
(ROADMAP Queue 1).  Data-parallel serving over several cards (the JAX
``mesh=``) is queued there too.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.refine import make_refine_fn
from .data.joints_dataset import rainbow_colors

IMG_BUCKETS = (256, 384, 512, 640, 768, 1024, 1536, 2048)
POSE_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
COUNT_BUCKETS = (2, 4, 8)   # images per batched call (1 = the unbatched path)


def _bucket(v: int, buckets) -> int:
    for b in buckets:
        if v <= b:
            return b
    return v


def _canon(image, condition_poses):
    """image -> uint8 (H, W, 3); poses -> f32 (P, J, 3) with conf 1 if absent."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = np.clip(image, 0, 255).astype(np.uint8)
    conds = np.asarray(condition_poses, np.float32)
    if conds.ndim == 2:
        conds = conds[None]
    if conds.shape[-1] == 2:
        conds = np.concatenate([conds, np.ones((*conds.shape[:-1], 1), np.float32)], -1)
    return image, conds


class PoseEstimator:
    """Conditional top-down pose estimation as a persistent service.

    ``device`` defaults to "cuda" and the constructor raises where CUDA is
    absent: there is no silent CPU path.  Pass ``device="cpu"`` to run the plain
    versions of the kernels on the CPU (the tests do).
    """

    def __init__(self, cfg, checkpoint: str | None = None, refine_iters: int = 1,
                 colors=None, device="cuda"):
        from .convert import load_torch_checkpoint
        from .models import compute_dtype, get_model

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PoseEstimator: CUDA is not available; pass "
                               "device='cpu' to run on the CPU")
        if self.device.type == "cuda":
            # f32 means f32: cuDNN convs default to TF32, which keeps ~3 digits
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        self.dtype = compute_dtype(cfg, "EVAL_DTYPE")
        self.cfg = cfg
        self.num_joints = int(cfg.MODEL.NUM_JOINTS)
        self.model = get_model(cfg, device=self.device)
        if checkpoint:
            if not checkpoint.endswith((".pth", ".pt")):
                raise ValueError(f"{checkpoint!r}: buctd_tpu_torch loads BUCTD "
                                 ".pth/.pt checkpoints only")
            self.model.load_state_dict(load_torch_checkpoint(checkpoint), strict=True)
        self.model.to(self.device).eval()
        # the eval-time preNet fusion (TPU.FUSED_PRENET), after the load as
        # buctd_tpu/serving.py:78-80 does it
        from .models.fuse import maybe_fuse_prenet
        self.model = maybe_fuse_prenet(cfg, self.model)
        self.colors = (np.asarray(colors) if colors is not None
                       else rainbow_colors(self.num_joints))
        self.refine_iters = max(int(refine_iters), 1)
        self.refine = make_refine_fn(cfg, self.model, self.colors,
                                     n_iters=self.refine_iters)

    @staticmethod
    def _to_host(preds, maxvals) -> np.ndarray:
        """(..., J, 2) and (..., J, 1) device tensors -> (..., J, 3) f32 numpy,
        one copy (bf16 maxvals widened exactly)."""
        return torch.cat([preds, maxvals.float()], dim=-1).cpu().numpy()

    @staticmethod
    def _finish(res: np.ndarray, P: int, vis_thres: float) -> np.ndarray:
        out = res[:P]
        out[out[:, :, 2] < vis_thres] = np.nan
        return out

    def predict(self, image, condition_poses, vis_thres: float = 0.0) -> np.ndarray:
        """image: (H, W, 3) RGB, 0..255; condition_poses: (P, J, 2 or 3)
        image-frame poses.  Returns (P, J, 3) [x, y, conf] in image coords."""
        image, conds = _canon(image, condition_poses)
        P = conds.shape[0]
        hb, wb = _bucket(image.shape[0], IMG_BUCKETS), _bucket(image.shape[1], IMG_BUCKETS)
        pb = _bucket(P, POSE_BUCKETS)
        img_pad = np.zeros((hb, wb, 3), np.uint8)
        img_pad[:image.shape[0], :image.shape[1]] = image
        if pb != P:   # pad with copies of the first pose
            conds = np.concatenate([conds, np.repeat(conds[:1], pb - P, 0)])
        true_wh = torch.tensor([image.shape[1], image.shape[0]], dtype=torch.float32)
        preds, maxvals = self.refine(torch.from_numpy(img_pad), torch.from_numpy(conds),
                                     img_wh=true_wh)
        return self._finish(self._to_host(preds, maxvals), P, vis_thres)

    def predict_many(self, images, conditions, vis_thres: float = 0.0) -> list:
        """``predict`` over (image, condition_poses) pairs, one call each
        (buctd_tpu/serving.py:205); ``predict_batch`` batches them."""
        return [self.predict(img, conds, vis_thres)
                for img, conds in zip(images, conditions)]

    def predict_batch(self, images, conditions, vis_thres: float = 0.0) -> list:
        """Process many (image, condition_poses) pairs: images of one
        (height, width, poses) bucket run as one batch of N*P crops, in chunks
        of up to COUNT_BUCKETS[-1] images padded to a count bucket.  Returns a
        list of (P_i, J, 3) arrays in input order."""
        pairs = [_canon(im, cs) for im, cs in zip(images, conditions)]
        groups: dict = {}
        for idx, (im, cs) in enumerate(pairs):
            key = (_bucket(im.shape[0], IMG_BUCKETS), _bucket(im.shape[1], IMG_BUCKETS),
                   _bucket(cs.shape[0], POSE_BUCKETS))
            groups.setdefault(key, []).append(idx)

        out: list = [None] * len(pairs)
        for (hb, wb, pb), idxs in groups.items():
            for pos in range(0, len(idxs), COUNT_BUCKETS[-1]):
                chunk = idxs[pos:pos + COUNT_BUCKETS[-1]]
                if len(chunk) == 1:
                    out[chunk[0]] = self.predict(*pairs[chunk[0]], vis_thres)
                    continue
                nb = _bucket(len(chunk), COUNT_BUCKETS)
                imgs = np.zeros((nb, hb, wb, 3), np.uint8)
                cnds = np.zeros((nb, pb, self.num_joints, 3), np.float32)
                whs = np.ones((nb, 2), np.float32)
                for row, q in enumerate(chunk):
                    im, cs = pairs[q]
                    imgs[row, :im.shape[0], :im.shape[1]] = im
                    cnds[row, :cs.shape[0]] = cs
                    cnds[row, cs.shape[0]:] = cs[:1]   # pad with the first pose
                    whs[row] = (im.shape[1], im.shape[0])
                for row in range(len(chunk), nb):       # pad rows: repeat the last
                    imgs[row], cnds[row], whs[row] = imgs[row - 1], cnds[row - 1], whs[row - 1]
                preds, maxvals = self.refine(torch.from_numpy(imgs), torch.from_numpy(cnds),
                                             img_wh=torch.from_numpy(whs))
                res = self._to_host(preds, maxvals)
                for row, q in enumerate(chunk):
                    out[q] = self._finish(res[row], pairs[q][1].shape[0], vis_thres)
        return out
