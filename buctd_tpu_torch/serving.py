"""Serving API: conditioned top-down pose estimation on one CUDA device.

Counterpart of buctd_tpu/serving.py::PoseEstimator.  Each call pads its image
and its condition poses to the bucket tables (buckets.py) and runs the
refinement loop (core/refine.py) on the device; ``predict_batch`` runs the
crops of several same-bucket images as one N*P batch.

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

The compile bound is JAX's: at most ``max_compiles`` bucket shapes, (h, w, p)
for ``predict`` and (n, h, w, p) for ``predict_batch``, are ever admitted;
once the budget is spent a call pads up into the cheapest admitted bucket
that contains it, a batch into an admitted count bucket or else image by
image, and a call that no admitted bucket contains raises.
``precompile=[(h, w, p) or (n, h, w, p), ...]`` admits and warms shapes at
start-up.  On the card an admitted bucket is one CUDA graph of ``refine``
(graphs.py::BucketGraphs, captured at its first call or at ``precompile``),
replayed from then on; on the CPU the same bookkeeping runs ``refine``
eagerly.  ``refine`` itself stays the eager function.  ``export`` writes the
admitted kind of program as a ``torch.export`` artifact
(serving_export.py).

``mesh=`` (parallel/mesh.py::make_mesh, JAX serving.py:87-133) serves over
the mesh's local devices: each holds a replica of the model (and, on the
card, its own pool of graphs), ``predict_batch`` splits a chunk's padded
image rows into one equal contiguous block a device, runs the blocks at
once (a thread a device) and concatenates them in order; the count buckets
are (1, 2, 4, 8) x ``mesh.size``, so every device gets whole rows; and
``predict`` runs on the first device, as JAX's un-meshed ``refine`` does.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from concurrent.futures import ThreadPoolExecutor

from .buckets import (COUNT_BUCKETS, bucket, canonical, finish, image_key, pad_image,
                      pad_rows, to_host)
from .core.refine import make_refine_fn
from .data.joints_dataset import rainbow_colors
from .graphs import BucketGraphs

logger = logging.getLogger(__name__)


class PoseEstimator:
    """Conditional top-down pose estimation as a persistent service.

    ``device`` defaults to "cuda" and the constructor raises where CUDA is
    absent: there is no silent CPU path.  Pass ``device="cpu"`` to run the plain
    versions of the kernels on the CPU (the tests do).  ``max_compiles`` and
    ``precompile`` as buctd_tpu/serving.py:41-49 (the module docstring).
    ``mesh`` (a parallel/mesh.py ``Mesh``) serves over its local devices, and
    then the device is its first.
    """

    def __init__(self, cfg, checkpoint: str | None = None, refine_iters: int = 1,
                 colors=None, max_compiles: int = 12, precompile=None, device="cuda",
                 mesh=None):
        from .convert import load_checkpoint
        from .models import compute_dtype, get_model

        self.mesh = mesh
        if mesh is not None:
            device = mesh.devices[0]
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
        if checkpoint:   # a BUCTD .pth/.pt, or an orbax directory of JAX's save_params
            self.model.load_state_dict(load_checkpoint(checkpoint), strict=True)
        self.model.to(self.device).eval()
        # the eval-time preNet fusion (TPU.FUSED_PRENET), after the load as
        # buctd_tpu/serving.py:78-80 does it
        from .models.fuse import maybe_fuse_prenet
        self.model = maybe_fuse_prenet(cfg, self.model)
        self.colors = (np.asarray(colors) if colors is not None
                       else rainbow_colors(self.num_joints))
        self.refine_iters = max(int(refine_iters), 1)
        models = [self.model]
        if mesh is not None:
            from .parallel.mesh import replicate
            models = replicate(self.model, mesh)
        # (refine, graphs) a device; the first serves predict
        self._replicas = [
            (make_refine_fn(cfg, m, self.colors, n_iters=self.refine_iters),
             BucketGraphs(d) if self.device.type == "cuda" else None)
            for m, d in zip(models, mesh.devices if mesh is not None else [self.device])]
        self.refine, self._graphs = self._replicas[0]
        self._pool = (ThreadPoolExecutor(len(self._replicas)) if len(self._replicas) > 1
                      else None)
        self.count_buckets = (COUNT_BUCKETS if mesh is None
                              else tuple(b * mesh.size for b in (1, 2, 4, 8)))
        self.max_compiles = int(max_compiles)
        self._compiled: set = set()   # admitted (h, w, p) and (n, h, w, p) buckets
        for key in (precompile or ()):   # (h, w, p), or (n, h, w, p) for predict_batch
            key = tuple(int(v) for v in key)
            lead = (bucket(key[0], self.count_buckets),) if len(key) == 4 else ()
            key = lead + image_key(*key[-3:])
            self._compiled.add(key)
            self._run(key, np.zeros(key[:-1] + (3,), np.uint8),
                      np.ones(lead + (key[-1], self.num_joints, 3), np.float32),
                      np.ones(lead + (2,), np.float32), warm_only=True)

    def _run(self, key, image, conds, img_wh, warm_only: bool = False):
        """``refine`` on inputs padded to bucket ``key`` -> (..., J, 3) on the
        host: on the card the key's graph replayed (captured at its first
        call), on the CPU the eager function.  A batched key over a mesh
        runs one equal block of the rows a device, at once, and concatenates
        them in order.  ``warm_only`` captures the graphs and runs nothing."""
        k = len(self._replicas)
        if len(key) == 4 and k > 1:
            sub = (key[0] // k,) + key[1:]
            blocks = [(sub, *parts) for parts in zip(*(np.split(a, k)
                                                       for a in (image, conds, img_wh)))]
        else:
            blocks = [(key, image, conds, img_wh)]

        pairs = list(zip(self._replicas, blocks))
        # captures one at a time: a capture forbids other threads' CUDA calls
        for (refine, graphs), (bkey, *inputs) in pairs:
            if graphs is not None:
                graphs.capture(bkey, refine, *inputs)
        if warm_only:
            return None

        def one(pair):
            (refine, graphs), (bkey, *inputs) = pair
            if graphs is not None:
                return graphs.run(bkey, *inputs)
            return refine(*map(torch.from_numpy, inputs))

        outs = list(self._pool.map(one, pairs)) if len(pairs) > 1 else [one(pairs[0])]
        return np.concatenate([to_host(*o) for o in outs], axis=0)

    def _pick_bucket(self, hb: int, wb: int, pb: int):
        """Bucket key to run at, honoring the compile budget: the call's own
        bucket if admitted or if the budget has room, else the cheapest
        admitted bucket that contains it, by h * w * p; none raises."""
        key = (hb, wb, pb)
        if key in self._compiled or len(self._compiled) < self.max_compiles:
            self._compiled.add(key)
            return key
        fits = sorted((k for k in self._compiled
                       if len(k) == 3 and k[0] >= hb and k[1] >= wb and k[2] >= pb),
                      key=lambda k: (k[0] * k[1] * k[2], k))
        if not fits:
            raise RuntimeError(
                f"shape {key} needs a new compile but the max_compiles="
                f"{self.max_compiles} budget is spent and no compiled bucket "
                f"{sorted(self._compiled)} contains it; raise max_compiles or "
                f"precompile the shapes you serve")
        logger.warning("serving shape %s padded up into compiled bucket %s "
                       "(compile budget spent)", key, fits[0])
        return fits[0]

    def predict(self, image, condition_poses, vis_thres: float = 0.0) -> np.ndarray:
        """image: (H, W, 3) RGB, 0..255; condition_poses: (P, J, 2 or 3)
        image-frame poses.  Returns (P, J, 3) [x, y, conf] in image coords."""
        image, conds = canonical(image, condition_poses)
        P = conds.shape[0]
        hb, wb, pb = self._pick_bucket(*image_key(*image.shape[:2], P))
        padded = pad_image(image, conds, hb, wb, pb)
        return finish(self._run((hb, wb, pb), *padded), P, vis_thres)

    def predict_many(self, images, conditions, vis_thres: float = 0.0) -> list:
        """``predict`` over (image, condition_poses) pairs, one call each
        (buctd_tpu/serving.py:205); ``predict_batch`` batches them."""
        return [self.predict(img, conds, vis_thres)
                for img, conds in zip(images, conditions)]

    def export(self, shapes, out_dir: str) -> dict:
        """Write this estimator's serving programs at ``shapes`` as a
        ``torch.export`` artifact directory (serving_export.py; serve it back
        with ExportedPoseEstimator or ``tools/serve.py --exported``)."""
        from .serving_export import export_estimator
        return export_estimator(self, shapes, out_dir)

    def predict_batch(self, images, conditions, vis_thres: float = 0.0) -> list:
        """Process many (image, condition_poses) pairs: images of one
        (height, width, poses) bucket run as one batch of N*P crops, in chunks
        of up to ``count_buckets[-1]`` images padded to a count bucket (over
        a mesh, one equal block of the rows a device).  A chunk
        rides the smallest admitted count bucket that holds it; where the
        budget admits no batched shape, its images run one by one
        (buctd_tpu/serving.py:214-282).  Returns a list of (P_i, J, 3) arrays
        in input order."""
        pairs = [canonical(im, cs) for im, cs in zip(images, conditions)]
        groups: dict = {}
        for idx, (im, cs) in enumerate(pairs):
            groups.setdefault(image_key(*im.shape[:2], cs.shape[0]), []).append(idx)

        out: list = [None] * len(pairs)
        for (hb, wb, pb), idxs in groups.items():
            for pos in range(0, len(idxs), self.count_buckets[-1]):
                chunk = idxs[pos:pos + self.count_buckets[-1]]
                if len(chunk) == 1:
                    out[chunk[0]] = self.predict(*pairs[chunk[0]], vis_thres)
                    continue
                nb = bucket(len(chunk), self.count_buckets)
                bkey = (nb, hb, wb, pb)
                if bkey not in self._compiled:
                    # pad rows into an admitted count bucket rather than admit
                    # a new one for a remainder chunk
                    fits = sorted(k[0] for k in self._compiled
                                  if len(k) == 4 and k[1:] == (hb, wb, pb)
                                  and k[0] >= len(chunk))
                    if fits:
                        nb, bkey = fits[0], (fits[0], hb, wb, pb)
                if not (bkey in self._compiled or len(self._compiled) < self.max_compiles):
                    logger.warning("batched shape %s needs a new compile but the budget "
                                   "is spent; falling back to the per-image path", bkey)
                    for q in chunk:
                        out[q] = self.predict(*pairs[q], vis_thres)
                    continue
                self._compiled.add(bkey)
                res = self._run(bkey, *pad_rows([pairs[q] for q in chunk], *bkey))
                for row, q in enumerate(chunk):
                    out[q] = finish(res[row], pairs[q][1].shape[0], vis_thres)
        return out
