"""Exported serving artifacts: the bucketed serving programs as ``torch.export``
programs.

Counterpart of buctd_tpu/serving_export.py, whose contract it keeps.
``export_estimator`` traces ``PoseEstimator.refine`` (crop, render, forward,
decode, the refinement rounds: core/refine.py) once per bucket shape with
``torch.export``; ``ExportedPoseEstimator`` loads the programs and serves
them with no model or config code of the port and no Python re-tracing.  It
imports only ``buctd_tpu_torch.ops``, where the flash-attention forward is
the operator ``torch.ops.buctd.flash_fwd`` (ops/flash_attention.py): the
programs hold it as one node, and a loaded program on the card launches the
hand kernel, K1.

Artifact layout (a directory):

    manifest.json             format version, model and joint metadata, the
                              eval dtype, the device type, program keys
    params.npz                the model's state_dict (parameters and
                              buffers) by the port's names
    prog_<h>x<w>x<p>.pt2      single-image refine program
                              (params, (h,w,3) u8, (p,J,3) f32, (2,) f32)
    prog_<n>x<h>x<w>x<p>.pt2  the same over n images

The weights travel as arguments (params.npz), not inside each program, as in
JAX: the programs stay small, and one artifact serves updated weights of the
same structure.

Caveat: what is chosen at trace time is baked into the program, as JAX's
engine choice is (buctd_tpu/serving_export.py:25-30).  That is the dtype
(``TPU.EVAL_DTYPE``: the bf16 autocast region and its casts), the device
(a program traced on the card has CUDA tensors and runs there, one traced
on the CPU runs there), the attention engine's choice (``auto`` takes the
flash operator on CUDA tensors only) and ``BUCTD_FLASH_KVRES`` (K1 or K1').
Export for the device you serve on, with the settings you serve with.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .buckets import canonical, finish, image_key, pad_image, pad_rows, to_host

FORMAT_VERSION = 1


def _program_name(key) -> str:
    return "prog_" + "x".join(str(v) for v in key) + ".pt2"


class _Refine(torch.nn.Module):
    """``refine`` with the model as the one submodule, so that
    ``torch.func.functional_call`` swaps its parameters and buffers for the
    program's arguments."""

    def __init__(self, model, refine):
        super().__init__()
        self.model = model
        self.refine = refine

    def forward(self, image, conds, img_wh):
        return self.refine(image, conds, img_wh=img_wh)


class _Program(torch.nn.Module):
    """The traced callable: (params, image, conds, img_wh) -> (preds,
    maxvals).  It holds the model outside its own modules, so the traced
    program takes every weight as an argument and stores none."""

    def __init__(self, model, refine):
        super().__init__()
        self.__dict__["inner"] = _Refine(model, refine)   # not a submodule

    def forward(self, params, image, conds, img_wh):
        params = {"model." + k: v for k, v in params.items()}
        return torch.func.functional_call(self.inner, params, (image, conds, img_wh))


def export_estimator(est, shapes, out_dir: str) -> dict:
    """Write ``est``'s serving programs at ``shapes`` into ``out_dir``.

    shapes: (h, w, p) single-image keys and/or (n, h, w, p) batched keys,
    the tuples ``PoseEstimator(precompile=...)`` takes; h, w and p snap up
    to the bucket tables, n is kept (buctd_tpu/serving_export.py:146-151).
    Each program is traced on ``est``'s device in its dtype.  A ``mesh=``
    estimator exports the per-device program: its first replica's, at the
    key's own shape, the program an estimator without a mesh exports
    (buctd_tpu/serving_export.py:97-98; serving over a mesh splits the rows
    at the call site).  Returns the manifest.
    """
    os.makedirs(out_dir, exist_ok=True)
    state = {k: v.detach() for k, v in est.model.state_dict().items()}
    program = _Program(est.model, est.refine)
    dev, J = est.device, est.num_joints
    keys = []
    for key in shapes:
        key = tuple(int(v) for v in key)
        lead = key[:-3]
        key = lead + image_key(*key[-3:])
        hb, wb, pb = key[-3:]
        example = (torch.zeros(lead + (hb, wb, 3), dtype=torch.uint8, device=dev),
                   torch.ones(lead + (pb, J, 3), device=dev),
                   torch.ones(lead + (2,), device=dev))
        prog = torch.export.export(program, (state, *example), strict=False)
        prog.example_inputs = None   # else the file keeps a copy of every weight
        torch.export.save(prog, os.path.join(out_dir, _program_name(key)))
        if list(key) not in keys:
            keys.append(list(key))

    np.savez(os.path.join(out_dir, "params.npz"),
             **{k: v.cpu().numpy() for k, v in state.items()})
    manifest = {
        "format_version": FORMAT_VERSION,
        "model_name": str(est.cfg.MODEL.NAME),
        "num_joints": J,
        "refine_iters": est.refine_iters,
        "eval_dtype": str(est.dtype).removeprefix("torch."),
        "platforms": [dev.type],
        "programs": keys,
        "torch_version": torch.__version__,
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ExportedPoseEstimator:
    """Serve from an exported artifact directory: no model or config code.

    Mirrors ``PoseEstimator.predict``, ``predict_many`` and ``predict_batch``
    with the same bucketing and padding contract, but every program comes
    from ``torch.export.load``.  Only the bucket shapes in the artifact
    exist; a call that no exported bucket contains raises (the artifact is
    the compile contract: nothing to fall back to).  ``device`` defaults to
    "cuda" and must be the device type the artifact was exported on; on the
    card each program is replayed as a CUDA graph (graphs.py::BucketGraphs,
    captured at its first call).
    """

    def __init__(self, path: str, device="cuda"):
        from .ops import flash_attention  # noqa: F401  (registers torch.ops.buctd.flash_fwd)
        from .graphs import BucketGraphs

        self.path = path
        with open(os.path.join(path, "manifest.json")) as f:
            self.manifest = json.load(f)
        if self.manifest["format_version"] != FORMAT_VERSION:
            raise ValueError(f"artifact format {self.manifest['format_version']} != "
                             f"supported {FORMAT_VERSION}")
        self.device = torch.device(device)
        if self.device.type not in self.manifest["platforms"]:
            raise ValueError(f"{path} was exported for {self.manifest['platforms']}, "
                             f"not {self.device.type}: export it on the device you serve on")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ExportedPoseEstimator: CUDA is not available; this "
                               "artifact was exported for the card")
        self.num_joints = int(self.manifest["num_joints"])
        with np.load(os.path.join(path, "params.npz")) as z:
            self.params = {k: torch.from_numpy(z[k]).to(self.device) for k in z.files}
        self._progs: dict = {}
        self._single = sorted(tuple(k) for k in self.manifest["programs"] if len(k) == 3)
        self._batched = sorted(tuple(k) for k in self.manifest["programs"] if len(k) == 4)
        self._graphs = BucketGraphs(self.device) if self.device.type == "cuda" else None

    def _load(self, key):
        """The loaded program of ``key`` (an fx GraphModule), loaded once."""
        if key not in self._progs:
            path = os.path.join(self.path, _program_name(key))
            self._progs[key] = torch.export.load(path).module()
        return self._progs[key]

    def _run(self, key, image, conds, img_wh) -> np.ndarray:
        prog, params = self._load(key), self.params

        def fn(image, conds, img_wh):
            return prog(params, image, conds, img_wh)

        if self._graphs is None:
            preds, maxvals = fn(*map(torch.from_numpy, (image, conds, img_wh)))
        else:
            self._graphs.capture(key, fn, image, conds, img_wh)
            preds, maxvals = self._graphs.run(key, image, conds, img_wh)
        return to_host(preds, maxvals)

    def _pick(self, hb, wb, pb):
        fits = sorted((k for k in self._single if k[0] >= hb and k[1] >= wb and k[2] >= pb),
                      key=lambda k: (k[0] * k[1] * k[2], k))
        if not fits:
            raise RuntimeError(f"no exported program contains shape {(hb, wb, pb)}; artifact "
                               f"has {self._single} — re-export with the shapes you serve")
        return fits[0]

    def predict(self, image, condition_poses, vis_thres: float = 0.0):
        """Same contract as PoseEstimator.predict."""
        image, conds = canonical(image, condition_poses)
        P = conds.shape[0]
        key = self._pick(*image_key(*image.shape[:2], P))
        return finish(self._run(key, *pad_image(image, conds, *key)), P, vis_thres)

    def predict_many(self, images, conditions, vis_thres: float = 0.0) -> list:
        return [self.predict(img, conds, vis_thres) for img, conds in zip(images, conditions)]

    def predict_batch(self, images, conditions, vis_thres: float = 0.0) -> list:
        """Batch same-bucket images into exported (n, h, w, p) programs where
        the artifact has them; images with no batched program that contains
        them go image by image (which raises only where no single-image
        program contains them either)."""
        pairs = [canonical(im, cs) for im, cs in zip(images, conditions)]
        groups: dict = {}
        for idx, (im, cs) in enumerate(pairs):
            # the cheapest exported batched (h, w, p) that contains this image
            fits = sorted((k for k in self._batched if k[1] >= im.shape[0]
                           and k[2] >= im.shape[1] and k[3] >= cs.shape[0]),
                          key=lambda k: (k[1] * k[2] * k[3], k))
            groups.setdefault(fits[0][1:] if fits else None, []).append(idx)

        out: list = [None] * len(pairs)
        for key, idxs in groups.items():
            if key is None:
                for q in idxs:
                    out[q] = self.predict(*pairs[q], vis_thres)
                continue
            counts = sorted(k[0] for k in self._batched if k[1:] == key)
            for pos in range(0, len(idxs), counts[-1]):
                chunk = idxs[pos:pos + counts[-1]]
                if len(chunk) == 1:
                    im, cs = pairs[chunk[0]]
                    try:   # a single-image program that fits is cheaper
                        self._pick(*image_key(*im.shape[:2], cs.shape[0]))
                    except RuntimeError:
                        pass   # a batched-only artifact: pad rows
                    else:
                        out[chunk[0]] = self.predict(im, cs, vis_thres)
                        continue
                bkey = (next(n for n in counts if n >= len(chunk)),) + key
                res = self._run(bkey, *pad_rows([pairs[q] for q in chunk], *bkey))
                for row, q in enumerate(chunk):
                    out[q] = finish(res[row], pairs[q][1].shape[0], vis_thres)
        return out
