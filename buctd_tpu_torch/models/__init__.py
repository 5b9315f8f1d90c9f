"""Model registry, keyed by the reference's MODEL.NAME values.

Counterpart of buctd_tpu/models/__init__.py: ``pose_hrnet_coam``,
``pose_hrnet`` (with the BUCTD preNet), ``transpose_h`` (BUCTD-TransPose-H)
and ``pose_resnet`` (SimpleBaseline, with the BUCTD preNet).  The attention
engine is ``cfg.TPU.ATTENTION_ENGINE``, passed to the constructors.
"""

from __future__ import annotations

import contextlib

import torch

from . import hrnet, hrnet_coam, resnet, transpose
from .remat import remat_mode

_REGISTRY = {"pose_hrnet_coam": hrnet_coam.get_pose_net, "pose_hrnet": hrnet.get_pose_net,
             "transpose_h": transpose.get_pose_net, "pose_resnet": resnet.get_pose_net}


def get_model(cfg, device="cuda", lambda_head: bool = False) -> torch.nn.Module:
    """The cfg's model with the reference's init (N(0, 0.001) weights), in eval
    mode, on ``device``.  The device defaults to "cuda" and this raises where
    CUDA is absent; pass ``device="cpu"`` for the CPU.  ``lambda_head``
    builds pose_hrnet's lambda-conditioned head (the JAX model grows it when
    it is first called with ``lambda_vec``); the other models have none."""
    from .hrnet import init_weights

    name = cfg.MODEL.NAME
    if name not in _REGISTRY:
        raise KeyError(f"unknown MODEL.NAME {name!r}; known: {sorted(_REGISTRY)}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("get_model: CUDA is not available; pass device='cpu' "
                           "to build the model on the CPU")
    kw = {}
    if lambda_head:
        if name != "pose_hrnet":
            raise ValueError(f"MODEL.NAME {name!r} has no lambda head (pose_hrnet has)")
        kw["lambda_head"] = True
    model = _REGISTRY[name](cfg, engine=str(cfg.TPU.ATTENTION_ENGINE), **kw)
    if hasattr(model, "remat"):
        # the in-model units of TPU.REMAT, active in training mode only;
        # 'forward' checkpoints the whole forward (train/state.py)
        mode = remat_mode(cfg)
        model.remat = "" if mode == "forward" else mode
    init_weights(model)
    return model.to(device).eval()


def autocast(device, dtype: torch.dtype):
    """The context a forward in ``dtype`` runs under: for bf16, autocast on
    ``device``'s type, which keeps the parameters f32 and runs the convs and
    linears in bf16, as JAX's modules built with ``dtype=bfloat16``
    (buctd_tpu/serving.py:61-62, tools/test.py:85); for f32, none, so a
    traced f32 program (serving_export.py) carries no autocast region.  The
    callers own it (core/refine.py, core/function.py, train/state.py) and
    wrap only the model's call.  Autocast's cache of weight casts is off: a
    weight is cast at each use, to the same bf16 values, and a CUDA-graph
    capture or torch.export of the region (serving.py) takes no cache that
    outlives it."""
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(torch.device(device).type, dtype=dtype, cache_enabled=False)


def compute_dtype(cfg, key: str = "COMPUTE_DTYPE") -> torch.dtype:
    """cfg.TPU.<key> -> torch dtype."""
    name = str(getattr(cfg.TPU, key, "float32")).lower()
    dtypes = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
              "float32": torch.float32, "f32": torch.float32}
    if name not in dtypes:
        raise ValueError(f"TPU.{key}={name!r}: expected float32 or bfloat16")
    return dtypes[name]


__all__ = ["get_model", "compute_dtype", "autocast"]
