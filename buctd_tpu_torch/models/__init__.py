"""Model registry, keyed by the reference's MODEL.NAME values.

Counterpart of buctd_tpu/models/__init__.py.  ``pose_hrnet_coam``,
``pose_hrnet`` (with the BUCTD preNet) and ``transpose_h`` (BUCTD-TransPose-H)
are ported; ``pose_resnet`` raises and names its ROADMAP item.  The
attention engine is ``cfg.TPU.ATTENTION_ENGINE``, passed to the constructors.
"""

from __future__ import annotations

import torch

from . import hrnet, hrnet_coam, transpose
from .remat import remat_mode

_REGISTRY = {"pose_hrnet_coam": hrnet_coam.get_pose_net, "pose_hrnet": hrnet.get_pose_net,
             "transpose_h": transpose.get_pose_net}

_NOT_PORTED = {
    "pose_resnet": "ROADMAP Queue 1, 'pose_resnet (models/resnet.py)'",
}


def get_model(cfg, device="cuda") -> torch.nn.Module:
    """The cfg's model with the reference's init (N(0, 0.001) weights), in eval
    mode, on ``device``.  The device defaults to "cuda" and this raises where
    CUDA is absent; pass ``device="cpu"`` for the CPU."""
    from .hrnet import init_weights

    name = cfg.MODEL.NAME
    if name in _NOT_PORTED:
        raise NotImplementedError(f"MODEL.NAME {name!r} is not ported to "
                                  f"buctd_tpu_torch yet: {_NOT_PORTED[name]}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown MODEL.NAME {name!r}; known: "
                       f"{sorted(_REGISTRY) + sorted(_NOT_PORTED)}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("get_model: CUDA is not available; pass device='cpu' "
                           "to build the model on the CPU")
    model = _REGISTRY[name](cfg, engine=str(cfg.TPU.ATTENTION_ENGINE))
    if hasattr(model, "remat"):
        # the in-model units of TPU.REMAT, active in training mode only;
        # 'forward' checkpoints the whole forward (train/state.py)
        mode = remat_mode(cfg)
        model.remat = "" if mode == "forward" else mode
    init_weights(model)
    return model.to(device).eval()


def compute_dtype(cfg, key: str = "COMPUTE_DTYPE") -> torch.dtype:
    """cfg.TPU.<key> -> torch dtype."""
    name = str(getattr(cfg.TPU, key, "float32")).lower()
    dtypes = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
              "float32": torch.float32, "f32": torch.float32}
    if name not in dtypes:
        raise ValueError(f"TPU.{key}={name!r}: expected float32 or bfloat16")
    return dtypes[name]


__all__ = ["get_model", "compute_dtype"]
