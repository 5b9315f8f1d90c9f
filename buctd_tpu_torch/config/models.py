"""Per-architecture default MODEL.EXTRA trees (reference: lib/config/models.py).

Mostly superseded by ``MODEL.EXTRA: new_allowed`` in the experiment YAMLs, but kept
for API parity and as programmatic defaults for users building configs in code.
"""

from .node import CfgNode as CN


def _pose_resnet_extra() -> CN:
    c = CN()
    c.NUM_LAYERS = 50
    c.DECONV_WITH_BIAS = False
    c.NUM_DECONV_LAYERS = 3
    c.NUM_DECONV_FILTERS = [256, 256, 256]
    c.NUM_DECONV_KERNELS = [4, 4, 4]
    c.FINAL_CONV_KERNEL = 1
    c.PRETRAINED_LAYERS = ["*"]
    return c


def _hrnet_extra(width: int = 32) -> CN:
    c = CN()
    c.PRETRAINED_LAYERS = ["*"]
    c.STEM_INPLANES = 64
    c.FINAL_CONV_KERNEL = 1
    c.USE_PRE_NET = False
    c.USE_ATTENTION = False
    for i, (branches, modules) in enumerate([(2, 1), (3, 4), (4, 3)], start=2):
        s = CN()
        s.NUM_MODULES = modules
        s.NUM_BRANCHES = branches
        s.NUM_BLOCKS = [4] * branches
        s.NUM_CHANNELS = [width * (2 ** b) for b in range(branches)]
        s.BLOCK = "BASIC"
        s.FUSE_METHOD = "SUM"
        c[f"STAGE{i}"] = s
    return c


MODEL_EXTRAS = {
    "pose_resnet": _pose_resnet_extra(),
    "pose_high_resolution_net": _hrnet_extra(32),
    "pose_hrnet": _hrnet_extra(32),
    "pose_hrnet_w48": _hrnet_extra(48),
}
