"""BUCTD-CoAM: HRNet trunk + per-stage conditional cross-attention, NCHW.

Counterpart of buctd_tpu/models/hrnet_coam.py (lib/models/pose_hrnet_coam.py:
488-572).  The input splits into RGB (channels :3, fed to the stem) and the
condition map (channels 3:); CoAM blocks run right after transitions 1/2/3 and
after stage4, gated by MODEL.ATT_MODULES.  The model subclasses the trunk, so
its parameters keep the reference's top-level names ("conv1", "stage2_att",
"final_layer", ...).
"""

from __future__ import annotations

import dataclasses

from .coam import CoAMBlock, SelfAttentionModule
from .hrnet import HRNetSpec, HRNetTrunk, branch_sizes, conv


@dataclasses.dataclass(frozen=True)
class CoAMSpec:
    att_modules: tuple       # 4 bools: CoAM after transition1/2/3 + after stage4
    selfatt_modules: tuple   # 4 bools
    d_cond: int              # J if stacked, 3 if colored, else 1
    n_heads: int
    channel_only: bool

    @staticmethod
    def from_cfg(cfg) -> "CoAMSpec":
        if cfg.DATASET.STACKED_CONDITION:
            d_cond = int(cfg.MODEL.NUM_JOINTS)
        elif cfg.DATASET.COLORED:
            d_cond = 3
        else:
            d_cond = 1
        att = tuple(bool(b) for b in cfg.MODEL.ATT_MODULES)
        satt = tuple(bool(b) for b in cfg.MODEL.SELFATT_MODULES)
        for a, s in zip(att, satt):
            if a and s:
                raise ValueError("ATT_MODULES and SELFATT_MODULES are mutually "
                                 "exclusive per stage")
        return CoAMSpec(att_modules=att, selfatt_modules=satt, d_cond=d_cond,
                        n_heads=int(cfg.MODEL.ATTENTION_HEADS),
                        channel_only=bool(cfg.MODEL.ATT_CHANNEL_ONLY))


class PoseHRNetCoAM(HRNetTrunk):
    """(B, 3 + c, H, W) -> (B, num_joints, H/4, W/4) heatmaps.

    ``image_hw`` fixes the branch resolutions, which size the channel modules'
    output linears (H*W x H*W), as in the reference.
    """

    def __init__(self, spec: HRNetSpec, coam: CoAMSpec, image_hw, engine: str = "auto"):
        super().__init__(spec)
        self.coam = coam
        sizes = branch_sizes(image_hw)
        stage_channels = [spec.stage2.num_channels, spec.stage3.num_channels,
                          spec.stage4.num_channels, (spec.stage4.num_channels[0],)]
        self._att_stages = []
        for s in range(4):
            chans = stage_channels[s]
            if coam.att_modules[s]:
                block = CoAMBlock(chans, sizes[:len(chans)], coam.d_cond,
                                  coam.n_heads, coam.channel_only, engine)
            elif coam.selfatt_modules[s]:
                block = SelfAttentionModule(chans, sizes[:len(chans)], engine)
            else:
                continue
            setattr(self, f"stage{s + 1}_att", block)
            if coam.att_modules[s]:
                self._att_stages.append(s)
        k = spec.final_conv_kernel
        self.final_layer = conv(spec.stage4.num_channels[0], spec.num_joints, k,
                                pad=k // 2, bias=True)

    def forward(self, x):
        if x.shape[1] <= 3:
            raise ValueError("CoAM needs RGB + condition channels, got "
                             f"{x.shape[1]} channels")
        rgb, cond_hm = x[:, :3], x[:, 3:]
        # Reference quirk (pose_hrnet_coam.py:521-562): every injection site is
        # gated on ATT_MODULES only, so a SelfAttentionModule built from
        # SELFATT_MODULES is never called; it exists for the checkpoint layout.
        taps = [None] * 4
        for s in self._att_stages:
            taps[s] = getattr(self, f"stage{s + 1}_att")
        ys = super().forward(rgb, taps=taps, tap_arg=cond_hm)
        return self.final_layer(ys[0])


def get_pose_net(cfg, engine: str = "auto") -> PoseHRNetCoAM:
    img_w, img_h = cfg.MODEL.IMAGE_SIZE
    return PoseHRNetCoAM(HRNetSpec.from_cfg(cfg), CoAMSpec.from_cfg(cfg),
                         (int(img_h), int(img_w)), engine=engine)
