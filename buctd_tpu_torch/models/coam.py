"""CoAM — Conditional Attention Modules (BUCTD-CoAM), NCHW.

Counterpart of buctd_tpu/models/coam.py and the reference's
lib/models/pose_hrnet_coam.py:631-801:

* PositionAttentionModule: 3x3 convs on features and condition, then
  cross-attention with the CONDITION as query and the features as key/value
  over the H*W spatial tokens.  Tokens are (B, H*W, C): NCHW
  ``flatten(2).transpose(1, 2)``, which is the JAX package's NHWC
  ``reshape(B, H*W, C)``.
* ChannelAttentionModule: attention over the C channel tokens whose feature dim
  is H*W (the NCHW ``flatten(2)``); its output linear acts on the H*W axis, so
  its weights are tied to the input resolution, as in the reference.
* DAModule: input + (position + channel), or input * channel when channel_only.
* CoAMBlock: one DAModule per resolution branch; the full-resolution condition
  map is bilinearly resized (no antialias) to each branch.
* SelfDAModule / SelfAttentionModule: the self-attention twins.  The reference
  builds them but never calls them (see models/hrnet_coam.py).
"""

from __future__ import annotations

from torch import nn

from ..ops.warp import resize_bilinear_nchw
from .attention import ScaledDotProductAttention, SimplifiedScaledDotProductAttention
from .hrnet import conv


def conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return conv(cin, cout, 3, bias=True)


class PositionAttentionModule(nn.Module):
    def __init__(self, d_model: int, d_cond: int | None, n_heads: int = 1,
                 self_att: bool = False, engine: str = "auto"):
        super().__init__()
        self.self_att = self_att
        self.cnn = conv3x3(d_model, d_model)
        if not self_att:
            self.cnn_cond = conv3x3(d_cond, d_cond)
        self.pa = ScaledDotProductAttention(
            in_dim_q=d_model if self_att else d_cond, in_dim_k=d_model,
            d_k=d_model, d_v=d_model, h=n_heads, engine=engine)

    def forward(self, x, cond=None):
        y = self.cnn(x).flatten(2).transpose(1, 2)             # (B, H*W, C)
        if self.self_att:
            return self.pa(y, y, y)
        yc = self.cnn_cond(cond).flatten(2).transpose(1, 2)    # (B, H*W, d_cond)
        return self.pa(yc, y, y)                               # (B, H*W, C)


class ChannelAttentionModule(nn.Module):
    def __init__(self, d_model: int, d_cond: int | None, hw: int, n_heads: int = 1,
                 self_att: bool = False):
        super().__init__()
        self.self_att = self_att
        self.cnn = conv3x3(d_model, d_model)
        if not self_att:
            self.cnn_cond = conv3x3(d_cond, d_model)
        self.pa = SimplifiedScaledDotProductAttention(d_model=hw, h=n_heads)

    def forward(self, x, cond=None):
        y = self.cnn(x).flatten(2)                             # (B, C, H*W)
        if self.self_att:
            return self.pa(y, y, y)
        yc = self.cnn_cond(cond).flatten(2)
        return self.pa(yc, y, y)                               # (B, C, H*W)


class DAModule(nn.Module):
    def __init__(self, d_model: int, d_cond: int, hw: int, n_heads: int = 1,
                 channel_only: bool = False, engine: str = "auto"):
        super().__init__()
        self.channel_only = channel_only
        self.channel_attention_module = ChannelAttentionModule(
            d_model, d_cond, hw, n_heads)
        if not channel_only:
            self.position_attention_module = PositionAttentionModule(
                d_model, d_cond, n_heads, engine=engine)

    def forward(self, x, cond):
        B, C, H, W = x.shape
        c_out = self.channel_attention_module(x, cond).reshape(B, C, H, W)
        if self.channel_only:
            return x * c_out
        p_out = self.position_attention_module(x, cond)
        p_out = p_out.transpose(1, 2).reshape(B, C, H, W)
        return x + (p_out + c_out)


class CoAMBlock(nn.Module):
    """One DAModule per branch; the condition is resized per branch
    (pose_hrnet_coam.py:750).  ``sizes`` are the branches' (H, W)."""

    def __init__(self, channel_list, sizes, d_cond: int, n_heads: int = 1,
                 channel_only: bool = False, engine: str = "auto"):
        super().__init__()
        self.d_cond = d_cond
        self.att_layers = nn.ModuleList([
            DAModule(c, d_cond, h * w, n_heads, channel_only, engine)
            for c, (h, w) in zip(channel_list, sizes)])

    def forward(self, ys, cond_hm):
        if self.d_cond == 1:
            cond_hm = cond_hm[:, :1]   # plain condition: single channel
        return [layer(y, resize_bilinear_nchw(cond_hm, y.shape[-2:]))
                for layer, y in zip(self.att_layers, ys)]


class SelfDAModule(nn.Module):
    def __init__(self, d_model: int, hw: int, engine: str = "auto"):
        super().__init__()
        self.position_attention_module = PositionAttentionModule(
            d_model, None, self_att=True, engine=engine)
        self.channel_attention_module = ChannelAttentionModule(
            d_model, None, hw, self_att=True)

    def forward(self, x):
        B, C, H, W = x.shape
        p_out = self.position_attention_module(x).transpose(1, 2).reshape(B, C, H, W)
        return p_out + self.channel_attention_module(x).reshape(B, C, H, W)


class SelfAttentionModule(nn.Module):
    def __init__(self, channel_list, sizes, engine: str = "auto"):
        super().__init__()
        self.att_layers = nn.ModuleList([
            SelfDAModule(c, h * w, engine) for c, (h, w) in zip(channel_list, sizes)])

    def forward(self, ys, cond_hm=None):
        del cond_hm
        return [layer(y) for layer, y in zip(self.att_layers, ys)]
