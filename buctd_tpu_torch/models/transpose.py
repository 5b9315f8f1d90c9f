"""BUCTD-TransPose-H: HRNet-small trunk (stages 2-3) + transformer encoder, NCHW.

Counterpart of buctd_tpu/models/transpose.py (lib/models/transpose_h.py:
419-681): stem + layer1 + stage2 + stage3 (its last module single-scale), a
1x1 ``reduce`` to d_model, with the condition the 1x1 ``trans_cond`` (3 -> 16)
of the resized condition channels concatenated (d = d_model + 16), a 2-D sine,
learnable or no position embedding, ``ENCODER_LAYERS`` DETR-style post-norm
encoder layers (the position added to q and k in each), then a 1x1 head.

Module and parameter names are the reference's (``global_encoder.layers.0.
self_attn.in_proj_weight``, ``pos_embedding``, ...), so a BUCTD checkpoint
loads with ``load_state_dict(strict=True)``.  The self-attention reaches K1
(ops/flash_attention.py) through ``models/attention.py::_attend``: never
torch's ``nn.MultiheadAttention``, whose forward calls SDPA.

Under bf16 autocast every layer rounds where flax's bf16 module does: the
biased linears add the bias after the product (models/hrnet.py::Linear), the
LayerNorms normalise in f32 and round their output, and q is divided by
sqrt(head dim) rounded to q's dtype (a weak-typed Python float in JAX).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.warp import resize_bilinear_nchw
from .attention import ENGINES, _attend
from .hrnet import (Bottleneck, HRModule, Linear, StageSpec, _apply_transition,
                    _transition, batch_norm, branch_sizes, conv)

POS_EMBEDDINGS = ("sine", "learnable", "none")
COND_CHANNELS = 16          # trans_cond's output, appended to d_model


def make_sine_position_embedding(h: int, w: int, d_model: int,
                                 temperature: float = 10000,
                                 scale: float = 2 * math.pi) -> np.ndarray:
    """(h*w, d_model) sine position table (transpose_h.py:513-537), in the f32
    numpy arithmetic of buctd_tpu/models/transpose.py:30, so the two agree bit
    for bit."""
    y_embed = np.tile(np.arange(1, h + 1, dtype=np.float32)[:, None], (1, w))
    x_embed = np.tile(np.arange(1, w + 1, dtype=np.float32)[None, :], (h, 1))
    eps = 1e-6
    y_embed = y_embed / (h + eps) * scale
    x_embed = x_embed / (w + eps) * scale

    half = d_model // 2
    dim_t = np.arange(half, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / half)

    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    pos = np.concatenate([pos_y, pos_x], axis=2)  # (h, w, d_model)
    return pos.reshape(h * w, -1)


class LayerNorm(nn.LayerNorm):
    """torch's LayerNorm, with flax's bf16 output.

    flax's ``nn.LayerNorm(dtype=bfloat16)`` normalises in f32 and returns
    bf16.  Autocast's own rule differs by device (on CUDA it returns f32, on
    the CPU bf16 input comes back bf16), so under autocast this normalises in
    f32 with autocast off and rounds the output to the autocast dtype on both;
    without autocast it is torch's module unchanged."""

    def forward(self, x):
        dev = x.device.type
        if not torch.is_autocast_enabled(dev):
            return super().forward(x)
        with torch.autocast(dev, enabled=False):
            y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                             self.eps)
        return y.to(torch.get_autocast_dtype(dev))


class MultiheadSelfAttention(nn.Module):
    """Self-attention with the reference's ``nn.MultiheadAttention`` parameters
    (``in_proj_weight`` (3d, d), ``in_proj_bias`` (3d,), ``out_proj``), applied
    as buctd_tpu/models/transpose.py::_PackedInProj (:54) does: three d-wide
    products, q from ``q_in``, k from ``k_in``, v from ``v_in``.  The heads go
    through ``_attend`` (K1 on CUDA at L_q * L_k >= 512^2); ``generator``,
    set by ``attention.set_dropout_generator``, seeds the flash dropout."""

    def __init__(self, d_model: int, n_head: int, dropout: float = 0.1,
                 engine: str = "auto"):
        super().__init__()
        if d_model % n_head:
            raise ValueError(f"d_model {d_model} is not a multiple of {n_head} heads")
        if engine not in ENGINES:
            raise ValueError(f"attention engine {engine!r} not in {ENGINES}")
        self.d_model, self.n_head, self.dropout, self.engine = d_model, n_head, dropout, engine
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Linear(d_model, d_model)
        self.generator = None
        nn.init.normal_(self.in_proj_weight, std=0.001)   # buctd_tpu's LINEAR_INIT

    def _proj(self, x, i: int):
        """The i-th d-wide slice of the packed projection; under autocast the
        bias is added after the rounded product, as models/hrnet.py::Linear."""
        d = self.d_model
        w, b = self.in_proj_weight[i * d:(i + 1) * d], self.in_proj_bias[i * d:(i + 1) * d]
        if not torch.is_autocast_enabled(x.device.type):
            return F.linear(x, w, b)
        y = F.linear(x, w)
        return y + b.to(y.dtype)

    def forward(self, q_in, k_in, v_in):
        B, L, d = q_in.shape
        h, hd = self.n_head, d // self.n_head

        def heads(x):
            return x.reshape(B, L, h, hd).transpose(1, 2)

        q = heads(self._proj(q_in, 0))
        # divided by the Python float as JAX's weak type takes it: rounded to
        # q's dtype first (bf16(sqrt(112)) = 10.5625 under autocast)
        q = q / float(torch.tensor(math.sqrt(hd)).to(q.dtype))
        out = _attend(q, heads(self._proj(k_in, 1)), heads(self._proj(v_in, 2)), 1.0,
                      self.engine, self.dropout if self.training else 0.0, self.generator)
        return self.out_proj(out.transpose(1, 2).reshape(B, L, d))


class TransformerEncoderLayer(nn.Module):
    """DETR-style post-norm encoder layer (transpose_h.py:168-243)."""

    def __init__(self, d_model: int, n_head: int, dim_feedforward: int,
                 dropout: float = 0.1, engine: str = "auto"):
        super().__init__()
        self.self_attn = MultiheadSelfAttention(d_model, n_head, dropout, engine)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.dropout = nn.Dropout(dropout)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)

    def forward(self, src, pos=None):
        q = src if pos is None else src + pos
        src = self.norm1(src + self.dropout1(self.self_attn(q, q, src)))
        src2 = self.linear2(self.dropout(F.relu(self.linear1(src))))
        return self.norm2(src + self.dropout2(src2))


@dataclasses.dataclass(frozen=True)
class TransPoseSpec:
    num_joints: int
    stage2: StageSpec
    stage3: StageSpec
    d_model: int
    dim_feedforward: int
    n_head: int
    encoder_layers: int
    pos_embedding: str           # 'sine' | 'learnable' | 'none'
    pe_hw: tuple                 # (h, w) of the tokens: the stem's quarter resolution
    final_conv_kernel: int
    use_attention: bool          # conditional input path
    cond_channels: int           # input channels after the 3 of the image

    @staticmethod
    def from_cfg(cfg) -> "TransPoseSpec":
        from ..data.pipeline import num_input_channels

        extra = cfg.MODEL.EXTRA
        w, h = cfg.MODEL.IMAGE_SIZE
        pos = str(cfg.MODEL.POS_EMBEDDING)
        if pos not in POS_EMBEDDINGS:
            raise ValueError(f"MODEL.POS_EMBEDDING {pos!r} not in {POS_EMBEDDINGS}")
        return TransPoseSpec(
            num_joints=int(cfg.MODEL.NUM_JOINTS),
            stage2=StageSpec.from_cfg(extra["STAGE2"]),
            stage3=StageSpec.from_cfg(extra["STAGE3"]),
            d_model=int(cfg.MODEL.DIM_MODEL),
            dim_feedforward=int(cfg.MODEL.DIM_FEEDFORWARD),
            n_head=int(cfg.MODEL.N_HEAD),
            encoder_layers=int(cfg.MODEL.ENCODER_LAYERS),
            pos_embedding=pos,
            pe_hw=branch_sizes((int(h), int(w)), 1)[0],
            final_conv_kernel=int(extra.get("FINAL_CONV_KERNEL", 1)),
            use_attention=bool(extra.get("USE_ATTENTION", False)),
            cond_channels=num_input_channels(cfg) - 3,
        )

    @property
    def width(self) -> int:
        """The encoder's token width d."""
        return self.d_model + (COND_CHANNELS if self.use_attention else 0)


class TransPoseH(nn.Module):
    """(B, 3 [+ c], H, W) -> (B, num_joints, H/4, W/4) heatmaps.

    ``pos_embedding`` is, as in the reference, a frozen (L, 1, d) parameter
    holding the sine table (``sine``), a trainable one drawn N(0, 1)
    (``learnable``), or absent (``none``).  A state_dict without the sine
    table (a JAX tree through ``convert.from_flax``: JAX computes it) loads
    strict: the load supplies the model's own table, the same function of the
    shape."""

    def __init__(self, spec: TransPoseSpec, engine: str = "auto"):
        super().__init__()
        self.spec = spec
        self.conv1 = conv(3, 64, 3, 2)
        self.bn1 = batch_norm(64)
        self.conv2 = conv(64, 64, 3, 2)
        self.bn2 = batch_norm(64)
        self.layer1 = nn.Sequential(*[Bottleneck(64 if k == 0 else 256, 64,
                                                 has_downsample=(k == 0))
                                      for k in range(4)])
        pre = (256,)
        for si, stage in enumerate((spec.stage2, spec.stage3)):
            cur = stage.out_channels
            setattr(self, f"transition{si + 1}", _transition(pre, cur))
            setattr(self, f"stage{si + 2}", nn.Sequential(*[
                HRModule(stage, cur,
                         multi_scale_output=not (si == 1 and m == stage.num_modules - 1))
                for m in range(stage.num_modules)]))
            pre = cur
        self.reduce = conv(pre[0], spec.d_model, 1)
        if spec.use_attention:
            self.trans_cond = conv(spec.cond_channels, COND_CHANNELS, 1)
        d = spec.width
        L = spec.pe_hw[0] * spec.pe_hw[1]
        if spec.pos_embedding == "sine":
            table = torch.from_numpy(make_sine_position_embedding(*spec.pe_hw, d))
            self.pos_embedding = nn.Parameter(table[:, None], requires_grad=False)
            self.register_load_state_dict_pre_hook(_supply_sine_table)
        elif spec.pos_embedding == "learnable":
            self.pos_embedding = nn.Parameter(torch.randn(L, 1, d))
        else:
            self.pos_embedding = None
        self.global_encoder = nn.Module()
        self.global_encoder.layers = nn.ModuleList([
            TransformerEncoderLayer(d, spec.n_head, spec.dim_feedforward, engine=engine)
            for _ in range(spec.encoder_layers)])
        k = spec.final_conv_kernel
        self.final_layer = conv(d, spec.num_joints, k, pad=k // 2, bias=True)

    def forward(self, x):
        spec = self.spec
        if spec.use_attention:
            if x.shape[1] <= 3:
                raise ValueError("conditional TransPose needs RGB + condition channels, "
                                 f"got {x.shape[1]} channels")
            x, cond = x[:, :3], x[:, 3:]
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        ys = [self.layer1(x)]
        for si in range(2):
            ys = _apply_transition(getattr(self, f"transition{si + 1}"), ys)
            ys = getattr(self, f"stage{si + 2}")(ys)
        feat = self.reduce(ys[0])
        B, _, H, W = feat.shape
        if (H, W) != spec.pe_hw:
            raise ValueError(f"tokens {H}x{W}: the model is built for {spec.pe_hw} "
                             "(MODEL.IMAGE_SIZE / 4)")
        if spec.use_attention:
            feat = torch.cat([feat, self.trans_cond(resize_bilinear_nchw(cond, (H, W)))], 1)
        d = feat.shape[1]
        tokens = feat.flatten(2).transpose(1, 2)                  # (B, H*W, d)
        pos = None if self.pos_embedding is None else self.pos_embedding[:, 0][None]
        for layer in self.global_encoder.layers:
            tokens = layer(tokens, pos)
        return self.final_layer(tokens.transpose(1, 2).reshape(B, d, H, W))


def _supply_sine_table(module, state_dict, prefix, *args):
    """Load pre-hook of a sine TransPoseH: a state_dict without
    ``pos_embedding`` takes the model's own table."""
    state_dict.setdefault(prefix + "pos_embedding", module.pos_embedding.detach().clone())


def get_pose_net(cfg, engine: str = "auto") -> TransPoseH:
    return TransPoseH(TransPoseSpec.from_cfg(cfg), engine=engine)
