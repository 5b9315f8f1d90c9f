"""Attention modules matching lib/models/self_attention.py (torch, eval only).

Counterpart of buctd_tpu/models/attention.py.  Parameter names mirror the
reference's (fc_q/fc_k/fc_v/fc_o), so a BUCTD checkpoint loads as is.  The
dropout modules exist so the module tree matches the reference; training is
not ported yet and the forward refuses to run in training mode.

The long-sequence token attention (CoAM position attention) goes through the
hand-written flash kernel (ops/flash_attention.py) for CUDA tensors at
L_q * L_k >= 512^2; shorter sequences, CPU tensors and the 'mapped' engine take
a batched matmul + softmax over the folded batch*heads axis.  The engine is
``cfg.TPU.ATTENTION_ENGINE``, passed down through the constructors.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.flash_attention import flash_attention

FLASH_MIN_TOKENS = 512 * 512
ENGINES = ("auto", "flash", "mapped")


def _use_flash(q, nk: int, dv: int, engine: str) -> bool:
    """Flash kernel when d_k == d_v and either the engine forces it or the
    tensor is on CUDA with L_q * L_k >= 512^2."""
    if q.shape[-1] != dv:
        return False
    if engine == "flash":
        return True
    if engine != "auto":
        return False
    return q.is_cuda and q.shape[-2] * nk >= FLASH_MIN_TOKENS


def _attend(q, k, v, scale: float, engine: str = "auto"):
    """Attention on (B, h, n, d) operands -> (B, h, nq, d_v) f32."""
    B, h, nq, _ = q.shape
    q3, k3, v3 = (x.reshape(B * h, x.shape[2], x.shape[3]).contiguous()
                  for x in (q, k, v))
    if _use_flash(q, k.shape[2], v.shape[3], engine):
        out, _ = flash_attention(q3, k3, v3, scale)
    else:
        att = torch.softmax(torch.matmul(q3, k3.transpose(1, 2)).float() * scale,
                            dim=-1)
        out = torch.matmul(att, v3.float())
    return out.reshape(B, h, nq, v.shape[3])


def _refuse_training(module: nn.Module) -> None:
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__} is eval-only in buctd_tpu_torch: training "
            "(dropout, flash backward) is ROADMAP Queue 1, 'training with K2 and K4'")


class ScaledDotProductAttention(nn.Module):
    """Multi-head attention with separate q/k input dims (self_attention.py:10-88).

    q (B, nq, in_dim_q), k/v (B, nk, in_dim_k) -> (B, nq, in_dim_k).
    """

    def __init__(self, in_dim_q: int, in_dim_k: int, d_k: int, d_v: int, h: int = 1,
                 dropout: float = 0.1, engine: str = "auto"):
        super().__init__()
        if engine not in ENGINES:
            raise ValueError(f"attention engine {engine!r} not in {ENGINES}")
        self.d_k, self.d_v, self.h, self.engine = d_k, d_v, h, engine
        self.fc_q = nn.Linear(in_dim_q, h * d_k)
        self.fc_k = nn.Linear(in_dim_k, h * d_k)
        self.fc_v = nn.Linear(in_dim_k, h * d_v)
        self.fc_o = nn.Linear(h * d_v, in_dim_k)
        self.dropout = nn.Dropout(dropout)

    def forward(self, queries, keys, values):
        _refuse_training(self)
        B, nq, _ = queries.shape
        nk = keys.shape[1]
        q = self.fc_q(queries).reshape(B, nq, self.h, self.d_k).transpose(1, 2)
        k = self.fc_k(keys).reshape(B, nk, self.h, self.d_k).transpose(1, 2)
        v = self.fc_v(values).reshape(B, nk, self.h, self.d_v).transpose(1, 2)
        out = _attend(q, k, v, 1.0 / math.sqrt(self.d_k), self.engine)
        out = out.transpose(1, 2).reshape(B, nq, self.h * self.d_v)
        return self.fc_o(out)


class SimplifiedScaledDotProductAttention(nn.Module):
    """No q/k/v projections, only an output linear (self_attention.py:95-160).
    ``d_model`` is the token feature dim (for CoAM channel attention: H*W)."""

    def __init__(self, d_model: int, h: int = 1, dropout: float = 0.1):
        super().__init__()
        self.d_model, self.h = d_model, h
        self.fc_o = nn.Linear(d_model, d_model)
        self.dropout = nn.Dropout(dropout)

    def forward(self, queries, keys, values):
        _refuse_training(self)
        B, nq, _ = queries.shape
        nk = keys.shape[1]
        h, d = self.h, self.d_model // self.h
        q = queries.reshape(B, nq, h, d).transpose(1, 2).reshape(B * h, nq, d)
        k = keys.reshape(B, nk, h, d).transpose(1, 2).reshape(B * h, nk, d)
        v = values.reshape(B, nk, h, d).transpose(1, 2).reshape(B * h, nk, d)
        att = torch.softmax(torch.matmul(q, k.transpose(1, 2)) / math.sqrt(d), dim=-1)
        out = torch.matmul(att, v)
        out = out.reshape(B, h, nq, d).transpose(1, 2).reshape(B, nq, h * d)
        return self.fc_o(out)
