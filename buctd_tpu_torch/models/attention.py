"""Attention modules matching lib/models/self_attention.py (torch).

Counterpart of buctd_tpu/models/attention.py.  Parameter names mirror the
reference's (fc_q/fc_k/fc_v/fc_o), so a BUCTD checkpoint loads as is.

The long-sequence token attention (CoAM position attention) goes through the
hand-written flash kernels (ops/flash_attention.py) for CUDA tensors at
L_q * L_k >= 512^2; shorter sequences, CPU tensors and the 'mapped' engine take
a batched matmul + softmax over the folded batch*heads axis.  The engine is
``cfg.TPU.ATTENTION_ENGINE``, passed down through the constructors.

Training mode applies the attention dropout (p = 0.1 by default), as the JAX
modules do at ``train=True``:

* the flash path runs ``flash_attention_train`` (K1 with its in-kernel mask,
  K2 as the backward); its seed is drawn from the ``torch.Generator`` that
  ``set_dropout_generator`` hands the model (the trainer carries it), never
  from the global RNG;
* the batched-matmul path and the channel attention apply
  ``torch.nn.functional.dropout`` to the probabilities, as JAX's
  ``nn.Dropout`` does there (:195).  No kernel is involved.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention, flash_attention_train
from .hrnet import Linear
from .remat import draw_seed

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


def _attend(q, k, v, scale: float, engine: str = "auto", dropout: float = 0.0,
            generator=None):
    """Attention on (B, h, n, d) operands -> (B, h, nq, d_v), f32 (or wider
    for wider operands).  ``dropout`` > 0 is training: the flash path then
    needs ``generator`` for its seed."""
    B, h, nq, _ = q.shape
    q3, k3, v3 = (x.reshape(B * h, x.shape[2], x.shape[3]).contiguous()
                  for x in (q, k, v))
    if not _use_flash(q, k.shape[2], v.shape[3], engine):
        acc = torch.promote_types(q3.dtype, torch.float32)
        with _no_autocast(q3):
            att = torch.softmax(torch.matmul(q3.to(acc), k3.to(acc).transpose(1, 2)) * scale,
                                dim=-1)
            if dropout > 0.0:
                att = F.dropout(att, dropout, training=True)
            out = torch.matmul(att, v3.to(acc))
    elif dropout > 0.0 or (torch.is_grad_enabled()
                           and any(x.requires_grad for x in (q3, k3, v3))):
        out = flash_attention_train(q3, k3, v3, scale, dropout,
                                    _draw_seed(generator) if dropout > 0.0 else 0)
    else:
        out, _ = flash_attention(q3, k3, v3, scale)
    return out.reshape(B, h, nq, v.shape[3])


def _no_autocast(x):
    """Autocast off for ``x``'s device: the attention products below take
    bf16-valued operands widened to f32, so their products are exact and their
    sums f32, as JAX's ``preferred_element_type=jnp.float32`` dots
    (buctd_tpu/models/attention.py:85, :118, :192-197).  Under autocast a
    matmul of bf16 operands would round the logits to bf16."""
    return torch.autocast(x.device.type, enabled=False)


def _draw_seed(generator) -> int:
    """The flash dropout's seed (models/remat.py::draw_seed: a recompute
    under TPU.REMAT replays the forward's seeds)."""
    if generator is None:
        raise RuntimeError("flash attention dropout needs a torch.Generator: "
                           "call set_dropout_generator(model, generator) first")
    return draw_seed(generator)


def set_dropout_generator(model: nn.Module, generator) -> None:
    """Hand every ScaledDotProductAttention and TransPose
    MultiheadSelfAttention of ``model`` the generator its flash dropout seeds
    are drawn from (a CPU generator: no device sync)."""
    from .transpose import MultiheadSelfAttention

    for m in model.modules():
        if isinstance(m, (ScaledDotProductAttention, MultiheadSelfAttention)):
            m.generator = generator


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
        self.fc_q = Linear(in_dim_q, h * d_k)
        self.fc_k = Linear(in_dim_k, h * d_k)
        self.fc_v = Linear(in_dim_k, h * d_v)
        self.fc_o = Linear(h * d_v, in_dim_k)
        self.dropout = nn.Dropout(dropout)
        self.generator = None

    def forward(self, queries, keys, values):
        B, nq, _ = queries.shape
        nk = keys.shape[1]
        q = self.fc_q(queries).reshape(B, nq, self.h, self.d_k).transpose(1, 2)
        k = self.fc_k(keys).reshape(B, nk, self.h, self.d_k).transpose(1, 2)
        v = self.fc_v(values).reshape(B, nk, self.h, self.d_v).transpose(1, 2)
        out = _attend(q, k, v, 1.0 / math.sqrt(self.d_k), self.engine,
                      self.dropout.p if self.training else 0.0, self.generator)
        out = out.transpose(1, 2).reshape(B, nq, self.h * self.d_v)
        return self.fc_o(out)


class SimplifiedScaledDotProductAttention(nn.Module):
    """No q/k/v projections, only an output linear (self_attention.py:95-160).
    ``d_model`` is the token feature dim (for CoAM channel attention: H*W)."""

    def __init__(self, d_model: int, h: int = 1, dropout: float = 0.1):
        super().__init__()
        self.d_model, self.h = d_model, h
        self.fc_o = Linear(d_model, d_model)
        self.dropout = nn.Dropout(dropout)

    def forward(self, queries, keys, values):
        B, nq, _ = queries.shape
        nk = keys.shape[1]
        h, d = self.h, self.d_model // self.h
        q = queries.reshape(B, nq, h, d).transpose(1, 2).reshape(B * h, nq, d)
        k = keys.reshape(B, nk, h, d).transpose(1, 2).reshape(B * h, nk, d)
        v = values.reshape(B, nk, h, d).transpose(1, 2).reshape(B * h, nk, d)
        acc = torch.promote_types(q.dtype, torch.float32)
        with _no_autocast(q):
            att = torch.softmax(torch.matmul(q.to(acc), k.to(acc).transpose(1, 2))
                                / math.sqrt(d), dim=-1)
            att = self.dropout(att)
            out = torch.matmul(att, v.to(acc))
        out = out.reshape(B, h, nq, d).transpose(1, 2).reshape(B, nq, h * d)
        return self.fc_o(out)
