"""Attention layers: MultiHeadAttention, LayerNormalization and
PositionalEmbedding.

Counterpart of deeplearning4j_tpu/nn/layers/attention.py (the forward,
the dense and the paged decode steps; chunked prefill and tree
speculation are not ported yet). Parameter keys are the JAX package's:
``Wq``/``Wk``/``Wv``/``Wo`` (+ ``bq``/``bk``/``bv``/``bo``), ``gamma`` /
``beta``, ``P``.

Which kernel runs: the JAX layer launches its flash kernels only where
its TPU route tables say so; here the routing is by the function alone.
``MultiHeadAttention.apply`` runs K5 (``ops.flash_attention``) on every
call whose head dim the JAX layer's flash screens take, and under autograd
its backward runs K6 and K7 (the kernels of ``ops.FlashAttention``) -- the
port's layer
takes no key mask and no offsets, so q, k and v always share one shape,
the conditions under which the JAX layer's flash path computes the same
function as its einsum path.
The dense decode step always runs K8 (``ops.flash_decode_step``), the
paged one K9 (``ops.flash_decode_step_paged``). On CPU tensors those
wrappers run their plain versions. A head dim that is not a multiple of
8, which the JAX layer's flash screens reject for its einsum path, runs
the layer's own einsum and softmax in all three places, on any device
(``flash_supported``). The kernels take the multiples of 8 up to 128; a
larger one, which the JAX layer runs through its flash kernels, raises on
the card (the wrappers' screen). LayerNormalization and
PositionalEmbedding differentiate by autograd.

KV writes are in place (``index_put_``) where the JAX layer builds a new
cache with ``.at[].set`` on every step. Position masking keeps that safe:
a step writes row ``pos`` before it reads rows 0..pos, so every row a
stream reads was written by that stream. An engine's inactive dense slot
writes its own row 0, which the slot's next request rewrites before any
read; an inactive paged slot has an all-zero page-table row, so its write
lands in the pool's scratch block 0, which no live table names.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (Layer, register_layer,
                                                     require_dims)
from deeplearning4j_tpu_torch.nn.weights import init_weights


def _attend(q, k, v, keep=None) -> torch.Tensor:
    """The layer's own attention, in q's type: softmax(q k^T / sqrt(Dh)) v
    over queries (B, Tq, H, Dh) and keys and values (B, Tk, H, Dh), the
    pairs where ``keep`` (broadcast to (B, H, Tq, Tk)) is False dropped."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def _positions(pos, B, device) -> torch.Tensor:
    """``pos`` (a scalar or (B,)) as a contiguous (B,) int32 tensor."""
    pos = torch.as_tensor(pos, device=device).to(torch.int32)
    return torch.broadcast_to(pos, (B,)).contiguous()


@register_layer
@dataclass
class MultiHeadAttention(Layer):
    """Self-attention over (B, T, C) with ``n_heads`` heads."""
    n_in: int = 0
    n_out: int = 0          # model dim (defaults to n_in)
    n_heads: int = 4
    causal: bool = False
    has_bias: bool = True

    # decode-state keys indexed by token position (written in place, never
    # wiped or frozen per slot by the engine)
    positional_state_keys = ("k", "v", "pk", "pv")

    def set_n_in(self, input_type):
        if self.n_in == 0:
            self.n_in = input_type.size or input_type.flat_size()
        if self.n_out == 0:
            self.n_out = self.n_in

    def output_type(self, input_type):
        return InputType.recurrent(self.n_out or self.n_in,
                                   input_type.timeseries_length)

    @property
    def head_dim(self) -> int:
        return (self.n_out or self.n_in) // self.n_heads

    def init(self, gen, dtype=torch.float32, device=None):
        require_dims(self, n_in=self.n_in, n_out=self.n_out or self.n_in)
        if self.n_out == 0:
            self.n_out = self.n_in
        if self.n_out % self.n_heads != 0:
            raise ValueError(f"n_out={self.n_out} not divisible by "
                             f"n_heads={self.n_heads}")
        wi = self.weight_init or "xavier"
        p = {}
        for key, shape in (("Wq", (self.n_in, self.n_out)),
                           ("Wk", (self.n_in, self.n_out)),
                           ("Wv", (self.n_in, self.n_out)),
                           ("Wo", (self.n_out, self.n_out))):
            p[key] = init_weights(gen, shape, wi, self.dist, dtype,
                                  device=device)
        if self.has_bias:
            for key in ("bq", "bk", "bv", "bo"):
                p[key] = torch.zeros((self.n_out,), dtype=dtype,
                                     device=device)
        return p

    def _project(self, params, x):
        B, T, _ = x.shape
        H, Dh = self.n_heads, self.head_dim
        q, k, v = x @ params["Wq"], x @ params["Wk"], x @ params["Wv"]
        if self.has_bias:
            q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
        return (q.reshape(B, T, H, Dh), k.reshape(B, T, H, Dh),
                v.reshape(B, T, H, Dh))

    def _project_out(self, params, o, B, T, dt):
        o = o.reshape(B, T, self.n_out).to(dt) @ params["Wo"]
        if self.has_bias:
            o = o + params["bo"]
        return o

    def flash_supported(self) -> bool:
        """The head-dim half of the JAX layer's flash screens (a multiple of
        8); any other head dim runs the layer's own einsum and softmax."""
        return self.head_dim % 8 == 0

    def apply(self, params, x):
        B, T, _ = x.shape
        H, Dh = self.n_heads, self.head_dim
        q, k, v = self._project(params, x)
        if not self.flash_supported():
            keep = (torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
                    if self.causal else None)
            return self._project_out(params, _attend(q, k, v, keep), B, T,
                                     q.dtype)

        def fold(a):    # (B, T, H, Dh) -> (B*H, T, Dh) float32
            return a.permute(0, 2, 1, 3).reshape(B * H, T, Dh).float() \
                .contiguous()
        o = ops.flash_attention(fold(q), fold(k), fold(v), self.causal)
        o = o.reshape(B, H, T, Dh).permute(0, 2, 1, 3)
        return self._project_out(params, o, B, T, q.dtype)

    # ---- incremental decode ----------------------------------------------
    def _check_causal(self):
        if not self.causal:
            raise ValueError(
                "only causal attention can decode incrementally (non-causal "
                "heads attend to future tokens)")

    def init_decode_state(self, params, batch, max_len=0,
                          dtype=torch.float32, device=None):
        """KV cache of ``max_len`` positions: (batch, max_len, H, Dh) per
        tensor."""
        shape = (batch, max_len, self.n_heads, self.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def decode_step(self, params, dstate, x, pos=None):
        """Write this position's K/V into the cache (in place), then K8 over
        rows 0..pos. ``x`` (B, 1, C), ``pos`` (B,) int."""
        self._check_causal()
        B = x.shape[0]
        q, k, v = self._project(params, x)              # (B, 1, H, Dh)
        pos = _positions(pos, B, x.device)
        rows = torch.arange(B, device=x.device)
        kc, vc = dstate["k"], dstate["v"]
        kc[rows, pos.long()] = k[:, 0]
        vc[rows, pos.long()] = v[:, 0]
        if not self.flash_supported():
            return self._finish_step(params, q, kc, vc, pos), dstate
        o = ops.flash_decode_step(q[:, 0].float().contiguous(), kc, vc, pos)
        return self._project_out(params, o, B, 1, q.dtype), dstate

    def _finish_step(self, params, q, kc, vc, pos):
        """A decode step of the layer's own attention: the query (B, 1, H,
        Dh) over rows 0..pos of the cache (B, C, H, Dh)."""
        B, C = kc.shape[:2]
        keep = torch.arange(C, device=kc.device) <= pos.long()[:, None]
        o = _attend(q, kc, vc, keep[:, None, None, :])
        return self._project_out(params, o, B, 1, q.dtype)

    # ---- paged decode (serving/kv/) --------------------------------------
    def init_paged_decode_state(self, params, batch, max_len, num_blocks,
                                block_size, dtype=torch.float32, device=None):
        """KV block pool shared by every slot: (num_blocks, block_size, H,
        Dh) per tensor, under the keys the engine's per-slot masks skip."""
        shape = (num_blocks, block_size, self.n_heads, self.head_dim)
        return {"pk": torch.zeros(shape, dtype=dtype, device=device),
                "pv": torch.zeros(shape, dtype=dtype, device=device)}

    def decode_step_paged(self, params, dstate, x, pos, block_tables):
        """Write this position's K/V into its pool row ``(block_tables[b,
        pos // bs], pos % bs)`` (in place), then K9 over rows 0..pos."""
        self._check_causal()
        B = x.shape[0]
        q, k, v = self._project(params, x)              # (B, 1, H, Dh)
        pos = _positions(pos, B, x.device)
        tables = block_tables.to(device=x.device, dtype=torch.int32) \
            .contiguous()
        pk, pv = dstate["pk"], dstate["pv"]
        bs = pk.shape[1]
        rows = torch.arange(B, device=x.device)
        p = pos.long()
        phys = tables[rows, p // bs].long()
        pk[phys, p % bs] = k[:, 0]
        pv[phys, p % bs] = v[:, 0]
        if not self.flash_supported():
            shape = (B, tables.shape[1] * bs) + tuple(pk.shape[2:])
            kc = pk[tables.long()].reshape(shape)
            vc = pv[tables.long()].reshape(shape)
            return self._finish_step(params, q, kc, vc, pos), dstate
        o = ops.flash_decode_step_paged(q[:, 0].float().contiguous(), pk, pv,
                                        pos, tables)
        return self._project_out(params, o, B, 1, q.dtype), dstate


@register_layer
@dataclass
class LayerNormalization(Layer):
    """Layer norm over the feature axis."""
    n_in: int = 0
    eps: float = 1e-5

    def set_n_in(self, input_type):
        if self.n_in == 0:
            self.n_in = input_type.size or input_type.flat_size()

    def init(self, gen, dtype=torch.float32, device=None):
        require_dims(self, n_in=self.n_in)
        return {"gamma": torch.ones((self.n_in,), dtype=dtype, device=device),
                "beta": torch.zeros((self.n_in,), dtype=dtype, device=device)}

    def apply(self, params, x):
        mean = x.mean(-1, keepdim=True)
        var = x.var(-1, unbiased=False, keepdim=True)
        xn = (x - mean) * torch.rsqrt(var + self.eps)
        return xn * params["gamma"] + params["beta"]


@register_layer
@dataclass
class PositionalEmbedding(Layer):
    """Learned absolute positional embedding added to (B, T, C) inputs."""
    n_in: int = 0
    max_len: int = 512

    def set_n_in(self, input_type):
        if self.n_in == 0:
            self.n_in = input_type.size or input_type.flat_size()

    def init(self, gen, dtype=torch.float32, device=None):
        require_dims(self, n_in=self.n_in)
        P = torch.randn((self.max_len, self.n_in), generator=gen) * 0.02
        return {"P": P.to(dtype=dtype, device=device)}

    def apply(self, params, x):
        T = x.shape[1]
        if T > self.max_len:
            raise ValueError(f"sequence length {T} exceeds "
                             f"max_len={self.max_len}")
        return x + params["P"][:T]

    def decode_step(self, params, dstate, x, pos=None):
        pos = _positions(pos, x.shape[0], x.device)
        return x + params["P"][pos.long()][:, None, :], dstate
