"""Attention layers: MultiHeadAttention, LayerNormalization and
PositionalEmbedding.

Counterpart of deeplearning4j_tpu/nn/layers/attention.py: the forward,
the dense and the paged decode steps, chunked prefill (``prefill_chunk``)
and tree speculation (``tree_chunk``, ``tree_commit``). Parameter keys are
the JAX package's:
``Wq``/``Wk``/``Wv``/``Wo`` (+ ``bq``/``bk``/``bv``/``bo``), ``gamma`` /
``beta``, ``P``.

Which kernel runs: the JAX layer launches its flash kernels only where
its TPU route tables say so; here the routing is by the function alone.
``MultiHeadAttention.apply`` runs K5 (``ops.flash_attention``) on every
call whose head dim the JAX layer's flash screens take, and under autograd
its backward runs K6 and K7 (the kernels of ``ops.FlashAttention``) --
without a key mask, and with no offsets (the port's layer takes none), q,
k and v share one shape, the conditions under which the JAX layer's flash
path computes the same function as its einsum path. A call with a (B, T)
key-padding mask runs the layer's own einsum and softmax with the masked
keys' scores at -inf, as the JAX layer's einsum path does.
The dense decode step always runs K8 (``ops.flash_decode_step``), the
paged one K9 (``ops.flash_decode_step_paged``), and so does a tree
verify: ``tree_chunk`` runs K8 over every node's effective cache, the
plain step's own attention (the JAX layer calls its step's
``_finish_step`` there). A prefill chunk runs the layer's own einsum and
softmax over the gathered cache, as the JAX layer's does. On CPU tensors those
wrappers run their plain versions. The kernels take every head dim that
is a multiple of 8, as the head-dim clause of the JAX layer's flash
screens does (``ops.head_dim_supported``, which both the layer and the
wrappers call); any other head dim, which the JAX layer sends to its
einsum path, runs the layer's own einsum and softmax in all three places,
on any device (``flash_supported``). LayerNormalization and
PositionalEmbedding differentiate by autograd.

``scaled_dot_product_attention`` is the JAX package's function, with its
q / k offsets: K5 (K6 + K7 under autograd) where the JAX function's flash
screen holds, else the plain scores over positions ``arange + offset``.
``MultiHeadAttention.apply`` attends through it with no offsets, which
is the path and the numbers described above.

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
from deeplearning4j_tpu_torch.ops.decode_cuda import gather_pages


def _attend(q, k, v, keep=None) -> torch.Tensor:
    """The layer's own attention, in q's type: softmax(q k^T / sqrt(Dh)) v
    over queries (B, Tq, H, Dh) and keys and values (B, Tk, H, Dh), the
    pairs where ``keep`` (broadcast to (B, H, Tq, Tk)) is False dropped."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def scaled_dot_product_attention(q, k, v, *, causal=False, mask=None,
                                 q_offset=0, k_offset=0, train=False):
    """Attention of q over k and v, each (B, T, H, Dh), ``mask`` (B, Tk) a
    key-padding mask, ``q_offset`` / ``k_offset`` the global positions of
    the first query and key for the causal mask of sequence blocks (the
    JAX package's function). With no mask, zero offsets, one shape for
    q, k and v and a head dim ``ops.head_dim_supported`` takes, it is
    ``ops.flash_attention`` (K5, and K6 + K7 under autograd, on a card);
    otherwise the plain scores with the causal mask over ``arange +
    offset``, which is what the JAX function computes there too.
    ``train`` is taken for the JAX signature (its route tables read it;
    the port routes by the function alone)."""
    if (mask is None and q_offset == 0 and k_offset == 0
            and q.shape == k.shape == v.shape
            and ops.head_dim_supported(q.shape[-1])):
        B, T, H, Dh = q.shape

        def fold(a):    # (B, T, H, Dh) -> (B*H, T, Dh) float32
            return a.permute(0, 2, 1, 3).reshape(B * H, T, Dh).float() \
                .contiguous()
        o = ops.flash_attention(fold(q), fold(k), fold(v), causal)
        return o.reshape(B, H, T, Dh).permute(0, 2, 1, 3).to(q.dtype)
    keep = None
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device) + q_offset
        kpos = torch.arange(k.shape[1], device=q.device) + k_offset
        keep = qpos[:, None] >= kpos[None, :]
    if mask is not None:
        keys = mask[:, None, None, :] > 0
        keep = keys if keep is None else keep & keys
    return _attend(q, k, v, keep)


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
        return ops.head_dim_supported(self.head_dim)

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        """Self-attention of ``x`` (B, T, C); ``mask`` (B, T) is a
        key-padding mask: the JAX layer's einsum path drops the masked
        keys' scores (after the causal mask), and so does the layer's own
        attention here, as a different function from K5's (a row whose
        keys are all masked gives NaN in both)."""
        x = self.maybe_dropout(x, train=train, gen=gen)
        B, T, _ = x.shape
        q, k, v = self._project(params, x)
        o = scaled_dot_product_attention(q, k, v, causal=self.causal,
                                         mask=mask, train=train)
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

    # ---- chunked prefill (serving/kv/prefill.py) -------------------------
    def prefill_chunk(self, params, dstate, x, start, n, block_tables=None,
                      carry_stack=False):
        """Write the K/V of chunk rows ``start .. start+K-1`` into the
        cache (in place), then attend each row causally over the gathered
        cache with the layer's own softmax: teacher forcing, row by row.
        Paged: padding rows (t >= n) write into the scratch block. Dense:
        cache position c takes chunk row c - start only where that row is
        valid, so a padding row never overwrites anything. KV is
        positional, so ``carry_stack`` gives a None stack."""
        self._check_causal()
        B, K, _ = x.shape
        dev = x.device
        q, k, v = self._project(params, x)              # (B, K, H, Dh)
        start = _positions(start, B, dev).long()
        n = _positions(n, B, dev).long()
        t = torch.arange(K, device=dev)
        poss = start[:, None] + t[None, :]              # (B, K)
        valid = t[None, :] < n[:, None]
        if "pk" in dstate:
            pk, pv = dstate["pk"], dstate["pv"]
            bs = pk.shape[1]
            tables = block_tables.to(device=dev).long()
            bidx = (poss // bs).clamp(0, tables.shape[1] - 1)
            phys = torch.where(valid, tables.gather(1, bidx), 0)
            pk[phys, poss % bs] = k.to(pk.dtype)
            pv[phys, poss % bs] = v.to(pv.dtype)
            # gathered after the writes: a row sees the rows before it in
            # the same chunk
            kc, vc = gather_pages(pk, tables), gather_pages(pv, tables)
        else:
            kc, vc = dstate["k"], dstate["v"]
            C = kc.shape[1]
            coff = torch.arange(C, device=dev)[None, :] - start[:, None]
            wr = ((coff >= 0) & (coff < n.clamp(max=K)[:, None]))[..., None,
                                                                    None]
            tidx = coff.clamp(0, K - 1)[:, :, None, None].expand(
                (B, C) + tuple(k.shape[2:]))
            kc.copy_(torch.where(wr, torch.gather(k, 1, tidx).to(kc.dtype),
                                 kc))
            vc.copy_(torch.where(wr, torch.gather(v, 1, tidx).to(vc.dtype),
                                 vc))
        C = kc.shape[1]
        causal = torch.arange(C, device=dev)[None, None, :] <= poss[:, :, None]
        o = _attend(q, kc.to(q.dtype), vc.to(q.dtype), causal[:, None])
        y = self._project_out(params, o, B, K, q.dtype)
        return (y, dstate, None) if carry_stack else (y, dstate)

    # ---- tree speculation (serving/spec/tree.py) -------------------------
    def tree_chunk(self, params, dstate, x, pos0, tree, n, block_tables=None):
        """Score N tree nodes without writing the cache (siblings share
        positions). Node i attends to its effective cache: the cache with
        positions ``pos0 .. pos0+depth(i)`` replaced by its own
        root-path's K/V (``tree.anc_at_depth`` row i), element for element
        the cache the plain engine would hold after feeding that path. The
        attention is the plain step's, K8 (``ops.flash_decode_step``) over
        B N rows at positions ``pos0 + depth``, so every node's output is
        the plain step's for its prefix. Returns ``(y, dstate, None,
        {"k", "v"})``: the nodes' K/V rows for ``tree_commit``."""
        self._check_causal()
        B, N, _ = x.shape
        dev = x.device
        q, k, v = self._project(params, x)              # (B, N, H, Dh)
        H, Dh = k.shape[2], k.shape[3]
        pos0 = _positions(pos0, B, dev).long()
        if "pk" in dstate:
            tables = block_tables.to(device=dev).long()
            kc = gather_pages(dstate["pk"], tables)
            vc = gather_pages(dstate["pv"], tables)
        else:
            kc, vc = dstate["k"], dstate["v"]
        C = kc.shape[1]
        tt = tree.tensors(dev)
        depth, aad = tt.depth, tt.anc_at_depth                 # (N,), (N, D+1)
        coff = torch.arange(C, device=dev)[None, :] - pos0[:, None]  # (B, C)
        on_path = ((coff[:, None, :] >= 0)
                   & (coff[:, None, :] <= depth[None, :, None]))[..., None,
                                                                  None]
        didx = coff.clamp(0, aad.shape[1] - 1)[:, None, :, None, None] \
            .expand(B, N, C, H, Dh)

        def effective(cache, win):
            path = win.to(cache.dtype)[:, aad]           # (B, N, D+1, H, Dh)
            g = torch.gather(path, 2, didx)              # (B, N, C, H, Dh)
            return torch.where(on_path, g, cache[:, None]).reshape(
                B * N, C, H, Dh)

        effk, effv = effective(kc, k), effective(vc, v)
        posn = (pos0[:, None] + depth[None, :]).reshape(B * N).to(torch.int32)
        qn = q.reshape(B * N, 1, H, Dh)
        if not self.flash_supported():
            o = self._finish_step(params, qn, effk, effv, posn)
        else:
            o = ops.flash_decode_step(qn[:, 0].float().contiguous(), effk,
                                      effv, posn)
            o = self._project_out(params, o, B * N, 1, q.dtype)
        return o.reshape(B, N, self.n_out), dstate, None, {"k": k, "v": v}

    def tree_commit(self, params, dstate, kv_window, path, pos0, commit_n,
                    block_tables=None):
        """Write the accepted root-path's K/V (``kv_window`` rows at the
        (B, D+1) ``path`` nodes) at positions ``pos0 + d`` for ``d <
        commit_n``, in place. Paged: the other depths write into the
        scratch block. Dense: they rewrite the value they hold."""
        B, Dp1 = path.shape
        dev = kv_window["k"].device
        rows = torch.arange(B, device=dev)[:, None]
        path = path.long()
        pos0 = _positions(pos0, B, dev).long()
        commit_n = _positions(commit_n, B, dev).long()
        d = torch.arange(Dp1, device=dev)
        poss = pos0[:, None] + d[None, :]               # (B, D+1)
        valid = d[None, :] < commit_n[:, None]
        kg, vg = kv_window["k"][rows, path], kv_window["v"][rows, path]
        if "pk" in dstate:
            pk, pv = dstate["pk"], dstate["pv"]
            bs = pk.shape[1]
            tables = block_tables.to(device=dev).long()
            bidx = (poss // bs).clamp(0, tables.shape[1] - 1)
            phys = torch.where(valid, tables.gather(1, bidx), 0)
            pk[phys, poss % bs] = kg.to(pk.dtype)
            pv[phys, poss % bs] = vg.to(pv.dtype)
            return dstate
        kc, vc = dstate["k"], dstate["v"]
        cpos = poss.clamp(0, kc.shape[1] - 1)
        keep = valid[..., None, None]
        kc[rows, cpos] = torch.where(keep, kg.to(kc.dtype), kc[rows, cpos])
        vc[rows, cpos] = torch.where(keep, vg.to(vc.dtype), vc[rows, cpos])
        return dstate


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

    def apply(self, params, x, *, train=False, gen=None, mask=None):
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

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        T = x.shape[1]
        if T > self.max_len:
            raise ValueError(f"sequence length {T} exceeds "
                             f"max_len={self.max_len}")
        return x + params["P"][:T]

    def decode_step(self, params, dstate, x, pos=None):
        pos = _positions(pos, x.shape[0], x.device)
        return x + params["P"][pos.long()][:, None, :], dstate

    def _at(self, params, x, poss):
        """``x`` plus the embedding at positions ``poss`` (B, T), clipped
        to the table (padding rows may run past it)."""
        return x + params["P"][poss.clamp(0, self.max_len - 1)]

    def prefill_chunk(self, params, dstate, x, start, n, block_tables=None,
                      carry_stack=False):
        """Chunk row t sits at position ``start + t``, not t."""
        B, K = x.shape[:2]
        start = _positions(start, B, x.device).long()
        y = self._at(params, x, start[:, None]
                     + torch.arange(K, device=x.device)[None, :])
        return (y, dstate, None) if carry_stack else (y, dstate)

    def tree_chunk(self, params, dstate, x, pos0, tree, n, block_tables=None):
        """Tree node i sits at position ``pos0 + depth(i)``."""
        pos0 = _positions(pos0, x.shape[0], x.device).long()
        depth = tree.tensors(x.device).depth
        return (self._at(params, x, pos0[:, None] + depth[None, :]), dstate,
                None, None)
