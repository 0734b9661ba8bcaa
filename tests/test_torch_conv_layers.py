"""The port's convolutional, pooling, normalization and core layers held
against the JAX package's on the CPU.

Every layer of nn/layers/conv.py (the sixteen classes), GlobalPoolingLayer
and the seven core layers of this slice, one parametrised case each for
the settings that change the arithmetic: 'truncate' and 'same' padding
(asymmetric at stride 2 and even sizes), stride 1 and 2, dilation 2, odd
sizes, each pooling type with and without ``avg_count_includes_padding``,
an asymmetric deconvolution kernel. A case builds the JAX layer, reads the
port's from its JSON (``layer_from_dict``), carries the JAX layer's
initial parameters across, and compares the output type, the forward and
the gradients of a loss (the mean of a random projection of the output)
with respect to the input and every parameter, at float32 rtol 1e-5 /
atol 1e-6.
BatchNormalization is compared in train and inference mode, and its
running statistics after two updates, written in place in the port where
the JAX layer returns them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import layer_from_dict
from deeplearning4j_tpu_torch.nn.layers.conv import same_pads

RTOL, ATOL = 1e-5, 1e-6
B = 3


def cnn(h, w, c):
    return JIT.convolutional(h, w, c)


def rnn(c, t):
    return JIT.recurrent(c, t)


def ff(n):
    return JIT.feed_forward(n)


# (id, JAX class name, constructor keywords, input type)
CASES = [
    ("conv_truncate_pad1", "ConvolutionLayer",
     dict(n_out=5, kernel_size=3, padding=1, activation="relu"), cnn(7, 9, 3)),
    ("conv_same_stride2_even", "ConvolutionLayer",
     dict(n_out=4, kernel_size=3, stride=2, convolution_mode="same"),
     cnn(8, 6, 2)),
    ("conv_dilation2_stride21", "ConvolutionLayer",
     dict(n_out=3, kernel_size=(3, 2), stride=(2, 1), dilation=2,
          activation="tanh"), cnn(9, 7, 2)),
    ("conv_same_dilation2_k4", "ConvolutionLayer",
     dict(n_out=3, kernel_size=4, stride=2, dilation=2,
          convolution_mode="same", has_bias=False), cnn(9, 10, 2)),
    ("conv1d_truncate", "Convolution1DLayer",
     dict(n_out=4, kernel_size=3, padding=1), rnn(3, 9)),
    ("conv1d_same_stride2", "Convolution1DLayer",
     dict(n_out=4, kernel_size=4, stride=2, convolution_mode="same"),
     rnn(3, 8)),
    ("conv1d_dilation2", "Convolution1DLayer",
     dict(n_out=2, kernel_size=3, dilation=2, activation="relu"), rnn(3, 11)),
    ("separable_same_stride2", "SeparableConvolution2D",
     dict(n_out=4, kernel_size=3, stride=2, convolution_mode="same",
          depth_multiplier=2), cnn(7, 8, 3)),
    ("depthwise_truncate", "DepthwiseConvolution2D",
     dict(kernel_size=3, padding=1, depth_multiplier=2), cnn(6, 5, 3)),
    ("depthwise_same_stride2", "DepthwiseConvolution2D",
     dict(kernel_size=3, stride=2, convolution_mode="same"), cnn(8, 7, 2)),
    ("deconv_truncate_asym_kernel", "Deconvolution2D",
     dict(n_out=3, kernel_size=(3, 2), stride=2, padding=(1, 0)),
     cnn(4, 5, 2)),
    ("deconv_same_stride2", "Deconvolution2D",
     dict(n_out=2, kernel_size=3, stride=2, convolution_mode="same"),
     cnn(4, 3, 3)),
    ("deconv_same_stride_past_kernel", "Deconvolution2D",
     dict(n_out=2, kernel_size=2, stride=3, convolution_mode="same"),
     cnn(3, 4, 2)),
    ("pool_max_truncate", "SubsamplingLayer",
     dict(pooling_type="max", kernel_size=2, stride=2), cnn(7, 8, 3)),
    ("pool_max_same_asym", "SubsamplingLayer",
     dict(pooling_type="max", kernel_size=3, stride=2,
          convolution_mode="same"), cnn(8, 7, 2)),
    ("pool_max_pad1", "SubsamplingLayer",
     dict(pooling_type="max", kernel_size=3, stride=2, padding=1),
     cnn(9, 8, 2)),
    ("pool_avg_same_counting_padding", "SubsamplingLayer",
     dict(pooling_type="avg", kernel_size=3, stride=2,
          convolution_mode="same"), cnn(8, 7, 2)),
    ("pool_avg_same_real_positions", "SubsamplingLayer",
     dict(pooling_type="avg", kernel_size=3, stride=2,
          convolution_mode="same", avg_count_includes_padding=False),
     cnn(8, 7, 2)),
    ("pool_avg_pad1_real_positions", "SubsamplingLayer",
     dict(pooling_type="avg", kernel_size=3, stride=2, padding=1,
          avg_count_includes_padding=False), cnn(7, 9, 2)),
    ("pool_sum_stride1", "SubsamplingLayer",
     dict(pooling_type="sum", kernel_size=2, stride=1), cnn(5, 6, 2)),
    ("pool_pnorm", "SubsamplingLayer",
     dict(pooling_type="pnorm", kernel_size=2, stride=2, pnorm=3),
     cnn(6, 7, 2)),
    ("pool1d_max_same", "Subsampling1DLayer",
     dict(pooling_type="max", kernel_size=3, stride=2,
          convolution_mode="same"), rnn(3, 8)),
    ("pool1d_avg_same_real_positions", "Subsampling1DLayer",
     dict(pooling_type="avg", kernel_size=3, stride=2,
          convolution_mode="same", avg_count_includes_padding=False),
     rnn(3, 8)),
    ("pool1d_sum_pad1", "Subsampling1DLayer",
     dict(pooling_type="sum", kernel_size=2, stride=2, padding=1), rnn(2, 7)),
    ("upsampling2d", "Upsampling2D", dict(size=(2, 3)), cnn(3, 4, 2)),
    ("upsampling1d", "Upsampling1D", dict(size=3), rnn(2, 4)),
    ("zero_padding", "ZeroPaddingLayer", dict(padding=(1, 2, 0, 3)),
     cnn(3, 4, 2)),
    ("zero_padding1d", "ZeroPadding1DLayer", dict(padding=(2, 1)), rnn(2, 5)),
    ("cropping2d", "Cropping2D", dict(cropping=(1, 0, 2, 1)), cnn(5, 6, 2)),
    ("batchnorm_cnn_inference", "BatchNormalization",
     dict(activation="relu"), cnn(5, 4, 3)),
    ("batchnorm_cnn_train", "BatchNormalization", dict(), cnn(5, 4, 3)),
    ("batchnorm_ff_train_locked", "BatchNormalization",
     dict(lock_gamma_beta=True, decay=0.8), ff(6)),
    ("lrn", "LocalResponseNormalization", dict(n=3, alpha=0.1),
     cnn(3, 4, 6)),
    ("space_to_depth", "SpaceToDepthLayer", dict(block_size=2),
     cnn(4, 6, 2)),
    ("space_to_batch", "SpaceToBatchLayer", dict(block_size=(2, 2)),
     cnn(4, 6, 2)),
    ("global_max_cnn", "GlobalPoolingLayer", dict(pooling_type="max"),
     cnn(4, 5, 3)),
    ("global_avg_cnn", "GlobalPoolingLayer", dict(pooling_type="avg"),
     cnn(4, 5, 3)),
    ("global_sum_rnn", "GlobalPoolingLayer", dict(pooling_type="sum"),
     rnn(3, 6)),
    ("global_pnorm_rnn", "GlobalPoolingLayer",
     dict(pooling_type="pnorm", pnorm=3), rnn(3, 6)),
    ("global_max_masked", "GlobalPoolingLayer", dict(pooling_type="max"),
     rnn(3, 6)),
    ("global_avg_masked", "GlobalPoolingLayer", dict(pooling_type="avg"),
     rnn(3, 6)),
    ("global_sum_masked", "GlobalPoolingLayer", dict(pooling_type="sum"),
     rnn(3, 6)),
    ("global_pnorm_masked", "GlobalPoolingLayer",
     dict(pooling_type="pnorm"), rnn(3, 6)),
    ("activation", "ActivationLayer", dict(activation="tanh"), ff(5)),
    ("flatten_cnn", "FlattenLayer", dict(), cnn(3, 2, 4)),
    ("reshape_wildcard", "ReshapeLayer", dict(target_shape=(3, -1)), ff(12)),
    ("embedding", "EmbeddingLayer", dict(n_in=7, n_out=4), ff(1)),
    ("embedding_sequence", "EmbeddingSequenceLayer", dict(n_in=7, n_out=3),
     rnn(1, 5)),
    ("prelu", "PReLULayer", dict(), ff(6)),
    ("elementwise_multiplication", "ElementWiseMultiplicationLayer",
     dict(activation="sigmoid"), ff(5)),
]


def _inputs(case, it):
    """The case's input (integer indices for the embeddings) and mask."""
    r = np.random.RandomState(sum(map(ord, case)))
    if case.startswith("embedding"):
        shape = (B, 1) if it.kind == "ff" else (B, it.timeseries_length)
        return r.randint(0, 7, shape).astype(np.float32), None
    x = r.randn(*it.batch_shape(B)).astype(np.float32)
    if case == "prelu":
        x = x - 0.3
    if case.endswith("masked"):
        m = np.ones((B, it.timeseries_length), np.float32)
        m[0, 4:] = 0.0
        m[1, 1] = 0.0
        return x, m
    return x, None


def _pair(name, kw, it):
    jlayer = getattr(jl, name)(**kw)
    jlayer.set_n_in(it)
    layer = layer_from_dict(jlayer.to_dict())
    return jlayer, layer


def _tensor(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("case,name,kw,it", CASES,
                         ids=[c[0] for c in CASES])
def test_layer_matches_jax(case, name, kw, it):
    jlayer, layer = _pair(name, kw, it)
    # the output type, and the JSON read back, as the JAX layer's
    assert layer.output_type(InputType.from_dict(it.to_dict())).to_dict() \
        == jlayer.output_type(it).to_dict()
    assert layer.to_dict() == {**jlayer.to_dict()}
    train = case.endswith("train") or case.endswith("locked")
    x, m = _inputs(case, it)
    jp = jlayer.init(jax.random.PRNGKey(7))
    jst = jlayer.init_state()
    p = {k: _tensor(v, True) for k, v in jp.items()}
    st = {k: _tensor(v) for k, v in jst.items()}
    if case == "batchnorm_cnn_inference":   # running statistics of a run
        r = np.random.RandomState(5)
        jst = {"mean": jnp.asarray(r.randn(3).astype(np.float32)),
               "var": jnp.asarray(r.rand(3).astype(np.float32) + 0.5)}
        st = {k: _tensor(v) for k, v in jst.items()}
    integer = case.startswith("embedding")
    xt = _tensor(x, not integer)
    kw_state = {"state": st} if st else {}
    mt = None if m is None else _tensor(m)
    y = layer.apply(p, xt, train=train, mask=mt, **kw_state)
    jy, jst1 = jlayer.apply(jp, jnp.asarray(x), jst, train=train,
                            mask=None if m is None else jnp.asarray(m))
    assert tuple(y.shape) == tuple(jy.shape)
    _close(y, jy, "forward")
    if st:      # the statistics the JAX layer returns, written in place
        for k in st:
            _close(st[k], jst1[k], f"state {k}")
    # gradients of a loss: the mean of a random projection of the output
    ct = (np.random.RandomState(11).randn(*jy.shape)
          / np.prod(jy.shape)).astype(np.float32)

    def jfn(p_, x_):
        out, _ = jlayer.apply(p_, x_, jst, train=train,
                              mask=None if m is None else jnp.asarray(m))
        return (out * ct).sum()
    jgp, jgx = jax.grad(jfn, argnums=(0, 1))(jp, jnp.asarray(x))
    st = {k: _tensor(v) for k, v in jst.items()}
    y = layer.apply(p, xt, train=train, mask=mt,
                    **({"state": st} if st else {}))
    (y * _tensor(ct)).sum().backward()
    if not integer:
        _close(xt.grad, jgx, "input gradient")
    assert sorted(p) == sorted(jgp)
    for k in p:
        _close(p[k].grad, jgp[k], f"gradient {k}")


def test_batchnorm_running_statistics_after_two_updates():
    """Two train-mode batches: the port's statistics, written in place,
    equal the JAX layer's returned ones; inference reads them, cast to
    the activation's dtype."""
    jlayer, layer = _pair("BatchNormalization", dict(decay=0.7),
                          cnn(4, 3, 5))
    jp = jlayer.init(jax.random.PRNGKey(0))
    p = {k: _tensor(v) for k, v in jp.items()}
    jst = jlayer.init_state()
    st = layer.init_state()
    tensors = [st["mean"], st["var"]]
    r = np.random.RandomState(3)
    for _ in range(2):
        x = (r.randn(B, 4, 3, 5) * 2 + 1).astype(np.float32)
        _, jst = jlayer.apply(jp, jnp.asarray(x), jst, train=True)
        layer.apply(p, _tensor(x), train=True, state=st)
    assert [st["mean"], st["var"]] == tensors          # the same storage
    assert st["mean"].data_ptr() == tensors[0].data_ptr()
    for k in st:
        _close(st[k], jst[k], k)
    x = r.randn(B, 4, 3, 5).astype(np.float32)
    jy, _ = jlayer.apply(jp, jnp.asarray(x), jst, train=False)
    _close(layer.apply(p, _tensor(x), state=st), jy, "inference")
    # under train with no state given, nothing is written
    before = {k: v.clone() for k, v in st.items()}
    layer.apply(p, _tensor(x), train=True, state=None)
    assert all(torch.equal(before[k], st[k]) for k in st)
    # a bfloat16 activation reads the float32 statistics in bfloat16
    yb = layer.apply({k: v.bfloat16() for k, v in p.items()},
                     _tensor(x).bfloat16(), state=st)
    assert yb.dtype == torch.bfloat16 and st["mean"].dtype == torch.float32


@pytest.mark.parametrize("n,k,s,d", [(7, 3, 2, 1), (8, 3, 2, 1),
                                     (9, 4, 2, 2), (5, 1, 3, 1),
                                     (6, 5, 1, 1)])
def test_same_pads_are_xla_padding(n, k, s, d):
    """``same_pads`` against ``lax.padtype_to_pads`` of the dilated
    window."""
    from jax import lax
    want = lax.padtype_to_pads((n,), ((k - 1) * d + 1,), (s,), "SAME")[0]
    assert same_pads(n, k, s, d) == tuple(want)
