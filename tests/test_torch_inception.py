"""The Inception zoo in the port (zoo/inception.py) held against the JAX
package on the CPU: GoogLeNet, InceptionResNetV1 and FaceNetNN4Small2 at
the small inputs the JAX package's own zoo tests build them at (64 x 64,
96 x 96, 96 x 96).

Each model is built in the JAX package and read by the port from its JSON
(which the port's zoo class builds identically) with the JAX model's
initial parameters and state: ``num_params`` and ``summary`` equal,
``output`` equal, one ``fit`` step (the model's own updater, Adam or
Nesterovs; the port's dropout fed the JAX step's draws) with equal loss,
parameters and BatchNormalization state, at the tolerances of
tests/test_torch_cnn_models.py (loss rtol 1e-5, the rest rtol 1e-4 / atol
1e-5, an Adam step's near-zero-gradient elements within 2 x lr).
InceptionResNetV1 and FaceNetNN4Small2 run in float64 in both packages.
InceptionResNetV1 sets no global activation, so its convolutions are
sigmoid (the zoo's default) before about 130 batch normalizations, which
multiply float32 rounding as ResNet50's do; FaceNetNN4Small2's train-mode
forward in float32 parts by 1-2% at its last batch normalizations (3 x 3
maps of two examples) between the two implementations, by 1e-9 in
float64 (float32 at full width is chip_smoke.py's phase 13). At 96
x 96 its last blocks are 1 x 1, where a batch normalization over two
examples normalizes two nearly equal sigmoid outputs, so it trains at
B=4 (at B=2 the train-mode forwards of the two float64 implementations
part by 3e-9 at the first such layer, ``c1_b1c_bn``, and by 4e-4 at the
loss; at B=4 the losses agree to 3e-13). The face nets' ``embeddings``
have unit L2 norm, and a fit step moves the center-loss ``centers`` from
zero as JAX's step does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.zoo import inception as jinception

from deeplearning4j_tpu_torch.zoo import (FaceNetNN4Small2, GoogLeNet,
                                          InceptionResNetV1)

from deeplearning4j_tpu_torch.nn import dropout as D

from test_torch_cnn_models import (_batch, _jax_net, _model_matches_jax,
                                   port_of)
from test_torch_dropout import JaxKeys

# (name, JAX zoo class, port zoo class, constructor keywords, batch, dtype)
MODELS = [
    ("googlenet", jinception.GoogLeNet, GoogLeNet,
     dict(input_shape=(64, 64, 3)), 2, "float32"),
    ("inception_resnet_v1", jinception.InceptionResNetV1, InceptionResNetV1,
     dict(input_shape=(96, 96, 3)), 4, "float64"),
    ("facenet_nn4_small2", jinception.FaceNetNN4Small2, FaceNetNN4Small2,
     dict(input_shape=(96, 96, 3)), 2, "float64"),
]
CLASSES = 5


class JaxKeysX64(JaxKeys):
    """The seam's uniforms in the JAX package's canonical float type: a
    Bernoulli of a Python probability draws float64 uniforms under
    ``jax.enable_x64``."""

    def uniform(self, shape, dtype, device, gen):
        self.kinds.append("uniform")
        jdt = jax.dtypes.canonicalize_dtype(jnp.float64)
        return torch.from_numpy(np.array(jax.random.uniform(
            self.keys.pop(0), shape, jdt)))


@pytest.fixture
def seam(monkeypatch):
    feed = JaxKeysX64()
    monkeypatch.setattr(D, "uniform", feed.uniform)
    monkeypatch.setattr(D, "normal", feed.normal)
    return feed


@pytest.mark.parametrize("name,jcls,cls,kw,n,dtype", MODELS,
                         ids=[m[0] for m in MODELS])
def test_model_matches_jax(name, jcls, cls, kw, n, dtype, seam):
    with jax.enable_x64(dtype == "float64"):
        _model_matches_jax(jcls, cls, kw, n, dtype, seam)


@pytest.mark.parametrize("jcls", [jinception.FaceNetNN4Small2,
                                  jinception.InceptionResNetV1],
                         ids=["facenet_nn4_small2", "inception_resnet_v1"])
def test_embeddings_and_centers(jcls):
    """Unit-norm embeddings, and centers that start at zero and move in a
    fit step (their values against JAX's: test_model_matches_jax)."""
    jzoo = jcls(num_classes=CLASSES, input_shape=(96, 96, 3))
    net = port_of(_jax_net(jzoo, "float32"))
    x, y = _batch(jzoo.input_shape, n=3)
    acts, _ = net._activations(net.params, [torch.from_numpy(x)])
    norms = acts["embeddings"].norm(dim=-1)
    torch.testing.assert_close(norms, torch.ones(3), rtol=0, atol=1e-5)
    head = net.conf.network_outputs[0]
    assert not net.params[head]["centers"].any()
    net.fit([x], [y])
    moved = net.params[head]["centers"].abs().amax(dim=1) > 0
    assert moved.tolist() == [c in set(y.argmax(-1)) for c in range(CLASSES)]
