"""Loss functions.

Counterpart of deeplearning4j_tpu/nn/losses.py (parity surface: the
reference's ``ILossFunction`` set, selected in output-layer configs). Every
loss takes ``(labels, preoutput, activation, mask)`` and returns a scalar
score that autograd differentiates.

All losses reduce with mean-over-batch, sum-over-output-dims -- the
reference's score convention. With a mask, the sum over unmasked entries is
divided by the number of examples (rows) with any unmasked entry.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation

_EPS = 1e-7


def _apply_mask(per_elem, mask):
    """Broadcast a per-timestep/per-example mask over a per-element loss."""
    if mask is None:
        return per_elem
    while mask.ndim < per_elem.ndim:
        mask = mask[..., None]
    return per_elem * mask


def _reduce(per_elem, mask):
    """Sum over feature dims, mean over examples (mask-aware)."""
    per_ex = per_elem.reshape(per_elem.shape[0], -1).sum(dim=-1)
    if mask is not None:
        rows = mask.reshape(mask.shape[0], -1).amax(dim=-1).sum()
        return per_ex.sum() / torch.clamp(rows, min=1.0)
    return per_ex.mean()


def _finish(per, mask):
    return _reduce(_apply_mask(per, mask), mask)


def l2(labels, preout, activation="identity", mask=None):
    # reference L2 = per-example SUM of squared errors
    out = get_activation(activation)(preout)
    return _finish((labels - out) ** 2, mask)


def mse(labels, preout, activation="identity", mask=None):
    # reference MSE = L2 / nOut
    return l2(labels, preout, activation, mask) / preout.shape[-1]


def l1(labels, preout, activation="identity", mask=None):
    out = get_activation(activation)(preout)
    return _finish(torch.abs(labels - out), mask)


def mae(labels, preout, activation="identity", mask=None):
    # reference MAE = L1 / nOut
    return l1(labels, preout, activation, mask) / preout.shape[-1]


def mcxent(labels, preout, activation="softmax", mask=None):
    """Multi-class cross entropy. With softmax activation, computed as
    log_softmax for numerical stability."""
    act_name = activation if isinstance(activation, str) else "softmax"
    if str(act_name).lower() == "softmax":
        logp = torch.log_softmax(preout, dim=-1)
    else:
        out = get_activation(activation)(preout)
        logp = torch.log(torch.clamp(out, _EPS, 1.0))
    return _finish(-labels * logp, mask)


def negativeloglikelihood(labels, preout, activation="softmax", mask=None):
    return mcxent(labels, preout, activation, mask)


def xent(labels, preout, activation="sigmoid", mask=None):
    """Binary cross entropy. With sigmoid activation uses the logits-stable
    form."""
    if str(activation).lower() == "sigmoid":
        x = preout
        per = (torch.clamp(x, min=0) - x * labels
               + torch.log1p(torch.exp(-torch.abs(x))))
    else:
        out = torch.clamp(get_activation(activation)(preout), _EPS, 1 - _EPS)
        per = -(labels * torch.log(out) + (1 - labels) * torch.log(1 - out))
    return _finish(per, mask)


def hinge(labels, preout, activation="identity", mask=None):
    out = get_activation(activation)(preout)
    return _finish(torch.clamp(1.0 - labels * out, min=0.0), mask)


def squared_hinge(labels, preout, activation="identity", mask=None):
    out = get_activation(activation)(preout)
    return _finish(torch.clamp(1.0 - labels * out, min=0.0) ** 2, mask)


def kl_divergence(labels, preout, activation="softmax", mask=None):
    out = torch.clamp(get_activation(activation)(preout), _EPS, 1.0)
    lab = torch.clamp(labels, _EPS, 1.0)
    return _finish(lab * (torch.log(lab) - torch.log(out)), mask)


def poisson(labels, preout, activation="identity", mask=None):
    out = get_activation(activation)(preout)
    return _finish(out - labels * torch.log(torch.clamp(out, min=_EPS)), mask)


def mape(labels, preout, activation="identity", mask=None):
    out = get_activation(activation)(preout)
    per = 100.0 * torch.abs((labels - out)
                            / torch.clamp(torch.abs(labels), min=_EPS))
    return _finish(per, mask)


def msle(labels, preout, activation="identity", mask=None):
    out = get_activation(activation)(preout)
    per = (torch.log1p(torch.clamp(out, min=0))
           - torch.log1p(torch.clamp(labels, min=0))) ** 2
    return _finish(per, mask)


def cosine_proximity(labels, preout, activation="identity", mask=None):
    out = get_activation(activation)(preout)
    ln = torch.linalg.norm(labels, dim=-1, keepdim=True)
    on = torch.linalg.norm(out, dim=-1, keepdim=True)
    cos = (labels * out) / torch.clamp(ln * on, min=_EPS)
    return _finish(-cos, mask)


def wasserstein(labels, preout, activation="identity", mask=None):
    out = get_activation(activation)(preout)
    return _finish(labels * out, mask)


LOSSES = {
    "mse": mse,
    "l1": l1,
    "l2": l2,
    "mae": mae,
    "mcxent": mcxent,
    "negativeloglikelihood": negativeloglikelihood,
    "xent": xent,
    "hinge": hinge,
    "squaredhinge": squared_hinge,
    "kldivergence": kl_divergence,
    "kl_divergence": kl_divergence,
    "poisson": poisson,
    "meanabsolutepercentageerror": mape,
    "mape": mape,
    "meansquaredlogarithmicerror": msle,
    "msle": msle,
    "cosineproximity": cosine_proximity,
    "cosine_proximity": cosine_proximity,
    "wasserstein": wasserstein,
}


def get_loss(name):
    if callable(name):
        return name
    key = str(name).lower().replace("_", "")
    key2 = str(name).lower()
    if key in LOSSES:
        return LOSSES[key]
    if key2 in LOSSES:
        return LOSSES[key2]
    raise ValueError(f"Unknown loss '{name}'. Available: {sorted(set(LOSSES))}")
