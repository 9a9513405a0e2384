"""One prototxt net through both packages' builders, for the port's tests.

`run_both` builds the same text as `mscnn_tpu/models/netbuilder.py::Net`
and `mscnn_torch/models/netbuilder.py::Net`, checks that the port's init
has the JAX init's leaves and shapes, moves its values (so that every
bias, slope and statistic is nonzero) and gives them to both, runs both
forwards on the same numpy inputs (the port's Dropout and
STOCHASTIC draws derived from JAX's key, `_torch_jax_draws.net_draws`)
and the gradients of the loss plus a fixed random weighting of the named
tops; `check_both` holds the port to JAX at rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_jax_draws import net_draws
from mscnn_torch.io import bridge
from mscnn_torch.models import netbuilder as TNB
from mscnn_tpu.models import netbuilder as JNB

RTOL, ATOL = 1e-5, 1e-6
R = np.random.RandomState


def _perturb(jp, seed=30):
    """Every param leaf moved off its init: biases, slopes and statistics
    nonzero, variances positive."""
    rng = R(seed)
    out = {}
    for n, p in jp.items():
        out[n] = {}
        for k, v in p.items():
            v = np.asarray(v, np.float32)
            d = rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
            out[n][k] = (np.abs(v + d) + 0.5 if k == "var" else v + d
                         ).astype(np.float32)
    return out


def _float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def run_both(proto, inputs, train, tops, *, jnet=None, tnet=None,
             weight_seed=40, key_seed=3):
    """(jax, port), each (tops, input grads, param grads): param grads in
    JAX's layouts, the port's brought back to them. jnet / tnet: nets
    already built (e.g. with Python layers registered in each package)."""
    shapes = {k: v.shape for k, v in inputs.items()}
    jn = jnet or JNB.Net(proto, "TRAIN", input_shapes=shapes)
    tn = tnet or TNB.Net(proto, "TRAIN", input_shapes=shapes)
    # the port's init, in JAX's layouts, must have the JAX init's leaves
    # and shapes (traced, not compiled); both then run on those values
    layouts = tn.param_layouts()
    jp = bridge.to_jax_net_params(
        tn.init(torch.Generator().manual_seed(0), device="cpu"), layouts)
    want = jax.eval_shape(jn.init, jax.random.key(0))
    assert jax.tree.map(np.shape, jp) == jax.tree.map(lambda a: a.shape, want)
    jp = _perturb(jp)
    tp = bridge.from_jax_net_params(jp, layouts)
    key = jax.random.key(key_seed)
    draws = None
    if train:
        draws = net_draws(key, tn)
    fin = {k: v for k, v in inputs.items() if _float(v)}
    oth = {k: v for k, v in inputs.items() if not _float(v)}

    shapes_out = jax.eval_shape(
        lambda p, x: {t: jn.apply(p, x, train=train, key=key)[t] for t in tops},
        jax.tree.map(jnp.asarray, jp),
        {k: jnp.asarray(v) for k, v in inputs.items()})
    wts = {t: R(weight_seed + i).uniform(-1, 1, shapes_out[t].shape)
           .astype(np.float32) for i, t in enumerate(tops)
           if jnp.issubdtype(shapes_out[t].dtype, jnp.floating)}

    def jobj(p, xs):
        b = jn.apply(p, {**xs, **{k: jnp.asarray(v) for k, v in oth.items()}},
                     train=train, key=key)
        s = b["loss"] + sum((b[t] * w).sum() for t, w in wts.items())
        return s, {t: b[t] for t in tops}

    (_, jt), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jobj, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, jp), {k: jnp.asarray(v) for k, v in fin.items()})

    leaves = {n: {k: v.clone().requires_grad_() for k, v in p.items()}
              for n, p in tp.items()}
    xs = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in fin.items()}
    xs.update({k: torch.from_numpy(v.copy()) for k, v in oth.items()})
    b = tn.apply(leaves, xs, train=train, draws=draws)
    s = b["loss"] + sum((b[t] * torch.from_numpy(w)).sum() for t, w in wts.items())
    if torch.is_tensor(s) and s.requires_grad:
        s.backward()
    tgp = bridge.to_jax_net_params(
        {n: {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in p.items()} for n, p in leaves.items()}, layouts)
    tgx = {k: (xs[k].grad if xs[k].grad is not None else torch.zeros_like(xs[k]))
           .numpy() for k in fin}
    return ((jt, jgx, jgp), ({t: b[t] for t in tops}, tgx, tgp))


def close(got, want, what, scaled=False):
    """rtol 1e-5 / atol 1e-6; scaled: atol 1e-6 times the largest |want|
    (at least 1), for nets of several layers, whose float32 sums in
    another order (XLA's dot and conv against PyTorch's) leave an error
    that grows with the magnitude of what they sum."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = ATOL * max(1.0, float(np.abs(want).max(initial=0.0))) if scaled \
        else ATOL
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)


def check_both(res, scaled=False, grads=True):
    (jt, jgx, jgp), (tt, tgx, tgp) = res
    for t in jt:
        close(tt[t], jt[t], f"top {t}", scaled)
    if not grads:
        return
    for k in jgx:
        close(tgx[k], jgx[k], f"grad of input {k}", scaled)
    for n in jgp:
        for k in jgp[n]:
            close(tgp[n][k], jgp[n][k], f"grad of {n}.{k}", scaled)


