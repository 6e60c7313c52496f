"""Port losses (`deepcut_tpu_torch.ops.losses`) against `deepcut_tpu.ops.losses`.

Forward values and the cotangents of the hand-written backward passes
(`jax.vjp` on the JAX side, `torch.autograd.grad` on the port's) for the
same numpy inputs: NHWC for the JAX package, the NCHW transpose for the
port. Covered: `softmax_loss_vec` in all three option sets (sigmoid
cross-entropy, softmax, no_softmax) with and without weights and
normalisation, ignore labels (1000), live counts below and above the
100-clamp, an all-ignored map; `smooth_l1_loss` with and without weights,
weight sums below and above 100, all-zero weights. A `gradcheck` would fail
by design: neither backward is the autograd of its forward.

Tolerance: rtol 1e-5, atol 1e-7 — f32 sums over a few thousand elements
in another order.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcut_tpu.ops import losses as jl
from deepcut_tpu_torch.ops import losses as tl

RTOL, ATOL = 1e-5, 1e-7
COTANGENT = 1.7


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _close(got, ref, what):
    got = got.detach().numpy()
    if got.ndim == 4:
        got = got.transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL, err_msg=what)


def _labels(rng, shape, cross_entropy, ignore_frac):
    if cross_entropy:
        t = (rng.rand(*shape) < 0.3).astype(np.float32)
        t[rng.rand(*shape) < ignore_frac] = 1000.0          # per element
    else:
        n, h, w, c = shape
        t = np.eye(c, dtype=np.float32)[rng.randint(0, c, (n, h, w))]
        t[rng.rand(n, h, w) < ignore_frac, 0] = 1000.0      # per position (channel 0)
    return t


# (N, h, w): 84 positions (all counts under the clamp) and 240
GRIDS = {"under100": (2, 6, 7), "over100": (2, 10, 12)}
OPTIONS = {"sigmoid_ce": dict(cross_entropy=True),
           "softmax": dict(cross_entropy=False),
           "no_softmax": dict(cross_entropy=False, no_softmax=True)}


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("normalize", [True, False])
def test_softmax_loss_vec_matches_jax(grid, option, weighted, normalize):
    kw = dict(OPTIONS[option], normalize=normalize)
    rng = np.random.RandomState(zlib.crc32(f"{grid}{option}{weighted}{normalize}".encode()))
    shape = GRIDS[grid] + (5,)
    x = (2 * rng.randn(*shape)).astype(np.float32)
    if kw.get("no_softmax"):
        x = (rng.rand(*shape) * 0.98 + 0.01).astype(np.float32)   # probabilities
    t = _labels(rng, shape, kw["cross_entropy"], ignore_frac=0.2)
    w = (rng.rand(*shape) * 2).astype(np.float32) if weighted else None

    ref, vjp = jax.vjp(lambda s: jl.softmax_loss_vec(s, jnp.asarray(t), None if w is None
                                                     else jnp.asarray(w), **kw), jnp.asarray(x))
    (ref_g,) = vjp(jnp.float32(COTANGENT))
    xs = _nchw(x).requires_grad_()
    got = tl.softmax_loss_vec(xs, _nchw(t), None if w is None else _nchw(w), **kw)
    (got_g,) = torch.autograd.grad(got, xs, torch.tensor(COTANGENT))
    _close(got, ref, "loss")
    _close(got_g, ref_g, "cotangent")


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_softmax_loss_vec_all_ignored(option):
    kw = OPTIONS[option]
    rng = np.random.RandomState(3)
    x = (rng.rand(1, 4, 4, 3) * 0.9 + 0.05).astype(np.float32)
    t = np.full((1, 4, 4, 3), 1000.0, np.float32)
    ref, vjp = jax.vjp(lambda s: jl.softmax_loss_vec(s, jnp.asarray(t), **kw), jnp.asarray(x))
    xs = _nchw(x).requires_grad_()
    got = tl.softmax_loss_vec(xs, _nchw(t), **kw)
    assert float(got.detach()) == float(ref) == 0.0
    _close(torch.autograd.grad(got, xs, torch.tensor(COTANGENT))[0],
           vjp(jnp.float32(COTANGENT))[0], "cotangent")


@pytest.mark.parametrize("weights", ["none", "small_sum", "large_sum", "zero"])
def test_smooth_l1_matches_jax(weights):
    rng = np.random.RandomState(7)
    shape = (2, 5, 6, 8)
    pred = (2 * rng.randn(*shape)).astype(np.float32)
    target = (2 * rng.randn(*shape)).astype(np.float32)
    w = {"none": None,
         "small_sum": (rng.rand(*shape) < 0.1).astype(np.float32),      # sum ~ 48 < 100
         "large_sum": (rng.rand(*shape) * 1.5).astype(np.float32),      # sum ~ 360
         "zero": np.zeros(shape, np.float32)}[weights]
    ref, vjp = jax.vjp(lambda p, t: jl.smooth_l1_loss(p, t, None if w is None else jnp.asarray(w)),
                       jnp.asarray(pred), jnp.asarray(target))
    ref_gp, ref_gt = vjp(jnp.float32(COTANGENT))
    ps, ts = _nchw(pred).requires_grad_(), _nchw(target).requires_grad_()
    got = tl.smooth_l1_loss(ps, ts, None if w is None else _nchw(w))
    got_gp, got_gt = torch.autograd.grad(got, (ps, ts), torch.tensor(COTANGENT))
    _close(got, ref, "loss")
    _close(got_gp, ref_gp, "d pred")
    _close(got_gt, ref_gt, "d target")
    if weights == "zero":
        assert float(got.detach()) == 0.0
