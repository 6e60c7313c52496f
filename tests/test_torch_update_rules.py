"""Port update rules (`deepcut_tpu_torch.solver.update_rules`) against
`deepcut_tpu.solver.update_rules`.

The same numpy params, gradients and multipliers go through three `step`s
of each package, for every solver type, with per-leaf lr/decay multipliers
(the BatchNorm statistics frozen, one leaf at half rate), global-norm
clipping, iter_size 2, and L1 and L2 decay. Both sides run f32 on the CPU
and keep the reference's order of operations; the tolerance (rtol 2e-6,
atol 1e-8) leaves room for XLA contracting a product and a sum into one
fused multiply-add where PyTorch rounds twice.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcut_tpu.solver import update_rules as ju
from deepcut_tpu_torch.solver import update_rules as tu

SOLVERS = ["SGD", "Nesterov", "AdaGrad", "RMSProp", "AdaDelta", "Adam"]
SHAPES = {"conv1": {"w": (4, 3, 2, 2), "b": (4,)},
          "bn_conv1": {"mean": (4,), "var": (4,), "scale_factor": (1,)},
          "scale_conv1": {"gamma": (4,), "beta": (4,)}}
RTOL, ATOL = 2e-6, 1e-8


def _tree(rng, scale=1.0):
    return {n: {k: (scale * rng.randn(*s)).astype(np.float32) for k, s in e.items()}
            for n, e in SHAPES.items()}


def _mults():
    m = {n: {k: (0.0 if n.startswith("bn") else 1.0) for k in e} for n, e in SHAPES.items()}
    m["scale_conv1"]["beta"] = 0.5
    return m


def _to_torch(tree):
    return {n: {k: torch.tensor(v) for k, v in e.items()} for n, e in tree.items()}


def _assert_tree(got, ref, what):
    for n, e in ref.items():
        for k, v in e.items():
            np.testing.assert_allclose(got[n][k].numpy(), np.asarray(v), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} {n}/{k}")


CONFIGS = {
    "plain": dict(weight_decay=0.0),
    "l2_decay_clip": dict(weight_decay=0.01, clip_gradients=0.5),
    "l1_decay_iter_size": dict(weight_decay=0.02, regularization_type="L1", iter_size=2),
    "multistep": dict(lr_policy="multistep", stepvalue=(1, 2), gamma=0.5, weight_decay=0.001),
}


@pytest.mark.parametrize("solver_type", SOLVERS)
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_three_steps_match_jax(solver_type, config):
    cfg = ju.SolverConfig(solver_type=solver_type, base_lr=0.05, momentum=0.9,
                          **CONFIGS[config])
    tcfg = tu.SolverConfig(**dataclasses.asdict(cfg))
    rng = np.random.RandomState(0)
    params = _tree(rng)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), _to_torch(params)
    js, ts = ju.init_state(cfg, jp), tu.init_state(tcfg, tp)
    mults = _mults()
    jstep = jax.jit(lambda p, g, s: ju.step(cfg, p, g, s, lr_mults=mults, decay_mults=mults))
    for i in range(3):
        grads = _tree(rng, scale=0.3)
        grads["bn_conv1"] = {k: np.zeros_like(v) for k, v in grads["bn_conv1"].items()}
        jp, js = jstep(jp, jax.tree_util.tree_map(jnp.asarray, grads), js)
        tp, ts = tu.step(tcfg, tp, _to_torch(grads), ts, lr_mults=mults, decay_mults=mults)
        assert ts["iter"] == int(js["iter"]) == i + 1
        _assert_tree(tp, jp, f"params after step {i + 1}")
        for key in ("history", "update_sq", "m", "v"):
            assert (key in ts) == (key in js)
            if key in ts:
                _assert_tree(ts[key], js[key], f"{key} after step {i + 1}")
    # the BN statistics never moved
    for k, v in params["bn_conv1"].items():
        assert np.array_equal(tp["bn_conv1"][k].numpy(), v)


def test_default_mults_are_ones():
    cfg = tu.SolverConfig(solver_type="SGD", base_lr=0.1, weight_decay=0.01)
    jcfg = ju.SolverConfig(**dataclasses.asdict(cfg))
    rng = np.random.RandomState(1)
    params, grads = _tree(rng), _tree(rng)
    jp, _ = ju.step(jcfg, jax.tree_util.tree_map(jnp.asarray, params),
                    jax.tree_util.tree_map(jnp.asarray, grads),
                    ju.init_state(jcfg, jax.tree_util.tree_map(jnp.asarray, params)))
    tp = _to_torch(params)
    tp, _ = tu.step(cfg, tp, _to_torch(grads), tu.init_state(cfg, tp))
    _assert_tree(tp, jp, "params")


POLICIES = {
    "fixed": {},
    "step": dict(stepsize=30, gamma=0.3),
    "exp": dict(gamma=0.999),
    "inv": dict(gamma=0.001, power=0.75),
    "multistep": dict(stepvalue=(10, 50, 200), gamma=0.2),
    "multistep_lr": dict(stepvalue=(10, 50), stagelr=(0.005, 0.002, 0.001)),
    "multistep_stagelr_short": dict(stepvalue=(10, 50, 200), stagelr=(0.005, 0.002)),
    "poly": dict(power=0.9, max_iter=1000),
    "sigmoid": dict(gamma=0.05, stepsize=100),
}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_lr_policies_match_jax(name):
    kw = dict(POLICIES[name])
    policy = "multistep" if name.startswith("multistep_stagelr") else name
    cfg = ju.SolverConfig(base_lr=0.01, lr_policy=policy, **kw)
    tcfg = tu.SolverConfig(**dataclasses.asdict(cfg))
    for it in (0, 1, 9, 10, 11, 49, 50, 120, 199, 200, 999):
        ref = float(ju.learning_rate(cfg, it))
        got = tu.learning_rate(tcfg, it)
        assert got == pytest.approx(ref, rel=1e-6, abs=0.0), (name, it, got, ref)


def test_unknown_solver_and_policy_raise():
    with pytest.raises(ValueError, match="solver type"):
        tu.init_state(tu.SolverConfig(solver_type="LBFGS"), _to_torch(_tree(np.random.RandomState(0))))
    with pytest.raises(ValueError, match="lr_policy"):
        tu.learning_rate(tu.SolverConfig(lr_policy="cosine"), 3)
