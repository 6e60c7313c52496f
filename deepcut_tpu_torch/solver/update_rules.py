"""Solver update rules and learning-rate policies, Caffe-exact, in PyTorch.

Counterpart of `deepcut_tpu.solver.update_rules` (reference:
src/caffe/solvers/{sgd,nesterov,adagrad,rmsprop,adadelta,adam}_solver.cpp).
These are not `torch.optim`'s rules: Caffe folds the learning rate INTO the
history (SGD momentum ``h = m*h + lr*g; w -= h``, where torch.optim keeps
``buf = m*buf + g; w -= lr*buf``, which differs once the rate changes),
Adam applies its bias correction to the rate and adds ``delta`` outside the
square root, RMSProp adds ``delta`` outside the root, and AdaDelta scales by
the rate after the step.

Parameters, gradients and solver state are Caffe-named dicts of tensors
(``{layer: {key: tensor}}``). `step` works on them IN PLACE (the buffers
are donated, as the JAX package donates them to its jitted step) and
returns them. It issues ``torch._foreach_*`` ops over all leaves at once
(some 900 for ResNet-152), one product or sum per op, in the reference's
order of operations, so that each value rounds as it does there.

The learning rate is computed on the host in float32, as the JAX package
computes it on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

Tree = Mapping[str, Mapping[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    solver_type: str = "SGD"  # SGD | Nesterov | AdaGrad | RMSProp | AdaDelta | Adam
    base_lr: float = 0.01
    lr_policy: str = "fixed"  # fixed|step|exp|inv|multistep|poly|sigmoid|multistep_lr
    gamma: float = 0.1
    power: float = 1.0
    stepsize: int = 100000
    stepvalue: Tuple[int, ...] = ()
    stagelr: Tuple[float, ...] = ()  # fork: explicit per-stage lrs
    max_iter: int = 1000000
    momentum: float = 0.9
    momentum2: float = 0.999  # Adam beta2
    rms_decay: float = 0.99
    delta: float = 1e-8
    weight_decay: float = 0.0005
    regularization_type: str = "L2"
    clip_gradients: float = -1.0
    iter_size: int = 1


_f = np.float32


def learning_rate(cfg: SolverConfig, it) -> float:
    """The rate at iteration `it` (GetLearningRate, sgd_solver.cpp:26-67,
    plus the fork's ``multistep_lr``), computed in float32."""
    it = _f(int(it))
    p = cfg.lr_policy
    base = _f(cfg.base_lr)
    if p == "fixed":
        r = base
    elif p == "step":
        r = base * np.power(_f(cfg.gamma), np.floor(it / _f(cfg.stepsize)))
    elif p == "exp":
        r = base * np.power(_f(cfg.gamma), it)
    elif p == "inv":
        r = base * np.power(_f(1.0) + _f(cfg.gamma) * it, _f(-cfg.power))
    elif p in ("multistep", "multistep_lr"):
        stage = int(np.sum(it >= np.asarray(cfg.stepvalue, np.float32))) if cfg.stepvalue else 0
        if cfg.stagelr:
            # caffe.proto field multistep_lr=41 (sgd_solver.cpp:49-50): an
            # explicit rate per stage, stage 0 included
            r = _f(cfg.stagelr[min(stage, len(cfg.stagelr) - 1)])
        else:
            r = base * np.power(_f(cfg.gamma), _f(stage))
    elif p == "poly":
        r = base * np.power(_f(1.0) - it / _f(cfg.max_iter), _f(cfg.power))
    elif p == "sigmoid":
        r = base / (_f(1.0) + np.exp(_f(-cfg.gamma) * (it - _f(cfg.stepsize))))
    else:
        raise ValueError(f"unknown lr_policy {cfg.lr_policy!r}")
    return float(_f(r))


def _keys(tree: Tree) -> List[Tuple[str, str]]:
    return [(name, k) for name, entry in tree.items() for k in entry]


def _gather(tree: Mapping, keys) -> List[Any]:
    return [tree[name][k] for name, k in keys]


def _mults(mults: Optional[Mapping], keys) -> List[float]:
    return [1.0] * len(keys) if mults is None else [float(m) for m in _gather(mults, keys)]


@torch.no_grad()
def preprocess_grads(cfg: SolverConfig, params: Tree, grads: Tree,
                     decay_mults: Optional[Mapping] = None) -> Tree:
    """Clip (global L2), normalise by iter_size, and add regularisation —
    the ClipGradients/Normalize/Regularize trio (sgd_solver.cpp:69-120).
    Updates `grads` in place and returns it."""
    keys = _keys(params)
    g = _gather(grads, keys)
    if cfg.clip_gradients > 0:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        torch._foreach_mul_(g, torch.where(norm > cfg.clip_gradients,
                                           cfg.clip_gradients / norm, 1.0))
    if cfg.iter_size > 1:
        torch._foreach_div_(g, float(cfg.iter_size))
    if cfg.weight_decay > 0:
        w = _gather(params, keys)
        if cfg.regularization_type != "L2":
            w = [torch.sign(t) for t in w]
        decay = [cfg.weight_decay * m for m in _mults(decay_mults, keys)]
        torch._foreach_add_(g, torch._foreach_mul(w, decay))
    return grads


def init_state(cfg: SolverConfig, params: Tree) -> Dict[str, Any]:
    """Zero history on each leaf's device and memory format, iteration 0."""
    zeros = lambda: {name: {k: torch.zeros_like(v, requires_grad=False) for k, v in entry.items()}
                     for name, entry in params.items()}
    state: Dict[str, Any] = {"iter": 0}
    t = cfg.solver_type
    if t in ("SGD", "Nesterov", "AdaGrad", "RMSProp"):
        state["history"] = zeros()
    elif t == "AdaDelta":
        state["history"] = zeros()
        state["update_sq"] = zeros()
    elif t == "Adam":
        state["m"] = zeros()
        state["v"] = zeros()
    else:
        raise ValueError(f"unknown solver type {t!r}")
    return state


def _sq_scaled(g: List[torch.Tensor], c: float) -> List[torch.Tensor]:
    """(c * g) * g, rounded after each product as the reference writes it."""
    t = torch._foreach_mul(g, c)
    torch._foreach_mul_(t, g)
    return t


@torch.no_grad()
def apply_update(cfg: SolverConfig, params: Tree, grads: Tree, state: Dict[str, Any],
                 lr_mults: Optional[Mapping] = None) -> Tuple[Tree, Dict[str, Any]]:
    """One update with already-preprocessed `grads` (ComputeUpdateValue of
    each reference solver). Updates `params` and `state` in place and
    returns them. lr_mults: per-leaf ParamSpec lr multipliers."""
    keys = _keys(params)
    it = int(state["iter"])
    rate = _f(learning_rate(cfg, it))
    lrs = [float(rate * _f(m)) for m in _mults(lr_mults, keys)]
    w, g = _gather(params, keys), _gather(grads, keys)
    t = cfg.solver_type
    mom = cfg.momentum

    if t in ("SGD", "Nesterov"):
        h = _gather(state["history"], keys)
        lr_g = torch._foreach_mul(g, lrs)
        if t == "Nesterov":
            mh = torch._foreach_mul(h, mom)
        torch._foreach_mul_(h, mom)
        torch._foreach_add_(h, lr_g)                       # h2 = m*h + lr*g
        if t == "SGD":
            torch._foreach_sub_(w, h)
        else:
            step = torch._foreach_mul(h, 1.0 + mom)        # (1+m)*h2 - m*h
            torch._foreach_sub_(step, mh)
            torch._foreach_sub_(w, step)
    elif t in ("AdaGrad", "RMSProp"):
        h = _gather(state["history"], keys)
        if t == "AdaGrad":
            torch._foreach_add_(h, torch._foreach_mul(g, g))              # h + g*g
        else:
            sq = _sq_scaled(g, 1.0 - cfg.rms_decay)
            torch._foreach_mul_(h, cfg.rms_decay)
            torch._foreach_add_(h, sq)                                   # rd*h + (1-rd)*g*g
        step = torch._foreach_mul(g, lrs)
        den = torch._foreach_sqrt(h)
        torch._foreach_add_(den, cfg.delta)
        torch._foreach_div_(step, den)                                   # lr*g / (sqrt(h2)+delta)
        torch._foreach_sub_(w, step)
    elif t == "AdaDelta":
        h, u = _gather(state["history"], keys), _gather(state["update_sq"], keys)
        sq = _sq_scaled(g, 1.0 - mom)
        torch._foreach_mul_(h, mom)
        torch._foreach_add_(h, sq)                                       # h2
        ratio = torch._foreach_add(u, cfg.delta)
        torch._foreach_div_(ratio, torch._foreach_add(h, cfg.delta))
        step = torch._foreach_mul(g, torch._foreach_sqrt(ratio))         # g*sqrt((u+d)/(h2+d))
        usq = _sq_scaled(step, 1.0 - mom)
        torch._foreach_mul_(u, mom)
        torch._foreach_add_(u, usq)                                      # u2
        torch._foreach_sub_(w, torch._foreach_mul(step, lrs))
    elif t == "Adam":
        b1, b2 = cfg.momentum, cfg.momentum2
        tstep = _f(it + 1)
        corr = np.sqrt(_f(1.0) - np.power(_f(b2), tstep)) / (_f(1.0) - np.power(_f(b1), tstep))
        m, v = _gather(state["m"], keys), _gather(state["v"], keys)
        mg = torch._foreach_mul(g, 1.0 - b1)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, mg)                                       # m2
        vg = _sq_scaled(g, 1.0 - b2)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, vg)                                       # v2
        step = torch._foreach_mul(m, [float(_f(lr) * _f(corr)) for lr in lrs])
        den = torch._foreach_sqrt(v)
        torch._foreach_add_(den, cfg.delta)
        torch._foreach_div_(step, den)
        torch._foreach_sub_(w, step)
    else:
        raise ValueError(f"unknown solver type {t!r}")
    state["iter"] = it + 1
    return params, state


def step(cfg: SolverConfig, params: Tree, grads: Tree, state: Dict[str, Any], *,
         lr_mults: Optional[Mapping] = None, decay_mults: Optional[Mapping] = None
         ) -> Tuple[Tree, Dict[str, Any]]:
    """Full ApplyUpdate: clip -> normalise -> regularise -> rule update, in
    place on `params`, `grads` and `state`."""
    grads = preprocess_grads(cfg, params, grads, decay_mults)
    return apply_update(cfg, params, grads, state, lr_mults)
