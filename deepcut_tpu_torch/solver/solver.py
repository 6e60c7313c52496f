"""The DeeperCut training loop (the reference Solver, src/caffe/solver.cpp),
in PyTorch.

Counterpart of the pose half of `deepcut_tpu.solver.solver`:
`SolverParams` parses the same solver.prototxt files; `PoseSolver` runs
prefetched batches through the forward, the fork's losses and their
hand-written backward passes, with iter_size accumulation on the host, the
smoothed-loss display line, the `test_interval` eval hook, SIGINT -> stop /
SIGHUP -> snapshot, snapshots and restore. `GraphSolver` belongs to the
engine slice and is not here.

Snapshots are the JAX package's: a ``.npz`` with ``params/<layer>/<key>``
and ``state/...`` entries in its layouts (HWIO conv weights), so either
package restores the other's, and a reference-readable ``.caffemodel``.
"""

from __future__ import annotations

import dataclasses
import os
import signal as _signal
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from deepcut_tpu_torch.proto import text_format
from deepcut_tpu_torch.proto.text_format import PbNode
from deepcut_tpu_torch.models.convert import params_from_numpy, params_to_numpy, save_caffemodel
from deepcut_tpu_torch.models.resnet import DeeperCut, init_params
from deepcut_tpu_torch.models.train import bn_frozen_mults
from deepcut_tpu_torch.parallel.train_step import MESH_MESSAGE, GradStep, batch_preparer
from deepcut_tpu_torch.solver import update_rules
from deepcut_tpu_torch.solver.update_rules import SolverConfig


@dataclasses.dataclass
class SolverParams:
    """Loop-level knobs from SolverParameter + the update-rule SolverConfig
    (the fields `deepcut_tpu.solver.solver.SolverParams` reads for the pose
    trainer and the CLI)."""

    config: SolverConfig
    max_iter: int = 100000
    display: int = 20
    average_loss: int = 1
    snapshot: int = 0
    snapshot_prefix: str = "snapshot"
    snapshot_format: str = "BINARYPROTO"
    test_interval: int = 0
    random_seed: int = -1
    train_net: str = ""
    net: str = ""
    net_param: Optional[PbNode] = None
    train_net_param: Optional[PbNode] = None
    train_state: Optional[PbNode] = None
    test_initialization: bool = True
    snapshot_after_train: bool = True
    has_snapshot_prefix: bool = False

    @staticmethod
    def from_prototxt(path_or_text: str) -> "SolverParams":
        if "\n" not in path_or_text and os.path.exists(path_or_text):
            node = text_format.parse_file(path_or_text)
        else:
            node = text_format.parse(path_or_text)
        return SolverParams.from_node(node)

    @staticmethod
    def from_node(node: PbNode) -> "SolverParams":
        # legacy solver_type enum (upgrade_proto.cpp semantics)
        legacy = {0: "SGD", 1: "Nesterov", 2: "AdaGrad", 3: "RMSProp",
                  4: "AdaDelta", 5: "Adam"}
        stype = node.get_str("type", None)
        if stype is None:
            st = node.get("solver_type", 0)
            stype = legacy.get(int(st) if not isinstance(st, str) else
                               {"SGD": 0, "NESTEROV": 1, "ADAGRAD": 2,
                                "RMSPROP": 3, "ADADELTA": 4, "ADAM": 5}.get(st, 0), "SGD")
        cfg = SolverConfig(
            solver_type=stype,
            base_lr=node.get_float("base_lr", 0.01),
            lr_policy=node.get_str("lr_policy", "fixed"),
            gamma=node.get_float("gamma", 0.1),
            power=node.get_float("power", 1.0),
            stepsize=node.get_int("stepsize", 100000),
            stepvalue=tuple(int(v) for v in node.get_list("stepvalue")),
            stagelr=tuple(float(v) for v in node.get_list("multistep_lr")),
            max_iter=node.get_int("max_iter", 100000),
            momentum=node.get_float("momentum", 0.9),
            momentum2=node.get_float("momentum2", 0.999),
            rms_decay=node.get_float("rms_decay", 0.99),
            delta=node.get_float("delta", 1e-8),
            weight_decay=node.get_float("weight_decay", 0.0005),
            regularization_type=node.get_str("regularization_type", "L2"),
            clip_gradients=node.get_float("clip_gradients", -1.0),
            iter_size=node.get_int("iter_size", 1),
        )
        return SolverParams(
            config=cfg,
            max_iter=node.get_int("max_iter", 100000),
            display=node.get_int("display", 20),
            average_loss=node.get_int("average_loss", 1),
            snapshot=node.get_int("snapshot", 0),
            snapshot_prefix=node.get_str("snapshot_prefix", "snapshot"),
            snapshot_format=node.get_str("snapshot_format", "BINARYPROTO"),
            test_interval=node.get_int("test_interval", 0),
            random_seed=node.get_int("random_seed", -1),
            train_net=node.get_str("train_net", ""),
            net=node.get_str("net", ""),
            net_param=node.get("net_param"),
            train_net_param=node.get("train_net_param"),
            train_state=node.get("train_state"),
            test_initialization=node.get_bool("test_initialization", True),
            snapshot_after_train=node.get_bool("snapshot_after_train", True),
            has_snapshot_prefix=node.has("snapshot_prefix"),
        )

    def resolve_train_net(self):
        """-> (model_def, stages, level) for the TRAIN net, honoring the
        exactly-one-of {net, net_param, train_net, train_net_param} contract
        (Solver::InitTrainNet, solver.cpp:67-110). model_def is a file path
        or an inline NetParameter PbNode."""
        sources = [s for s in (self.net or None, self.net_param, self.train_net or None,
                               self.train_net_param) if s is not None]
        if len(sources) > 1:
            raise ValueError("SolverParameter must not contain more than one of net, "
                             "net_param, train_net, train_net_param")
        if not sources:
            raise ValueError("SolverParameter must specify a train net using one of: "
                             "net, net_param, train_net, train_net_param")
        model_def = self.train_net_param or self.net_param or self.train_net or self.net
        if self.train_state is None:
            return model_def, (), None
        st = self.train_state
        return (model_def, tuple(str(s) for s in st.get_list("stage")),
                st.get_int("level", 0) if st.has("level") else None)


# -- checkpoints (the JAX package's .npz keys and layouts) --------------------


def _esc(key: str) -> str:
    # Caffe layer names may contain '/'; percent-escape it for the key path
    return key.replace("%", "%25").replace("/", "%2F")


def _unesc(key: str) -> str:
    return key.replace("%2F", "/").replace("%25", "%")


def _flatten(tree: Any, prefix: str) -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        out: Dict[str, np.ndarray] = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{_esc(k)}"))
        return out
    return {prefix: np.asarray(tree)}


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = [_unesc(p) for p in key.split("/")]
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return root


def save_checkpoint(path: str, params, state: Dict[str, Any]) -> None:
    """params/state (the port's layouts, any device) -> the JAX package's
    ``.npz``: params and every state tree in its layouts, ``iter`` int32."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    flat = _flatten(params_to_numpy(params), "params")
    for k, v in state.items():
        if k == "iter":
            flat["state/iter"] = np.asarray(int(v), np.int32)
        else:
            flat.update(_flatten(params_to_numpy(v), f"state/{_esc(k)}"))
    np.savez(path, **flat)


def load_checkpoint(path: str):
    """A ``.npz`` written by either package -> (params, state) in the port's
    layouts, f32 on the CPU, ``state["iter"]`` an int."""
    with np.load(path, allow_pickle=False) as data:
        tree = _unflatten({k: data[k] for k in data.files})
    state: Dict[str, Any] = {}
    for k, v in tree.get("state", {}).items():
        state[k] = int(v) if k == "iter" else params_from_numpy(v)
    return params_from_numpy(tree["params"]), state


# -- signal handling (reference: util/signal_handler.cpp) -------------------


class SignalHandler:
    """Polled signal->action flags. Defaults SIGINT -> STOP, SIGHUP ->
    SNAPSHOT; both effects are configurable to stop/snapshot/none (the CLI's
    -sigint_effect / -sighup_effect flags, caffe.cpp:44-48)."""

    EFFECTS = ("stop", "snapshot", "none")

    def __init__(self, enable: bool = True, sigint_effect: str = "stop",
                 sighup_effect: str = "snapshot"):
        for eff in (sigint_effect, sighup_effect):
            if eff not in self.EFFECTS:
                raise ValueError(f'Invalid signal effect "{eff}" was specified')
        self.stop_requested = False
        self.snapshot_requested = False
        self._sigint_effect = sigint_effect
        self._sighup_effect = sighup_effect
        if enable:
            try:
                _signal.signal(_signal.SIGINT, self._on_sigint)
                _signal.signal(_signal.SIGHUP, self._on_sighup)
            except ValueError:
                pass  # not the main thread

    def _apply(self, effect: str):
        if effect == "stop":
            self.stop_requested = True
        elif effect == "snapshot":
            self.snapshot_requested = True

    def _on_sigint(self, *_):
        self._apply(self._sigint_effect)

    def _on_sighup(self, *_):
        self._apply(self._sighup_effect)


class PoseSolver:
    """DeeperCut training driver on one device (``"cuda"`` by default).

    batch_source: callable returning the next batch dict (host numpy, the
    layout of `data.pipeline.PoseDataSource`). net_params: the
    port's Caffe-named torch param dict (`models.resnet.init_params`,
    `models.convert.params_from_numpy`); a seeded random init otherwise.
    target_cfg (pose.targets.TargetConfig) rasterizes ``anno_*`` batches on
    the device (`pose.targets_device`); batches with ``image_raw`` are
    warped on the device (`pose.augment_device`).

    eval_fn is called as ``eval_fn(net_params, iter)`` on `test_interval`
    boundaries, before that iteration's update (Solver::Step's TestAll
    gate); a returned string is logged."""

    def __init__(self, params: SolverParams, model_cfg, batch_source: Callable[[], Dict[str, Any]],
                 *, net_params=None, mesh=None, lr_mults=None, handle_signals: bool = True,
                 log: Callable[[str], None] = print, target_cfg=None, target_stats=None,
                 eval_fn: Optional[Callable[[Any, int], Optional[str]]] = None,
                 sigint_effect: str = "stop", sighup_effect: str = "snapshot",
                 device="cuda"):
        if mesh is not None:
            raise NotImplementedError(MESH_MESSAGE)
        self.params_cfg = params
        self.model_cfg = model_cfg
        self.batch_source = batch_source
        self.log = log
        self.device = torch.device(device)
        if net_params is None:
            seed = params.random_seed if params.random_seed >= 0 else 0
            net_params = init_params(torch.Generator().manual_seed(seed), model_cfg)
        self.model = DeeperCut(net_params, model_cfg, folded=False, trainable=True).to(
            self.device, memory_format=torch.channels_last)
        self.state = update_rules.init_state(params.config, self.net_params)
        self.signals = SignalHandler(handle_signals, sigint_effect, sighup_effect)
        self._loss_window: deque = deque(maxlen=max(params.average_loss, 1))
        self.eval_fn = eval_fn
        self._prepare = batch_preparer(self.device, target_cfg, target_stats)
        # default: BN statistics frozen like the prototxt's lr_mult-0
        # overrides; explicit lr_mults replace the default wholesale
        decay_mults = None
        if lr_mults is None:
            lr_mults = decay_mults = bn_frozen_mults(self.net_params)
        self._body = GradStep(model_cfg, params.config, lr_mults=lr_mults,
                              decay_mults=decay_mults)

    @property
    def net_params(self):
        return self.model.param_dict()

    @property
    def iter(self) -> int:
        return int(self.state["iter"])

    @property
    def smoothed_loss(self) -> float:
        """Average loss over the last `average_loss` iterations
        (Solver::UpdateSmoothedLoss, solver.cpp:483-495)."""
        if not self._loss_window:
            return float("nan")
        return sum(float(v) for v in self._loss_window) / len(self._loss_window)

    def step(self, iters: int) -> None:
        """Reference Solver::Step (solver.cpp:193-275): iter_size
        accumulation, smoothed-loss display, snapshot on interval/signal."""
        cfg = self.params_cfg
        n_acc = cfg.config.iter_size
        for _ in range(iters):
            if self.signals.stop_requested:
                self.log(f"Optimization stopped by signal at iter {self.iter}.")
                break
            if self.signals.snapshot_requested:
                self.snapshot()
                self.signals.snapshot_requested = False
            if (self.eval_fn is not None and cfg.test_interval
                    and self.iter % cfg.test_interval == 0
                    and (self.iter > 0 or cfg.test_initialization)):
                self.log(f"Iteration {self.iter}, Testing net")
                msg = self.eval_fn(self.net_params, self.iter)
                if msg:
                    self.log(f"    Test net output: {msg}")
            total, metrics = 0.0, {}
            for _ in range(n_acc):
                loss, metrics = self._body.backward(self.net_params,
                                                    self._prepare(self.batch_source()))
                total = total + loss
            it_pre = self.iter
            self._body.update(self.net_params, self.state)
            self._loss_window.append(total / n_acc)
            if cfg.display and it_pre % cfg.display == 0:
                lr = update_rules.learning_rate(cfg.config, it_pre)
                parts = ", ".join(f"{k} = {float(v):.4f}" for k, v in sorted(metrics.items()))
                self.log(f"Iteration {it_pre}, loss = {self.smoothed_loss:.5f} "
                         f"({parts}), lr = {lr:.6g}")
            if cfg.snapshot and self.iter % cfg.snapshot == 0:
                self.snapshot()

    def solve(self) -> None:
        self.log(f"Solving with {self.params_cfg.config.solver_type}, "
                 f"max_iter = {self.params_cfg.max_iter}")
        t0 = time.time()
        self.step(self.params_cfg.max_iter - self.iter)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.log(f"Optimization done in {time.time() - t0:.1f}s.")
        cfg = self.params_cfg
        # final snapshot unless disabled or the interval just wrote one
        # (Solver::Solve + snapshot_after_train, solver.cpp:293-300)
        if (cfg.snapshot_after_train and (cfg.snapshot or cfg.has_snapshot_prefix)
                and (not cfg.snapshot or self.iter % cfg.snapshot != 0)):
            self.snapshot()

    # -- snapshot/restore (reference: solver.cpp:411-481) ------------------
    def snapshot(self, export_caffemodel: bool = True) -> str:
        """Writes the ``.npz`` (params + solver state, for -snapshot resume)
        and, by default, the reference-format ``.caffemodel`` the pose
        estimator loads."""
        if self.params_cfg.snapshot_format.upper() not in ("BINARYPROTO", "HDF5"):
            raise NotImplementedError(
                f"snapshot_format {self.params_cfg.snapshot_format!r}: the port writes "
                ".npz + .caffemodel snapshots only")
        prefix = f"{self.params_cfg.snapshot_prefix}_iter_{self.iter}"
        save_checkpoint(f"{prefix}.npz", self.net_params, self.state)
        self.log(f"Snapshotting to {prefix}.npz")
        if export_caffemodel:
            save_caffemodel(f"{prefix}.caffemodel", self.net_params)
            self.log(f"Snapshotting model weights to {prefix}.caffemodel")
        return f"{prefix}.npz"

    @torch.no_grad()
    def restore(self, path: str) -> None:
        """Resume from a ``.npz`` of either package: params are copied into
        the live tensors, the solver state moves to the device."""
        params, state = load_checkpoint(path)
        live = self.net_params
        if set(params) != set(live):
            raise ValueError(f"{path}: its layers differ from the model's "
                             f"({sorted(set(params) ^ set(live))[:5]} ...)")
        for name, entry in live.items():
            for k, v in entry.items():
                v.copy_(params[name][k])
        new_state: Dict[str, Any] = {"iter": state["iter"]}
        for key, tree in state.items():
            if key != "iter":
                new_state[key] = {name: {k: torch.empty_like(live[name][k], requires_grad=False)
                                         .copy_(v) for k, v in entry.items()}
                                  for name, entry in tree.items()}
        if set(new_state) != set(self.state):
            raise ValueError(f"{path}: solver state {sorted(new_state)} does not fit "
                             f"{self.params_cfg.config.solver_type} ({sorted(self.state)})")
        self.state = new_state
        self.log(f"Restored from {path} at iter {self.iter}")
