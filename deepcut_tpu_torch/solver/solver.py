"""The training loops (the reference Solver, src/caffe/solver.cpp), in
PyTorch.

Counterpart of `deepcut_tpu.solver.solver`. `SolverParams`
parses the same solver.prototxt files. `PoseSolver` runs DeeperCut:
prefetched batches through the native forward, the fork's losses and their
hand-written backward passes, with iter_size accumulation on the host, the
smoothed-loss display line, the `test_interval` eval hook, SIGINT -> stop /
SIGHUP -> snapshot, snapshots and restore. `GraphSolver` runs any prototxt
net through the graph engine (`core.graph.Net.make_train_step`), with its
test nets sharing the trained layers, fed by their data layers or staged
inputs, and the same loop controls.

Both take a ``mesh=`` (`parallel.mesh.make_mesh`, one process per GPU):
each rank pulls the GLOBAL batch from its own source (the same seed and
cursor on every rank) and keeps its rows, the gradients are summed over
the ranks before the update, the losses, the display and the test scores
are the global batch's, the coordinator (rank 0) alone logs, runs
PoseSolver's eval hook and writes snapshots, and every rank restores them.
With a 'spatial' axis each rank also keeps a block of the image rows:
PoseSolver through the row-sharded forward (`parallel.spatial`; its
gradients still accumulate on the host over iter_size and are reduced
once before the separate update), GraphSolver through
`core.graph.Net.make_train_step`'s plan split (`parallel.graph_spatial`).

Snapshots are the JAX package's: a ``.npz`` with ``params/<layer>/<key>``
and ``state/...`` entries in its layouts (HWIO conv weights), so either
package restores the other's, and a reference-readable ``.caffemodel``
(GraphSolver: or ``.caffemodel.h5``) with its ``.solverstate``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import signal as _signal
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from deepcut_tpu_torch.proto import text_format
from deepcut_tpu_torch.proto.text_format import PbNode
from deepcut_tpu_torch.models.convert import (
    graph_params_from_numpy, graph_params_to_numpy, params_from_numpy, params_to_numpy,
    save_caffemodel)
from deepcut_tpu_torch.models.resnet import DeeperCut, init_params
from deepcut_tpu_torch.models.train import bn_frozen_mults
from deepcut_tpu_torch.parallel.mesh import replicated, tree_leaves
from deepcut_tpu_torch.parallel.train_step import GradStep, batch_preparer
from deepcut_tpu_torch.solver import update_rules
from deepcut_tpu_torch.solver.update_rules import SolverConfig


@dataclasses.dataclass
class SolverParams:
    """Loop-level knobs from SolverParameter + the update-rule SolverConfig
    (the fields of `deepcut_tpu.solver.solver.SolverParams`)."""

    config: SolverConfig
    max_iter: int = 100000
    display: int = 20
    average_loss: int = 1
    snapshot: int = 0
    snapshot_prefix: str = "snapshot"
    snapshot_format: str = "BINARYPROTO"
    test_interval: int = 0
    test_iter: int = 0  # the first test_iter (single-test-net convenience)
    random_seed: int = -1
    train_net: str = ""
    test_net: str = ""  # the first test_net file (single-test-net convenience)
    net: str = ""
    # the full train / test net specification (caffe.proto:104-133): per-net
    # test_iter, test net files, inline NetParameters, NetState overrides
    test_iters: tuple = ()
    test_net_files: tuple = ()
    test_net_params: tuple = ()
    net_param: Optional[PbNode] = None
    train_net_param: Optional[PbNode] = None
    train_state: Optional[PbNode] = None
    test_states: tuple = ()
    test_initialization: bool = True
    test_compute_loss: bool = False
    snapshot_after_train: bool = True
    snapshot_diff: bool = False
    debug_info: bool = False
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
            test_iter=int(node.get_list("test_iter")[0]) if node.get_list("test_iter") else 0,
            random_seed=node.get_int("random_seed", -1),
            train_net=node.get_str("train_net", ""),
            test_net=str(node.get_list("test_net")[0]) if node.get_list("test_net") else "",
            net=node.get_str("net", ""),
            test_iters=tuple(int(v) for v in node.get_list("test_iter")),
            test_net_files=tuple(str(v) for v in node.get_list("test_net")),
            test_net_params=tuple(node.get_list("test_net_param")),
            net_param=node.get("net_param"),
            train_net_param=node.get("train_net_param"),
            train_state=node.get("train_state"),
            test_states=tuple(node.get_list("test_state")),
            test_initialization=node.get_bool("test_initialization", True),
            test_compute_loss=node.get_bool("test_compute_loss", False),
            snapshot_after_train=node.get_bool("snapshot_after_train", True),
            snapshot_diff=node.get_bool("snapshot_diff", False),
            debug_info=node.get_bool("debug_info", False),
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
        return (model_def,) + _state_overrides(self.train_state)

    def test_net_sources(self):
        """The test-net instances in order, as (model_def, test_iter, stages,
        level) (Solver::InitTestNets, solver.cpp:104-191): inline
        test_net_param first, then test_net files, then instances of the
        generic net / net_param for the remaining test_iter entries;
        test_state is unspecified or given once per instance."""
        has_generic = bool(self.net) or self.net_param is not None
        num_named = len(self.test_net_params) + len(self.test_net_files)
        iters = list(self.test_iters)
        if (len(iters) < num_named) if has_generic else (len(iters) != num_named):
            raise ValueError("test_iter must be specified for each test network")
        num_instances = num_named + (len(iters) - num_named if has_generic else 0)
        if self.test_states and len(self.test_states) != num_instances:
            raise ValueError("test_state must be unspecified or specified once per test net")
        if num_instances and self.test_interval <= 0:
            raise ValueError("test_interval must be > 0 with test nets")
        defs: List[Any] = list(self.test_net_params) + list(self.test_net_files)
        defs += [self.net_param if self.net_param is not None else self.net] * (
            num_instances - num_named)
        return [(d, iters[i]) + _state_overrides(self.test_states[i] if self.test_states else None)
                for i, d in enumerate(defs)]


def _state_overrides(state_node: Optional[PbNode]):
    """(stages, level) of a NetState node, merged by Net over the net's own
    state; level None when unset (an explicit 0 overrides the net's)."""
    if state_node is None:
        return (), None
    return (tuple(str(s) for s in state_node.get_list("stage")),
            state_node.get_int("level", 0) if state_node.has("level") else None)


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


def _layouts(layer_types):
    """(to numpy, from numpy) between the port's layouts and the JAX
    package's: the native DeeperCut's by layer name, or a graph net's by
    layer type."""
    if layer_types is None:
        return params_to_numpy, params_from_numpy
    return (lambda t: graph_params_to_numpy(t, layer_types),
            lambda t: graph_params_from_numpy(t, layer_types))


def save_checkpoint(path: str, params, state: Dict[str, Any], *, layer_types=None) -> None:
    """params/state (the port's layouts, any device) -> the JAX package's
    ``.npz``: params and every state tree in its layouts, ``iter`` int32.
    layer_types: a graph net's `Net.layer_types()` (None: DeeperCut's)."""
    to_numpy, _ = _layouts(layer_types)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    flat = _flatten(to_numpy(params), "params")
    for k, v in state.items():
        if k == "iter":
            flat["state/iter"] = np.asarray(int(v), np.int32)
        else:
            flat.update(_flatten(to_numpy(v), f"state/{_esc(k)}"))
    np.savez(path, **flat)


def load_checkpoint(path: str, *, layer_types=None):
    """A ``.npz`` written by either package -> (params, state) in the port's
    layouts, f32 on the CPU, ``state["iter"]`` an int."""
    _, from_numpy = _layouts(layer_types)
    with np.load(path, allow_pickle=False) as data:
        tree = _unflatten({k: data[k] for k in data.files})
    state: Dict[str, Any] = {}
    for k, v in tree.get("state", {}).items():
        state[k] = int(v) if k == "iter" else from_numpy(v)
    return from_numpy(tree.get("params", {})), state


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


def _solver_device(device, mesh):
    """A solver's device: the one given, else the mesh's, else the card; a
    device that is not the mesh's raises."""
    if mesh is None:
        return device or "cuda"
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's ({mesh.device})")
    return mesh.device


def _coordinator_log(log: Callable[[str], None], mesh) -> Callable[[str], None]:
    """`log` on the coordinator (every rank computes the same global
    numbers), silent on the other ranks."""
    if mesh is None or mesh.is_coordinator():
        return log
    return lambda *_: None


@contextlib.contextmanager
def _coordinator_writes(mesh):
    """Yields whether this rank writes a snapshot (the coordinator, or any
    process outside a mesh); the ranks meet after it, so that a restore
    anywhere finds the files."""
    yield mesh is None or mesh.is_coordinator()
    if mesh is not None:
        mesh.barrier()


class GraphSolver:
    """The `caffe train` loop for any prototxt net, through the graph engine
    (Solver::Step / Solve / Test, solver.cpp), on one device ("cuda" by
    default) or data-parallel over a mesh.

    The train net is resolved from the solver (net, net_param, train_net or
    train_net_param, with train_state's stages and level), or given as a
    `core.graph.Net` or a model definition; it computes in f32
    (``compute_dtype=None``), with TF32 off in the step. Its inputs come
    from its data layers (Data, ImageData, HDF5Data, WindowData, PoseData,
    MemoryData, DummyData) and from `extra_inputs` ({name: NCHW array},
    staged over them on every step, as pycaffe's persistent blobs); test
    nets (Solver::InitTestNets) share the trained layers, pull from their
    own data layers and take `extra_test_inputs`.

    mesh: training of any prototxt net over a mesh (the reference CLI's
    ``-gpu 0,1,...``): the data layers' batch is the GLOBAL batch, each
    rank trains on its rows, and with a spatial axis on its block of the
    image rows up to the plan's gather boundary
    (`core.graph.Net.make_train_step`); the test nets run the whole test
    batch on every rank. device defaults to the mesh's, else the card."""

    _STATE_KEYS = ("history", "update_sq", "m", "v")

    def __init__(self, params: SolverParams, net=None, *, mesh=None, handle_signals: bool = True,
                 log: Callable[[str], None] = print, sigint_effect: str = "stop",
                 sighup_effect: str = "snapshot", device=None):
        from deepcut_tpu_torch.core.graph import Net

        device = _solver_device(device, mesh)
        self.params_cfg = params
        self.mesh = mesh
        self.device = device
        if net is None:
            model_def, stages, level = params.resolve_train_net()
            net = Net(model_def, phase="TRAIN", stages=stages, level=level, compute_dtype=None,
                      seed=max(params.random_seed, 0), device=device)
        elif not isinstance(net, Net):
            net = Net(net, phase="TRAIN", compute_dtype=None, seed=max(params.random_seed, 0),
                      device=device)
        self.net = net
        self.log = _coordinator_log(log, mesh)
        self.signals = SignalHandler(handle_signals, sigint_effect, sighup_effect)
        self._loss_window: deque = deque(maxlen=max(params.average_loss, 1))
        self.net.materialize_params()
        if mesh is not None:
            replicated(mesh, tree_leaves(self.net.params))
        self._step_fn = self.net.make_train_step(params.config, mesh=mesh, log=self.log)
        self.state = update_rules.init_state(params.config, self.net.params)
        self._test_nets: Optional[List] = None
        self._last_host_inputs: Dict[str, Any] = {}
        # the last update (old params - new params): what the reference's
        # Blob.diff holds at snapshot time (sgd_solver.cpp:106-120)
        self._last_diff: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self.extra_inputs: Dict[str, Any] = {}
        self.extra_test_inputs: Dict[str, Any] = {}

    @property
    def iter(self) -> int:
        return int(self.state["iter"])

    @property
    def smoothed_loss(self) -> float:
        """Average loss over the last `average_loss` iterations
        (Solver::UpdateSmoothedLoss, solver.cpp:483-495)."""
        if not self._loss_window:
            return float("nan")
        return sum(self._loss_window) / len(self._loss_window)

    # -- test nets ---------------------------------------------------------
    def _init_test_nets(self):
        """Every test-net instance (Solver::InitTestNets): a TEST-phase Net
        with its test_state merged over the net's own state."""
        if self._test_nets is not None:
            return self._test_nets
        from deepcut_tpu_torch.core.graph import Net

        p = self.params_cfg
        kw = dict(phase="TEST", compute_dtype=None, device=self.device)
        if not (p.test_net_files or p.test_net_params or p.test_iters):
            source = p.test_net or p.net   # a programmatic SolverParams
            self._test_nets = [(Net(source, **kw), p.test_iter)] if source and p.test_iter > 0 else []
            return self._test_nets
        self._test_nets = [(Net(d, stages=stages, level=level, **kw), iters)
                           for d, iters, stages, level in p.test_net_sources()]
        return self._test_nets

    def _share_trained_layers(self, tnet) -> None:
        """Point a test net at the live train params and their alias table
        (Net::ShareTrainedLayersWith, which Test calls on each pass)."""
        tnet.params = self.net.params
        tnet._aliases = self.net._aliases
        tnet._param_keys = self.net._param_keys
        tnet._params_ready = True

    def test(self, test_net_id: int = 0) -> Dict[str, float]:
        """Run test net `test_net_id` for its test_iter forwards, averaging
        each output element over them, logged as Solver::Test does
        (solver.cpp:335-409), with the averaged loss under
        `test_compute_loss`. Returns each output's mean."""
        nets = self._init_test_nets()
        if not nets:
            return {}
        tnet, iters = nets[test_net_id]
        self._share_trained_layers(tnet)
        loss_weights = tnet.blob_loss_weights()
        sums: Dict[str, np.ndarray] = {}
        loss = 0.0
        for _ in range(iters):
            outs = tnet.forward(**self.extra_test_inputs)
            if self.params_cfg.test_compute_loss:
                loss += tnet.host_total_loss(outs)
            for nm in tnet.output_names():
                sums[nm] = sums.get(nm, 0.0) + np.asarray(outs[nm], np.float64)
        if self.params_cfg.test_compute_loss:
            self.log(f"Test loss: {loss / iters:.6g}")
        avgs: Dict[str, float] = {}
        idx = 0
        for nm, total in sums.items():
            mean = total / iters
            w = loss_weights.get(nm, 0.0)
            for v in np.ravel(mean):
                suffix = f" (* {w:g} = {w * v:.6g} loss)" if w else ""
                self.log(f"    Test net output #{idx}: {nm} = {v:.6g}{suffix}")
                idx += 1
            avgs[nm] = float(np.mean(mean))
        return avgs

    def test_all(self) -> List[Dict[str, float]]:
        """Every test net in order (Solver::TestAll)."""
        results = []
        for i in range(len(self._init_test_nets())):
            self.log(f"Iteration {self.iter}, Testing net (#{i})")
            results.append(self.test(i))
        return results

    # -- the loop ----------------------------------------------------------
    def _next_inputs(self) -> Dict[str, torch.Tensor]:
        """The step's inputs on the device: extra_inputs over the data
        layers' next batch; with iter_size k, k batches stacked on a new
        leading axis."""
        def pull_one(stash: bool):
            inputs: Dict[str, Any] = dict(self.extra_inputs)
            self.net._pull_data_layers(inputs)
            if stash:   # the host batch, for the debug_info forward of this iteration
                self._last_host_inputs = {k: np.asarray(v) for k, v in inputs.items()}
            inputs = {nm: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
                      for nm, v in inputs.items()}
            if self.mesh is not None:   # the step keeps this rank's rows before the transfer
                return inputs
            return {nm: v.to(self.net.device) for nm, v in inputs.items()}

        k = max(self.params_cfg.config.iter_size, 1)
        stash = bool(self.params_cfg.debug_info)
        if k == 1:
            return pull_one(stash)
        batches = [pull_one(stash and i == 0) for i in range(k)]
        return {nm: torch.stack([b[nm] for b in batches]) for nm in batches[0]}

    def step(self, iters: int) -> None:
        """Solver::Step (solver.cpp:193-275): the test pass on test_interval
        boundaries (iteration 0 with test_initialization), the step, the
        smoothed-loss display on the pre-update iteration, snapshots on the
        interval and on a signal."""
        cfg = self.params_cfg
        params = self.net.params
        for _ in range(iters):
            if self.signals.stop_requested:
                self.log(f"Optimization stopped by signal at iter {self.iter}.")
                break
            if self.signals.snapshot_requested:
                self.snapshot()
                self.signals.snapshot_requested = False
            if (cfg.test_interval and self.iter % cfg.test_interval == 0
                    and (self.iter > 0 or cfg.test_initialization)):
                self.test_all()
            it_pre = self.iter
            display_now = cfg.display and it_pre % cfg.display == 0
            inputs = self._next_inputs()
            if display_now and cfg.debug_info:
                # the per-blob / per-param mean |value| stream (Net::*DebugInfo,
                # net.cpp:647-735), on this iteration's own batch
                for nm, v in self.net.debug_info(**self._last_host_inputs).items():
                    self.log(f"    [Backward] Param {nm[6:]}, data: {v:.6g}" if nm.startswith(
                        "param:") else f"    [Forward] Blob {nm}, data: {v:.6g}")
            before = ({n: {k: v.detach().clone() for k, v in e.items()} for n, e in params.items()}
                      if cfg.snapshot_diff else None)
            _, self.state, loss = self._step_fn(params, self.state, inputs)
            if before is not None:
                self._last_diff = {n: {k: before[n][k] - v.detach() for k, v in e.items()}
                                   for n, e in params.items()}
            self._loss_window.append(float(loss))
            if display_now:
                lr = update_rules.learning_rate(cfg.config, it_pre)
                self.log(f"Iteration {it_pre}, loss = {self.smoothed_loss:.5f}, lr = {lr:.6g}")
            if cfg.snapshot and self.iter % cfg.snapshot == 0:
                self.snapshot()

    def solve(self) -> None:
        """Solver::Solve (solver.cpp:277-324): to max_iter, the final
        snapshot (unless snapshot_after_train is false or the interval just
        wrote one; it also needs a snapshot interval or prefix), then a
        display forward and a test pass where the last iteration lands on
        their intervals. The data layers' prefetch threads stop at the end."""
        try:
            self._solve()
        finally:
            self.close()

    def _solve(self) -> None:
        cfg = self.params_cfg
        self.step(cfg.max_iter - self.iter)
        if (cfg.snapshot_after_train and (cfg.snapshot or cfg.has_snapshot_prefix)
                and (not cfg.snapshot or self.iter % cfg.snapshot != 0)):
            self.snapshot()
        if self.signals.stop_requested:
            self.log("Optimization stopped early.")
            return
        if cfg.display and self.iter % cfg.display == 0 and self.net.data_sources:
            outs = self.net.forward(**self.extra_inputs)
            self._loss_window.append(self.net.host_total_loss(outs))
            self.log(f"Iteration {self.iter}, loss = {self.smoothed_loss:.5f}")
        if cfg.test_interval and self.iter % cfg.test_interval == 0:
            self.test_all()
        self.log("Optimization Done.")

    def close(self) -> None:
        """Stop the data layers' prefetch threads of the train and test nets."""
        self.net.close()
        for tnet, _ in self._test_nets or ():
            tnet.close()

    # -- snapshot / restore (solver.cpp:411-481) ---------------------------
    def _state_leaves(self):
        """The solver state's per-blob leaves as the ``.solverstate``
        carries them, ``(state key, layer, blob key, array)``: state entry
        after state entry (`_STATE_KEYS`), each in the JAX package's layouts
        with layer names and keys sorted (the order jax.tree_util flattens
        its dicts in)."""
        types = self.net.layer_types()
        for key in self._STATE_KEYS:
            if key in self.state:
                tree = graph_params_to_numpy(self.state[key], types)
                for n in sorted(tree):
                    for k in sorted(tree[n]):
                        yield key, n, k, tree[n][k]

    def snapshot(self, export_caffemodel: bool = True) -> str:
        """Writes the ``.npz`` (params and solver state in the JAX package's
        keys and layouts, for restore) and, by default, the reference's
        model and state pair (solver.cpp:411-469): the weights as a
        ``.caffemodel`` (``.caffemodel.h5`` under ``snapshot_format:
        HDF5``, h5py needed), with each blob's last update as its diff under
        `snapshot_diff`, and a ``.solverstate`` whose learned_net names
        that file."""
        fmt = self.params_cfg.snapshot_format.upper()
        if fmt not in ("BINARYPROTO", "HDF5"):
            raise NotImplementedError(
                f"snapshot_format {fmt}: the port writes BINARYPROTO or HDF5 snapshots")
        prefix = f"{self.params_cfg.snapshot_prefix}_iter_{self.iter}"
        with _coordinator_writes(self.mesh) as write:
            if write:
                self._write_snapshot(prefix, fmt, export_caffemodel)
        return f"{prefix}.npz"

    def _write_snapshot(self, prefix: str, fmt: str, export_caffemodel: bool) -> None:
        from deepcut_tpu_torch.proto.caffemodel import (
            encode_solverstate, save_caffemodel as save_netparameter, save_hdf5_weights)

        types = self.net.layer_types()
        save_checkpoint(f"{prefix}.npz", self.net.params, self.state, layer_types=types)
        self.log(f"Snapshotting to {prefix}.npz")
        if export_caffemodel:
            host = graph_params_to_numpy(self.net.params, types)
            diffs = (graph_params_to_numpy(self._last_diff, types)
                     if self.params_cfg.snapshot_diff and self._last_diff is not None else None)
            if fmt == "HDF5":
                model_path = f"{prefix}.caffemodel.h5"
                save_hdf5_weights(model_path, host, deconv_names=self.net.deconv_names(),
                                  diffs=diffs)
            else:
                model_path = f"{prefix}.caffemodel"
                save_netparameter(model_path, host, net_name=self.net.name,
                                  deconv_names=self.net.deconv_names(), diffs=diffs)
            self.log(f"Snapshotting model weights to {model_path}")
            with open(f"{prefix}.solverstate", "wb") as f:
                f.write(encode_solverstate(self.iter, [a for *_, a in self._state_leaves()],
                                           learned_net=model_path))
            self.log(f"Snapshotting solver state to {prefix}.solverstate")

    @torch.no_grad()
    def restore(self, path: str) -> None:
        """Resume, by extension as Solver::Restore (solver.cpp:471-481): a
        ``.solverstate`` of either package (its history blobs, its
        iteration, and the weights of the learned_net it names), or a
        ``.npz`` of either package. The params are copied into the live
        tensors (the test nets share them), the solver state moves to the
        device."""
        if path.endswith(".solverstate"):
            self._restore_solverstate(path)
            return
        params, state = load_checkpoint(path, layer_types=self.net.layer_types())
        live = self.net.params
        want = {(n, k) for n, e in live.items() for k in e}
        got = {(n, k) for n, e in params.items() for k in e}
        if want != got:
            raise ValueError(f"{path}: its blobs differ from the net's "
                             f"({sorted(want ^ got)[:5]} ...)")
        for name, entry in params.items():
            for k, v in entry.items():
                live[name][k].copy_(v)
        new_state: Dict[str, Any] = {"iter": state["iter"]}
        for key, tree in state.items():
            if key != "iter":
                new_state[key] = {n: {k: v.to(live[n][k].device) for k, v in e.items()}
                                  for n, e in tree.items()}
                for n, e in live.items():   # layers whose blobs are all aliases
                    new_state[key].setdefault(n, {})
        if set(new_state) != set(self.state):
            raise ValueError(f"{path}: solver state {sorted(new_state)} does not fit "
                             f"{self.params_cfg.config.solver_type} ({sorted(self.state)})")
        self.state = new_state
        self.log(f"Restored from {path} at iter {self.iter}")

    def _restore_solverstate(self, path: str) -> None:
        from deepcut_tpu_torch.proto.caffemodel import decode_solverstate

        with open(path, "rb") as f:
            it, learned, blobs, _ = decode_solverstate(f.read())
        leaves = list(self._state_leaves())
        if len(blobs) != len(leaves):
            raise ValueError(f"{path}: {len(blobs)} history blobs, the solver state holds "
                             f"{len(leaves)}")
        filled: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
        for (key, n, k, like), blob in zip(leaves, blobs):
            filled.setdefault(key, {}).setdefault(n, {})[k] = blob.data.reshape(like.shape)
        types = self.net.layer_types()
        for key, tree in filled.items():
            for n, e in graph_params_from_numpy(tree, types).items():
                for k, v in e.items():
                    self.state[key][n][k].copy_(v)
        self.state["iter"] = int(it)
        if learned and os.path.exists(learned):
            self.net.load_weights(learned)
        self.log(f"Restored from {path} at iter {self.iter}")


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
    gate); a returned string is logged.

    mesh: training over a mesh; batch_source yields the GLOBAL batch on
    every rank (the same sequence), each rank trains on its rows (with a
    spatial axis: on its block of the image rows, the canvas held to
    `parallel.spatial.check_spatial_shapes`), the eval hook runs on the
    coordinator. device defaults to the mesh's, else the card."""

    def __init__(self, params: SolverParams, model_cfg, batch_source: Callable[[], Dict[str, Any]],
                 *, net_params=None, mesh=None, lr_mults=None, handle_signals: bool = True,
                 log: Callable[[str], None] = print, target_cfg=None, target_stats=None,
                 eval_fn: Optional[Callable[[Any, int], Optional[str]]] = None,
                 sigint_effect: str = "stop", sighup_effect: str = "snapshot",
                 device=None):
        self.params_cfg = params
        self.model_cfg = model_cfg
        self.batch_source = batch_source
        self.mesh = mesh
        self.log = _coordinator_log(log, mesh)
        self.device = torch.device(_solver_device(device, mesh))
        if net_params is None:
            seed = params.random_seed if params.random_seed >= 0 else 0
            net_params = init_params(torch.Generator().manual_seed(seed), model_cfg)
        self.model = DeeperCut(net_params, model_cfg, folded=False, trainable=True).to(
            self.device, memory_format=torch.channels_last)
        if mesh is not None:
            replicated(mesh, tree_leaves(self.net_params))
        self.state = update_rules.init_state(params.config, self.net_params)
        self.signals = SignalHandler(handle_signals, sigint_effect, sighup_effect)
        self._loss_window: deque = deque(maxlen=max(params.average_loss, 1))
        self.eval_fn = eval_fn
        self._prepare = batch_preparer(self.device, target_cfg, target_stats, mesh=mesh)
        # default: BN statistics frozen like the prototxt's lr_mult-0
        # overrides; explicit lr_mults replace the default wholesale
        decay_mults = None
        if lr_mults is None:
            lr_mults = decay_mults = bn_frozen_mults(self.net_params)
        self._body = GradStep(model_cfg, params.config, lr_mults=lr_mults,
                              decay_mults=decay_mults, mesh=mesh)

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
                    and (self.iter > 0 or cfg.test_initialization)
                    and (self.mesh is None or self.mesh.is_coordinator())):
                self.log(f"Iteration {self.iter}, Testing net")
                msg = self.eval_fn(self.net_params, self.iter)
                if msg:
                    self.log(f"    Test net output: {msg}")
            total, metrics = 0.0, {}
            for _ in range(n_acc):
                batch = self.batch_source()
                loss, metrics = self._body.backward(self.net_params, self._prepare(batch))
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
        with _coordinator_writes(self.mesh) as write:
            if write:
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
