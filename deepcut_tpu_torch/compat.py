"""pycaffe-compatible API facade: ``import deepcut_tpu_torch.compat as caffe``.

Counterpart of `deepcut_tpu.compat`'s `Net` (python/caffe/pycaffe.py,
python/caffe/_caffe.cpp): `caffe.Net(prototxt, weights, caffe.TEST)`,
`net.blobs['data'].data[...] = x`, `net.forward()`, `net.params`, ...,
backed by the port's `core.graph.Net` on one device (the card unless
``device="cpu"``).

- `params` shows each layer's blobs in Caffe's layouts, as pycaffe does
  (conv OIHW, deconv (Cin, Cout/g, kh, kw), InnerProduct (N_out, K)); the
  JAX package's facade shows its own HWIO.
- Blob `.data` is a host numpy staging buffer. Writing into an INPUT blob
  stages the next forward's input; writing into a PARAM blob
  (`net.params['conv1'][0].data[...] = w`, in-place ops, `.fill()`) writes
  THROUGH to the net's device parameters at once (the net-surgery
  contract). Outputs appear in `blobs` after `forward()`.
- `set_mode_cpu / set_mode_gpu / set_device` are accepted no-ops: the
  device is the Net's, chosen at construction.
- The net computes in f32 by default (``compute_dtype=None``, TF32 off),
  as the JAX package's facade does.
- `backward` returns the input diffs and fills each blob's `.diff`
  (injected top diffs as kwargs, partial start / end, `diffs=`);
  `forward_backward_all`, `set_input_arrays` and `blob_loss_weights` as
  pycaffe's. `Solver` / `get_solver` and the six typed solver classes run
  `solver.solver.GraphSolver`, with a live `solver.net` and
  `solver.test_nets`.
- `save` writes a ``.caffemodel``, or Caffe's HDF5 weight layout to a
  ``.h5`` / ``.hdf5`` path (h5py needed).
"""

from __future__ import annotations

import warnings
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

TRAIN = "TRAIN"
TEST = "TEST"
PARAM_ORDER = ("w", "b", "mean", "var", "scale_factor", "gamma", "beta", "slopes")


def set_mode_cpu() -> None:  # noqa: D103 - reference-compat no-op
    pass


def set_mode_gpu() -> None:  # noqa: D103
    pass


def set_device(device_id: int = 0) -> None:  # noqa: D103
    pass


def set_random_seed(seed: int) -> None:
    np.random.seed(seed)


def layer_type_list() -> List[str]:
    from deepcut_tpu_torch.core.layers import registered_types

    return registered_types()


class _ParamArray(np.ndarray):
    """Host view of a device parameter with WRITE-THROUGH semantics: a
    mutation through ``[...] =``, `.fill()` or an in-place ufunc, also on a
    derived view (``data[0][:] = w``), pushes the whole root array to the
    net's parameter. Raw-memory writers that bypass ndarray protocols
    (``np.copyto``, ``data.flat[:] = v``) do not push."""

    _on_write = None
    _wt_root = None

    def __array_finalize__(self, obj):
        if obj is not None and self._on_write is None:
            self._on_write = getattr(obj, "_on_write", None)
            self._wt_root = getattr(obj, "_wt_root", None)

    def _push(self):
        # only when this array aliases the tracked root: copies and ufunc
        # results inherit the hook but must not push
        root = self._wt_root
        if self._on_write is not None and (root is None or np.may_share_memory(self, root)):
            self._on_write(self)

    def __setitem__(self, idx, value):
        super().__setitem__(idx, value)
        self._push()

    def fill(self, value):
        super().fill(value)
        self._push()

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        outs = kwargs.get("out")
        conv = tuple(i.view(np.ndarray) if isinstance(i, _ParamArray) else i for i in inputs)
        if outs:
            kwargs["out"] = tuple(o.view(np.ndarray) if isinstance(o, _ParamArray) else o
                                  for o in outs)
        result = getattr(ufunc, method)(*conv, **kwargs)
        if outs and any(o is self for o in outs):
            self._push()
            return self
        return result


class Blob:
    """pycaffe-style blob view: mutable `.data` and `.diff`, `.shape`, `reshape`."""

    def __init__(self, data: np.ndarray):
        arr = np.ascontiguousarray(data)
        self.data = arr if arr.flags.writeable else arr.copy()
        self._diff: Optional[np.ndarray] = None

    @property
    def diff(self) -> np.ndarray:
        """pycaffe's blob.diff: zeros until a backward fills it (the input
        blobs always, other blobs when named in `Net.backward(diffs=...)`);
        writable, to stage the seeds of a partial backward."""
        cur = getattr(self, "_diff", None)  # param views skip __init__
        if cur is None or cur.shape != self.data.shape:
            self._diff = np.zeros_like(self.data)
        elif not cur.flags.writeable:
            self._diff = cur.copy()
        return self._diff

    @property
    def shape(self):
        return self.data.shape

    @property
    def num(self):
        return self.data.shape[0]

    @property
    def channels(self):
        return self.data.shape[1] if self.data.ndim > 1 else 1

    @property
    def height(self):
        return self.data.shape[2] if self.data.ndim > 2 else 1

    @property
    def width(self):
        return self.data.shape[3] if self.data.ndim > 3 else 1

    def reshape(self, *shape):
        self.data = np.zeros(shape, np.float32)

    def count(self):
        return int(self.data.size)


class Net:
    """Drop-in for caffe.Net backed by the port's graph engine.

    ``Net(model_def, [weights], phase, device="cuda", compute_dtype=None)``;
    positional arguments as pycaffe's (a weights path and / or the phase)."""

    def __init__(self, model_def: str, *args, **kwargs):
        from deepcut_tpu_torch.core.graph import Net as GraphNet

        weights = kwargs.pop("weights", None)
        phase = kwargs.pop("phase", TEST)
        for a in args:
            if a in (TRAIN, TEST):
                phase = a
            elif isinstance(a, str):
                weights = a
        self._net = GraphNet(model_def, weights=weights, phase=phase,
                             compute_dtype=kwargs.pop("compute_dtype", None),
                             device=kwargs.pop("device", "cuda"), **kwargs)
        self.blobs: "OrderedDict[str, Blob]" = OrderedDict()
        for nm, sh in self._net.input_shapes.items():
            self.blobs[nm] = Blob(np.zeros(sh, np.float32))

    @classmethod
    def _from_graph(cls, graph_net) -> "Net":
        """A view of an existing `core.graph.Net` (shared, not copied): the
        Solver's `net` and `test_nets` see the live training params."""
        obj = cls.__new__(cls)
        obj._net = graph_net
        obj.blobs = OrderedDict((nm, Blob(np.zeros(sh, np.float32)))
                                for nm, sh in graph_net.input_shapes.items())
        return obj

    # -- pycaffe surface ---------------------------------------------------
    @property
    def params(self) -> "OrderedDict[str, List[Blob]]":
        """layer -> its blobs, as host views that write through to the net."""
        def make_view(name, key, tensor):
            view = tensor.detach().float().cpu().numpy().copy().view(_ParamArray)

            def push(_a, name=name, key=key, like=tensor, root=view):
                self._net.params[name][key] = torch.from_numpy(np.array(root)).to(
                    like.device, like.dtype)
            view._on_write = push
            view._wt_root = view
            blob = Blob.__new__(Blob)
            blob.data = view
            return blob

        out: "OrderedDict[str, List[Blob]]" = OrderedDict()
        for name, entry in self._net.params.items():
            blobs = [make_view(name, k, entry[k]) for k in PARAM_ORDER if k in entry]
            if blobs:
                out[name] = blobs
        return out

    @property
    def inputs(self) -> List[str]:
        return list(self._net.input_names)

    @property
    def outputs(self) -> List[str]:
        return self._net.output_names()

    def forward(self, blobs=None, start=None, end=None, **kwargs) -> Dict[str, np.ndarray]:
        """Full or partial (start / end layer names) forward, as pycaffe's
        _Net_forward (pycaffe.py:62-107): the outputs (or the end layer's
        tops) and any blobs named in `blobs`."""
        for nm, val in kwargs.items():
            self.blobs.setdefault(nm, Blob(np.asarray(val, np.float32)))
            self.blobs[nm].data = np.asarray(val, np.float32)
        if start is not None or end is not None:
            slice_specs = [s for _, s in self._net.plan_slice(start, end)]
            needed = {b for s in slice_specs for b in s.bottoms}
            inputs = {nm: self.blobs[nm].data for nm in needed if nm in self.blobs}
            outs = self._net.forward(start=start, end=end, **inputs)
            wanted = set(slice_specs[-1].tops) if end is not None else set(self.outputs)
        else:
            inputs = self._staged_inputs()
            outs = self._net.forward(**inputs)
            wanted = set(self.outputs)
        for nm, val in outs.items():
            self.blobs[nm] = Blob(val)
        wanted |= set(blobs or [])
        return {nm: self.blobs[nm].data for nm in wanted if nm in self.blobs}

    def forward_all(self, blobs=None, **kwargs) -> Dict[str, np.ndarray]:
        """Batched forward over the leading axis, in chunks of the input
        blob's batch (pycaffe.py:170-201)."""
        num = next(iter(kwargs.values())).shape[0]
        batch = self.blobs[self.inputs[0]].data.shape[0] if self.inputs else 1
        collected: Dict[str, List[np.ndarray]] = {}
        for i in range(0, num, batch):
            outs = self.forward(blobs=blobs, **{k: v[i:i + batch] for k, v in kwargs.items()})
            for nm, val in outs.items():
                collected.setdefault(nm, []).append(np.asarray(val))
        return {nm: np.concatenate(vals) for nm, vals in collected.items()}

    def _staged_inputs(self) -> Dict[str, np.ndarray]:
        """The input blobs' data, and the fill-once blobs' (constant
        DummyData tops), which persist across forwards as the reference's
        blob memory does."""
        names = list(self._net.input_names) + sorted(self._net.sticky_top_names())
        return {nm: self.blobs[nm].data for nm in names if nm in self.blobs}

    def backward(self, diffs=None, start=None, end=None, **kwargs) -> Dict[str, np.ndarray]:
        """pycaffe's _Net_backward (pycaffe.py:107-140): the diffs of the
        input blobs, and of the blobs named in `diffs`, written into each
        blob's `.diff` and returned. The input data are the staged blobs
        (a forward's, or ``blobs[...].data[...] = x``).

        kwargs are injected top diffs: their keys must be the net's outputs,
        and the gradients are then of sum <output, diff> instead of the
        loss. start / end: a partial backward by layer name, from layer
        `start` (seeded from the staged ``blobs[top].diff`` of its tops) down
        through `end`, whose tops' diffs are returned too."""
        inputs = self._staged_inputs()
        cot = None
        if kwargs:
            if set(kwargs) != set(self.outputs):
                raise Exception("Top diff arguments do not match net outputs.")
            if start is None:
                cot = {nm: np.asarray(v, np.float32) for nm, v in kwargs.items()}
        specs = {s.name: s for s in self._net.layer_specs}
        if start is not None:
            if start not in specs:
                raise KeyError(f"unknown start layer {start!r}")
            cot = {}
            for top in specs[start].tops:
                blob = self.blobs.get(top)
                if blob is None or blob._diff is None:
                    raise ValueError(f"backward(start={start!r}): no staged diff for top blob "
                                     f"{top!r}; set net.blobs[{top!r}].diff[...] first (the "
                                     "reference reads that buffer)")
                cot[top] = np.asarray(blob.diff, np.float32)
        if end is not None:
            if end not in specs:
                raise KeyError(f"unknown end layer {end!r}")
            diffs = list(diffs or []) + [t for t in specs[end].tops if t not in (diffs or [])]
        grads = self._net.backward(diffs=diffs, cotangents=cot, start=start, end=end, **inputs)
        for nm, g in grads.items():
            if nm in self.blobs:
                if g.shape != tuple(self.blobs[nm].data.shape):
                    # a Filter net: the forward truly shrinks the batch, the
                    # backward keeps the static shapes
                    warnings.warn(f"backward: gradient for blob '{nm}' has shape {g.shape} but "
                                  f"the blob holds {tuple(self.blobs[nm].data.shape)} "
                                  "(dynamic-Filter forward vs static backward); Blob.diff stays "
                                  "zeros for this blob", stacklevel=2)
                    continue
                self.blobs[nm]._diff = g
        return grads

    def forward_backward_all(self, blobs=None, diffs=None, **kwargs):
        """pycaffe's _Net_forward_backward_all (pycaffe.py:170-233): the
        batched forward and backward, in chunks of the input blob's batch;
        -> ({blob: outputs}, {blob: diffs of the inputs and of `diffs`})."""
        batch = self.blobs[self.inputs[0]].data.shape[0] if self.inputs else 1
        fwd_out = self.forward_all(blobs=blobs, **kwargs)
        num = next(iter(kwargs.values())).shape[0]
        grads: Dict[str, List[np.ndarray]] = {}
        for i in range(0, num, batch):
            chunk = {k: np.asarray(v[i:i + batch], np.float32) for k, v in kwargs.items()}
            for nm, val in self._net.backward(diffs=diffs, **chunk).items():
                grads.setdefault(nm, []).append(val)
        return fwd_out, {nm: np.concatenate(vals) for nm, vals in grads.items()}

    def set_input_arrays(self, data: np.ndarray, labels: np.ndarray) -> None:
        """Feed the MemoryData layer (pycaffe's _Net_set_input_arrays)."""
        self._net.set_input_arrays(data, labels)

    @property
    def blob_loss_weights(self) -> "OrderedDict[str, float]":
        """pycaffe's net.blob_loss_weights: each blob's loss weight (0 for
        the inputs)."""
        out: "OrderedDict[str, float]" = OrderedDict((nm, 0.0) for nm in self._net.input_names)
        out.update(self._net.blob_loss_weights())
        return out

    def copy_from(self, weights_path: str) -> None:
        self._net.load_weights(weights_path)

    def save(self, path: str) -> None:
        """Write the weights in Caffe's blob layouts, by extension as
        Net::Snapshot: ``.h5`` / ``.hdf5`` in Caffe's HDF5 layout
        (net.cpp:948-980, h5py needed), else a binary NetParameter."""
        from deepcut_tpu_torch.models.convert import graph_params_to_numpy
        from deepcut_tpu_torch.proto.caffemodel import save_caffemodel, save_hdf5_weights

        host = graph_params_to_numpy(self._net.params, self._net.layer_types())
        if path.endswith((".h5", ".hdf5")):
            save_hdf5_weights(path, host, deconv_names=self._net.deconv_names())
        else:
            save_caffemodel(path, host, net_name=self._net.name,
                            deconv_names=self._net.deconv_names())

    def reshape(self) -> None:  # shapes follow each forward's inputs
        pass

    @property
    def layer_dict(self):
        return OrderedDict((s.name, s) for _, s in self._net._plan)

    @property
    def _layer_names(self) -> List[str]:
        return [s.name for _, s in self._net._plan]

    @property
    def layers(self):
        """pycaffe's net.layers: per-layer views with .type and .blobs."""

        class _LayerView:
            __slots__ = ("type", "blobs")

            def __init__(self, typ, blobs):
                self.type = typ
                self.blobs = blobs

        params = self.params
        return [_LayerView(s.type, params.get(s.name, [])) for _, s in self._net._plan]

    @property
    def top_names(self) -> "OrderedDict[str, List[str]]":
        return OrderedDict((s.name, list(s.tops)) for _, s in self._net._plan)

    @property
    def bottom_names(self) -> "OrderedDict[str, List[str]]":
        return OrderedDict((s.name, list(s.bottoms)) for _, s in self._net._plan)

    def share_with(self, other: "Net") -> None:
        """Share parameters with another net by layer name
        (Net::ShareTrainedLayersWith, net.cpp:782-803): matching layers hold
        the same tensors afterwards."""
        self._net.materialize_params()
        other._net.materialize_params()
        src = other._net.params
        for name in list(self._net.params):
            if name in src:
                self._net.params[name] = src[name]


class Solver:
    """pycaffe's Solver (`caffe.get_solver`, `caffe.SGDSolver`, ...): `.net`
    (a live view of the training net), `.test_nets`, `.step(n)`,
    `.solve()`, `.iter`, `.smoothed_loss`, `.snapshot()`, `.restore(path)`,
    backed by `solver.solver.GraphSolver` on `device` (the card unless
    ``device="cpu"``). A solver whose net has a PoseData layer trains
    through `solver.solver.PoseSolver` or the CLI instead."""

    def __init__(self, path: str, solver_type: Optional[str] = None, *, device="cuda"):
        import dataclasses

        from deepcut_tpu_torch.solver.solver import GraphSolver, SolverParams

        sp = SolverParams.from_prototxt(path)
        if solver_type is not None:
            sp.config = dataclasses.replace(sp.config, solver_type=solver_type)
        self._solver = GraphSolver(sp, handle_signals=False, device=device)
        self.net = Net._from_graph(self._solver.net)
        self._test_net_views: Optional[List[Net]] = None

    @property
    def test_nets(self) -> List[Net]:
        """Stable views of the test nets, re-pointed at the live training
        params on each access (Solver::Test's ShareTrainedLayersWith)."""
        nets = self._solver._init_test_nets()
        for tnet, _ in nets:
            self._solver._share_trained_layers(tnet)
        if self._test_net_views is None:
            self._test_net_views = [Net._from_graph(t) for t, _ in nets]
        return self._test_net_views

    @property
    def smoothed_loss(self) -> float:
        return self._solver.smoothed_loss

    @property
    def iter(self) -> int:
        return self._solver.iter

    def step(self, iters: int) -> None:
        self._solver.step(iters)

    def solve(self) -> None:
        self._solver.solve()

    def snapshot(self) -> str:
        return self._solver.snapshot()

    def restore(self, state_path: str) -> None:
        self._solver.restore(state_path)


def get_solver(path: str, *, device="cuda") -> Solver:
    """pycaffe's caffe.get_solver: the solver the prototxt's `type:` names."""
    return Solver(path, device=device)


def _typed(name: str):
    def __init__(self, path: str, *, device="cuda"):
        Solver.__init__(self, path, solver_type=name, device=device)
    return type(f"{name}Solver", (Solver,), {"__init__": __init__,
                                            "__doc__": f"pycaffe's {name}Solver."})


SGDSolver = _typed("SGD")
NesterovSolver = _typed("Nesterov")
AdaGradSolver = _typed("AdaGrad")
RMSPropSolver = _typed("RMSProp")
AdaDeltaSolver = _typed("AdaDelta")
AdamSolver = _typed("Adam")
