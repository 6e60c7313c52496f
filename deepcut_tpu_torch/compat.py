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
- `backward`, `forward_backward_all`, `set_input_arrays` and the `Solver`
  family belong to the engine's training slice of the port, and `save` to
  ``.h5`` to its data slice: they raise `NotImplementedError`.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from deepcut_tpu_torch.core.graph import TRAINING_SLICE

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
    """pycaffe-style blob view: mutable `.data`, `.shape`, `reshape`."""

    def __init__(self, data: np.ndarray):
        arr = np.ascontiguousarray(data)
        self.data = arr if arr.flags.writeable else arr.copy()

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
            inputs = {nm: self.blobs[nm].data for nm in self._net.input_names if nm in self.blobs}
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

    def copy_from(self, weights_path: str) -> None:
        self._net.load_weights(weights_path)

    def save(self, path: str) -> None:
        """Write the weights as a binary NetParameter (``.caffemodel``), in
        Caffe's blob layouts."""
        from deepcut_tpu_torch.models.convert import graph_params_to_numpy
        from deepcut_tpu_torch.proto.caffemodel import save_caffemodel

        if path.endswith((".h5", ".hdf5")):
            raise NotImplementedError("Net.save to HDF5 belongs to the engine's data slice of "
                                      "the port, which is not ported yet (the card's machine "
                                      "has no h5py); save a .caffemodel")
        save_caffemodel(path, graph_params_to_numpy(self._net.params, self._net.layer_types()),
                        net_name=self._net.name, deconv_names=self._net.deconv_names())

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
        src = other._net.params
        for name in list(self._net.params):
            if name in src:
                self._net.params[name] = src[name]

    # -- the training slice -------------------------------------------------
    def backward(self, *args, **kwargs):
        raise NotImplementedError(f"Net.backward {TRAINING_SLICE}")

    def forward_backward_all(self, *args, **kwargs):
        raise NotImplementedError(f"Net.forward_backward_all {TRAINING_SLICE}")

    def set_input_arrays(self, *args, **kwargs):
        raise NotImplementedError(f"Net.set_input_arrays {TRAINING_SLICE}")


def _solver(*args, **kwargs):
    raise NotImplementedError(f"the Solver family {TRAINING_SLICE}")


get_solver = Solver = SGDSolver = NesterovSolver = AdaGradSolver = _solver
RMSPropSolver = AdaDeltaSolver = AdamSolver = _solver
