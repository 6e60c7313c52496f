"""matcaffe command gateway: the Python side of the MATLAB binding, on the
port's pycaffe facade.

Counterpart of `deepcut_tpu.matlab_gateway`. The reference binds MATLAB
through one MEX entry point dispatching string commands (`caffe_('get_net',
file, phase)` etc., the command table of matlab/+caffe/private/caffe_.cpp).
Here the MEX layer (deepcut_tpu_torch/matlab/caffe_.cpp) is a thin
marshaller that embeds CPython and forwards every command to
:func:`dispatch`; the semantics live in this module on top of
`deepcut_tpu_torch.compat` (Net / Solver), so the MATLAB and Python front
ends share one behaviour.

Wire protocol (the JAX package's, unchanged; plain Python values both ways,
so the C side stays dumb and ctypes-driven tests can call :func:`dispatch`
directly):

incoming argument encodings
    str                                MATLAB char row vector
    float                              double scalar
    [float, ...]                       double vector (shape rows)
    {"ptr": int, "init_key": float}    object handle struct
    {"dims": (…), "data": bytes}       single array; dims in MATLAB order,
                                       bytes are the raw column-major f32
                                       payload — identical memory to a
                                       C-order array with reversed dims,
                                       so no element shuffling ever happens

result item encodings (list per command)
    {"t": "str", "v": str}
    {"t": "double", "v": float}
    {"t": "dvec", "v": [...], "rows": r, "cols": c}
    {"t": "handles", "v": [handle, ...]}      struct vector (ptr/init_key)
    {"t": "strcell", "v": [str, ...]}
    {"t": "single", "dims": [...], "data": bytes}
    {"t": "struct", "fields": [(name, item), ...]}
    {"t": "print", "v": str}                   mexPrintf side channel

MATLAB stores arrays column-major with width fastest; Caffe/numpy are
row-major with width fastest — i.e. a MATLAB (W,H,C,N) single array and a
C-order (N,C,H,W) float32 array are THE SAME BYTES. The gateway therefore
only reverses dim tuples at the boundary.

Parameter blobs: the port's `compat.Net.params` are already in Caffe's
layouts (conv OIHW, deconv (Cin, Cout/g, kh, kw)), so they cross as they
are; the JAX gateway transposes its HWIO arrays to the same bytes.

Device: `set_mode_cpu` / `set_mode_gpu` / `set_device` choose the device
the next `get_net` / `get_solver` builds on: ``cuda:0`` by default,
``cpu`` after set_mode_cpu, ``cuda:<current>`` after set_mode_gpu,
``cuda:<i>`` after set_device(i). Objects already built keep theirs.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import deepcut_tpu_torch.compat as caffe

# ---------------------------------------------------------------------------
# handle registry

_objects: Dict[int, Tuple[str, Any]] = {}
_init_key: float = float(random.randint(1, 2**31 - 1))
_next_id: int = 1
_n_solvers = 0
_n_nets = 0  # stand-alone nets (the reference's reset message)
_device = "cuda:0"


def device() -> str:
    """The device the next `get_net` / `get_solver` builds on."""
    return _device


def _register(kind: str, obj: Any) -> Dict[str, Any]:
    global _next_id
    hid = _next_id
    _next_id += 1
    _objects[hid] = (kind, obj)
    return {"ptr": hid, "init_key": _init_key}


def _deref(handle: Any, kind: str) -> Any:
    if not isinstance(handle, dict) or "ptr" not in handle:
        raise TypeError(f"expected a {kind} handle struct")
    if float(handle.get("init_key", -1)) != _init_key:
        raise ValueError(
            "Could not convert handle to pointer due to invalid init_key. "
            "The object might have been cleared.")
    got_kind, obj = _objects[int(handle["ptr"])]
    if got_kind != kind:
        raise TypeError(f"handle is a {got_kind}, expected {kind}")
    return obj


# ---------------------------------------------------------------------------
# value helpers

def _ml_dims(caffe_shape: Tuple[int, ...]) -> List[int]:
    """Caffe (row-major) dims -> MATLAB dims (reversed), trailing singleton
    dims beyond 2 stripped the way MATLAB squeezes them."""
    dims = list(reversed([int(d) for d in caffe_shape])) or [1]
    while len(dims) > 2 and dims[-1] == 1:
        dims.pop()
    if len(dims) == 1:
        dims.append(1)
    return dims


def _from_single(arg: Any) -> np.ndarray:
    """Wire single array -> C-order float32 ndarray with CAFFE dims."""
    dims = tuple(int(d) for d in arg["dims"])
    return np.frombuffer(bytes(arg["data"]), "<f4").reshape(dims[::-1]).copy()


def _to_single(arr: np.ndarray) -> Dict[str, Any]:
    a = np.ascontiguousarray(arr, np.float32)
    return {"t": "single", "dims": _ml_dims(a.shape), "data": a.tobytes()}


def _dvec(vals, rows: int, cols: int) -> Dict[str, Any]:
    return {"t": "dvec", "v": [float(v) for v in vals],
            "rows": rows, "cols": cols}


# ---------------------------------------------------------------------------
# net / blob contexts

class _NetCtx:
    """A compat.Net plus the bookkeeping the MATLAB surface needs: the full
    Caffe-ordered blob list, staged-write tracking, on-demand diffs."""

    def __init__(self, net: "caffe.Net"):
        self.net = net
        gnet = net._net
        names: List[str] = list(gnet.input_names)
        for spec in gnet.layer_specs:
            if spec.type in ("Silence", "Input"):
                continue
            for t in spec.tops:
                if t not in names:
                    names.append(t)
        self.blob_names = names
        self.layer_names = [s.name for s in gnet.layer_specs]
        self.layer_types = {s.name: s.type for s in gnet.layer_specs}
        self.user_staged: set = set()   # blobs written via blob_set_data
        self.staged_diffs: set = set()  # blobs written via blob_set_diff
        self.param_diffs: Dict[Tuple[str, int], np.ndarray] = {}
        self.bwd_count = 0              # invalidates the on-demand diff cache
        self._diff_cache: Dict[Tuple[str, int], np.ndarray] = {}
        self._shape_cache: Optional[Dict[str, Tuple[int, ...]]] = None

    # -- shapes -------------------------------------------------------------
    def blob_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Caffe-order shape of every blob, without consuming data batches:
        the staged blobs' own shapes over the graph's shape pass
        (`core.graph.Net.blob_shapes`, the analog of Net::Init's Reshape)."""
        if self._shape_cache is not None:
            return self._shape_cache
        gnet = self.net._net
        staged = {nm: tuple(self.net.blobs[nm].data.shape)
                  for nm in gnet.input_names if nm in self.net.blobs}
        shapes = {nm: tuple(b.data.shape) for nm, b in self.net.blobs.items()}
        for nm, sh in gnet.blob_shapes(staged).items():
            shapes.setdefault(nm, sh)
        self._shape_cache = shapes
        return shapes

    def invalidate_shapes(self) -> None:
        self._shape_cache = None

    # -- blob access ----------------------------------------------------
    def blob_data(self, name: str) -> np.ndarray:
        if name in self.net.blobs:
            return np.asarray(self.net.blobs[name].data, np.float32)
        return np.zeros(self.blob_shapes()[name], np.float32)

    def set_blob_data(self, name: str, arr: np.ndarray) -> None:
        cur = self.blob_data(name)
        if arr.size != cur.size:
            raise ValueError(
                "number of elements in target blob doesn't match that in "
                f"input array ({cur.size} vs {arr.size})")
        val = arr.reshape(cur.shape)
        if name in self.net.blobs:
            self.net.blobs[name].data = val.copy()
        else:
            self.net.blobs[name] = caffe.Blob(val)
        self.user_staged.add(name)

    def blob_diff(self, name: str) -> np.ndarray:
        if name in self.net.blobs and self.net.blobs[name]._diff is not None:
            return np.asarray(self.net.blobs[name].diff, np.float32)
        gnet = self.net._net
        if self.bwd_count and name not in gnet.input_names:
            key = (name, self.bwd_count)
            if key not in self._diff_cache:
                kwargs = self._staged_output_diffs() or {}
                self._diff_cache[key] = np.asarray(
                    self.net.backward(diffs=[name], **kwargs)[name],
                    np.float32)
            return self._diff_cache[key]
        return np.zeros(self.blob_data(name).shape, np.float32)

    def set_blob_diff(self, name: str, arr: np.ndarray) -> None:
        cur = self.blob_data(name)
        if arr.size != cur.size:
            raise ValueError(
                "number of elements in target blob doesn't match that in "
                f"input array ({cur.size} vs {arr.size})")
        if name not in self.net.blobs:
            self.net.blobs[name] = caffe.Blob(cur)
        self.net.blobs[name]._diff = arr.reshape(cur.shape).copy()
        self.staged_diffs.add(name)

    def _staged_output_diffs(self) -> Optional[Dict[str, np.ndarray]]:
        outs = set(self.net.outputs)
        if outs and outs <= self.staged_diffs:
            return {o: np.asarray(self.net.blobs[o].diff, np.float32)
                    for o in outs}
        return None

    # -- forward / backward ----------------------------------------------
    def forward(self) -> None:
        self.net.forward()
        self.invalidate_shapes()

    def backward(self) -> None:
        # drop diffs from the previous backward (keep user-staged ones) so
        # reads after this run never see stale cotangents
        for nm, blob in self.net.blobs.items():
            if nm not in self.staged_diffs:
                blob._diff = None
        kwargs = self._staged_output_diffs() or {}
        self.net.backward(**kwargs)
        self.bwd_count += 1

    def sticky_staged(self) -> Dict[str, np.ndarray]:
        """User-staged values for fill-once blobs (constant DummyData tops)
        — the solver merges these into every training batch."""
        sticky = self.net._net.sticky_top_names()
        return {nm: np.asarray(self.net.blobs[nm].data, np.float32)
                for nm in self.user_staged & sticky if nm in self.net.blobs}


class _BlobRef:
    """Handle target for both activation blobs and layer param blobs. A
    param blob is read and written in Caffe's layout, the port's own."""

    def __init__(self, ctx: _NetCtx, kind: str, key: Any):
        self.ctx = ctx
        self.kind = kind  # "act" | "param"
        self.key = key    # blob name | (layer name, index)

    def _param(self) -> "caffe.Blob":
        layer, idx = self.key
        return self.ctx.net.params[layer][idx]

    def shape(self) -> Tuple[int, ...]:
        if self.kind == "act":
            return tuple(self.ctx.blob_data(self.key).shape)
        return tuple(self._param().data.shape)

    def get_data(self) -> np.ndarray:
        if self.kind == "act":
            return self.ctx.blob_data(self.key)
        return np.asarray(self._param().data, np.float32)

    def set_data(self, arr: np.ndarray) -> None:
        if self.kind == "act":
            self.ctx.set_blob_data(self.key, arr)
            return
        view = self._param()
        if arr.size != view.data.size:
            raise ValueError(
                "number of elements in target blob doesn't match that in "
                f"input array ({view.data.size} vs {arr.size})")
        view.data[...] = arr.reshape(view.data.shape)  # write-through

    def get_diff(self) -> np.ndarray:
        if self.kind == "act":
            return self.ctx.blob_diff(self.key)
        staged = self.ctx.param_diffs.get(tuple(self.key))
        return (staged if staged is not None
                else np.zeros(self.shape(), np.float32))

    def set_diff(self, arr: np.ndarray) -> None:
        if self.kind == "act":
            self.ctx.set_blob_diff(self.key, arr)
            return
        self.ctx.param_diffs[tuple(self.key)] = arr.reshape(self.shape()).copy()

    def reshape(self, caffe_shape: Tuple[int, ...]) -> None:
        if self.kind != "act":
            raise ValueError("reshaping a parameter blob is not supported "
                             "(params belong to the functional graph)")
        name = self.key
        if name in self.ctx.net.blobs:
            self.ctx.net.blobs[name].reshape(*caffe_shape)
        else:
            self.ctx.net.blobs[name] = caffe.Blob(
                np.zeros(caffe_shape, np.float32))
        if self.ctx._shape_cache is not None:
            self.ctx._shape_cache[name] = tuple(int(d) for d in caffe_shape)


class _SolverCtx:
    def __init__(self, solver: "caffe.Solver"):
        self.solver = solver
        self.net_ctx = _NetCtx(solver.net)
        self.test_ctxs = [_NetCtx(n) for n in solver.test_nets]

    def _push_staged(self) -> None:
        self.solver._solver.extra_inputs.update(self.net_ctx.sticky_staged())
        extra_test = {}
        for ctx in self.test_ctxs:
            extra_test.update(ctx.sticky_staged())
        if extra_test:
            self.solver._solver.extra_test_inputs.update(extra_test)

    def step(self, iters: int) -> None:
        self._push_staged()
        self.solver.step(iters)

    def solve(self) -> None:
        self._push_staged()
        self.solver.solve()


# ---------------------------------------------------------------------------
# commands (the reference caffe_.cpp's command table)

def _net_handle_struct(ctx: _NetCtx) -> Dict[str, Any]:
    layers = [_register("layer", (ctx, nm)) for nm in ctx.layer_names]
    blobs = [_register("blob", _BlobRef(ctx, "act", nm))
             for nm in ctx.blob_names]
    gnet = ctx.net._net
    in_idx = [ctx.blob_names.index(nm) for nm in gnet.input_names]
    out_idx = [ctx.blob_names.index(nm) for nm in ctx.net.outputs
               if nm in ctx.blob_names]
    return {"t": "struct", "fields": [
        ("hLayer_layers", {"t": "handles", "v": layers}),
        ("hBlob_blobs", {"t": "handles", "v": blobs}),
        ("input_blob_indices", _dvec(in_idx, len(in_idx), 1)),
        ("output_blob_indices", _dvec(out_idx, len(out_idx), 1)),
        ("layer_names", {"t": "strcell", "v": ctx.layer_names}),
        ("blob_names", {"t": "strcell", "v": ctx.blob_names}),
    ]}


def _cmd_get_solver(args):
    global _n_solvers
    solver = caffe.get_solver(str(args[0]), device=_device)
    _n_solvers += 1
    return [_register("solver", _SolverCtx(solver))]


def _cmd_solver_get_attr(args):
    sctx = _deref(args[0], "solver")
    return [{"t": "struct", "fields": [
        ("hNet_net", {"t": "handles",
                      "v": [_register("net", sctx.net_ctx)]}),
        ("hNet_test_nets", {"t": "handles",
                            "v": [_register("net", c)
                                  for c in sctx.test_ctxs]}),
    ]}]


def _cmd_get_net(args):
    global _n_nets
    model_file, phase_name = str(args[0]), str(args[1])
    if phase_name not in ("train", "test"):
        raise ValueError("Unknown phase")
    phase = caffe.TRAIN if phase_name == "train" else caffe.TEST
    net = caffe.Net(model_file, phase, device=_device)
    _n_nets += 1
    return [_register("net", _NetCtx(net))]


def _cmd_reset(args):
    global _objects, _init_key, _n_solvers, _n_nets
    msg = (f"Cleared {_n_solvers} solvers and {_n_nets} "
           "stand-alone nets\n")
    _objects = {}
    _n_solvers = _n_nets = 0
    _init_key = float(random.randint(1, 2**31 - 1))
    return [{"t": "print", "v": msg}]


def _cmd_read_mean(args):
    from deepcut_tpu_torch.io import blobproto_bytes_to_array
    with open(str(args[0]), "rb") as f:
        arr = blobproto_bytes_to_array(f.read())
    return [_to_single(np.asarray(arr, np.float32))]


def _cmd_write_mean(args):
    from deepcut_tpu_torch.io import array_to_blobproto_bytes
    arr = _from_single(args[0])  # caffe order (C,H,W) or (H,W)
    if arr.ndim == 2:
        arr = arr[None]
    if arr.ndim == 3:
        arr = arr[None]
    with open(str(args[1]), "wb") as f:
        f.write(array_to_blobproto_bytes(arr))
    return []


def _cmd_set_device(kind: str, index: Optional[int] = None) -> list:
    global _device
    if kind == "cpu":
        _device = "cpu"
    else:
        import torch

        _device = f"cuda:{torch.cuda.current_device() if index is None else index}"
    return []


def dispatch(cmd: str, args: List[Any]) -> List[Dict[str, Any]]:
    """Execute one matcaffe command; returns the result-item list."""
    if cmd == "get_solver":
        return _cmd_get_solver(args)
    if cmd == "solver_get_attr":
        return _cmd_solver_get_attr(args)
    if cmd == "solver_get_iter":
        return [{"t": "double",
                 "v": float(_deref(args[0], "solver").solver.iter)}]
    if cmd == "solver_restore":
        _deref(args[0], "solver").solver.restore(str(args[1]))
        return []
    if cmd == "solver_solve":
        _deref(args[0], "solver").solve()
        return []
    if cmd == "solver_step":
        _deref(args[0], "solver").step(int(float(args[1])))
        return []
    if cmd == "get_net":
        return _cmd_get_net(args)
    if cmd == "net_get_attr":
        return [_net_handle_struct(_deref(args[0], "net"))]
    if cmd == "net_forward":
        _deref(args[0], "net").forward()
        return []
    if cmd == "net_backward":
        _deref(args[0], "net").backward()
        return []
    if cmd == "net_copy_from":
        _deref(args[0], "net").net.copy_from(str(args[1]))
        return []
    if cmd == "net_reshape":
        ctx = _deref(args[0], "net")
        ctx.net.reshape()
        ctx.invalidate_shapes()
        return []
    if cmd == "net_save":
        ctx = _deref(args[0], "net")
        ctx.net._net.materialize_params()  # as the reference's net, saved whole
        ctx.net.save(str(args[1]))
        return []
    if cmd == "layer_get_attr":
        ctx, lname = _deref(args[0], "layer")
        ctx.net._net.materialize_params()  # data-layer nets init lazily
        params = ctx.net.params.get(lname, [])
        refs = [_register("blob", _BlobRef(ctx, "param", (lname, i)))
                for i in range(len(params))]
        return [{"t": "struct", "fields": [
            ("hBlob_blobs", {"t": "handles", "v": refs})]}]
    if cmd == "layer_get_type":
        ctx, lname = _deref(args[0], "layer")
        return [{"t": "str", "v": ctx.layer_types[lname]}]
    if cmd == "blob_get_shape":
        sh = _deref(args[0], "blob").shape()
        dims = list(reversed([int(d) for d in sh]))
        return [_dvec(dims, 1, len(dims))]
    if cmd == "blob_reshape":
        ref = _deref(args[0], "blob")
        ml = args[1] if isinstance(args[1], (list, tuple)) else [args[1]]
        ref.reshape(tuple(int(d) for d in reversed(list(ml))))
        return []
    if cmd == "blob_get_data":
        return [_to_single(_deref(args[0], "blob").get_data())]
    if cmd == "blob_set_data":
        _deref(args[0], "blob").set_data(_from_single(args[1]))
        return []
    if cmd == "blob_get_diff":
        return [_to_single(_deref(args[0], "blob").get_diff())]
    if cmd == "blob_set_diff":
        _deref(args[0], "blob").set_diff(_from_single(args[1]))
        return []
    if cmd == "set_mode_cpu":
        return _cmd_set_device("cpu")
    if cmd == "set_mode_gpu":
        return _cmd_set_device("cuda")
    if cmd == "set_device":
        return _cmd_set_device("cuda", int(float(args[0])))
    if cmd == "get_init_key":
        return [{"t": "double", "v": _init_key}]
    if cmd == "reset":
        return _cmd_reset(args)
    if cmd == "read_mean":
        return _cmd_read_mean(args)
    if cmd == "write_mean":
        return _cmd_write_mean(args)
    if cmd == "version":
        import deepcut_tpu_torch
        return [{"t": "str",
                 "v": f"{deepcut_tpu_torch.__version__} (deepcut_tpu_torch; "
                      "caffe 1.0.0-rc3 compatible)"}]
    raise ValueError(f"Unknown command '{cmd}'")
