"""`.caffemodel` (binary NetParameter) reader/writer + pytree converter.

The port's own copy of `deepcut_tpu.proto.caffemodel` (jax-free; held against the original
by tests/test_torch_data.py and tests/test_torch_data_layers.py): the
`.caffemodel` reader and writer, the HDF5 weight files (h5py imported only
there) and the `.solverstate` codec. The writers take params in the JAX
package's layouts (`models.convert.graph_params_to_numpy` gives them).

Mirrors the reference's weight-loading semantics
(Net::CopyTrainedLayersFrom, src/caffe/net.cpp:805-846): layers are matched
**by name**; each contributes an ordered list of blobs. Legacy V1
(`NetParameter.layers`, field 2) and V0 (nested `layer`, blobs at field 50)
containers are handled the way upgrade_proto.cpp does — by lifting
name + blobs out of the old container.

Field numbers follow the caffe.proto interface:
  NetParameter:   name=1, layers(V1)=2, layer=100
  LayerParameter: name=1, type=2, blobs=7
  V1LayerParameter: layer(V0)=1, name=4, type(enum)=5, blobs=6
  BlobProto: num=1, channels=2, height=3, width=4, data=5, diff=6,
             shape=7 (BlobShape.dim=1), double_data=8
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import os

import numpy as np

from deepcut_tpu_torch.proto import wire


class Blob:
    __slots__ = ("shape", "data", "legacy", "diff")

    def __init__(self, shape: Tuple[int, ...], data: np.ndarray,
                 legacy: bool = False, diff: Optional[np.ndarray] = None):
        self.shape = tuple(int(s) for s in shape)
        self.data = np.asarray(data, np.float32).reshape(self.shape)
        # True when the shape came from the V0-era num/channels/height/width
        # fields (always rank-4, 1-padded) rather than an explicit BlobShape
        self.legacy = legacy
        # Gradient payload (BlobProto field 6) — present in snapshots written
        # with `snapshot_diff: true` (Solver::SnapshotToBinaryProto passes
        # write_diff through Net::ToProto, solver.cpp:452-459).
        self.diff = (None if diff is None
                     else np.asarray(diff, np.float32).reshape(self.shape))


def _decode_blob(buf: bytes) -> Blob:
    fields = wire.decode(buf)
    if 7 in fields:  # BlobShape
        shape_fields = wire.decode(fields[7][0][1])
        shape = tuple(wire.read_ints(shape_fields.get(1, [])))
    else:  # legacy 4-D num/channels/height/width
        dims = []
        for f in (1, 2, 3, 4):
            if f in fields:
                dims.append(fields[f][0][1])
        shape = tuple(dims) if dims else ()
    if 5 in fields:
        data = wire.read_floats(fields[5])
    elif 8 in fields:
        data = wire.read_doubles(fields[8]).astype(np.float32)
    else:
        data = np.zeros((0,), np.float32)
    if not shape:
        shape = (len(data),)
    diff = None
    if 6 in fields:
        diff = wire.read_floats(fields[6])
    elif 9 in fields:
        diff = wire.read_doubles(fields[9]).astype(np.float32)
    return Blob(shape, data, legacy=7 not in fields, diff=diff)


def _decode_layer(buf: bytes) -> Tuple[str, str, List[Blob]]:
    fields = wire.decode(buf)
    name = wire.read_string(fields[1][0]) if 1 in fields else ""
    ltype = wire.read_string(fields[2][0]) if 2 in fields else ""
    blobs = [_decode_blob(v) for _, v in fields.get(7, [])]
    return name, ltype, blobs


def _decode_v1_layer(buf: bytes) -> Tuple[str, str, List[Blob]]:
    fields = wire.decode(buf)
    if 1 in fields:  # nested V0LayerParameter
        v0 = wire.decode(fields[1][0][1])
        name = wire.read_string(v0[1][0]) if 1 in v0 else ""
        ltype = wire.read_string(v0[2][0]) if 2 in v0 else ""
        blobs = [_decode_blob(v) for _, v in v0.get(50, [])]
        return name, ltype, blobs
    name = wire.read_string(fields[4][0]) if 4 in fields else ""
    ltype = str(fields[5][0][1]) if 5 in fields else ""  # numeric V1 enum
    blobs = [_decode_blob(v) for _, v in fields.get(6, [])]
    return name, ltype, blobs


def load_caffemodel(path: str) -> "OrderedDict[str, List[Blob]]":
    """Read weights into {layer_name: [Blob, ...]} (upgraded as needed).
    Dispatches on extension like the reference (solver.cpp:471-481):
    `.h5`/`.caffemodel.h5` -> HDF5 layout, else binary NetParameter."""
    if path.endswith(".h5") or path.endswith(".hdf5"):
        return load_hdf5_weights(path)
    with open(path, "rb") as f:
        buf = f.read()
    return decode_netparameter(buf)


def decode_netparameter(buf: bytes) -> "OrderedDict[str, List[Blob]]":
    fields = wire.decode(buf)
    out: "OrderedDict[str, List[Blob]]" = OrderedDict()
    for _, v in fields.get(100, []):  # new-style layer
        name, _, blobs = _decode_layer(v)
        if blobs:
            out[name] = blobs
    for _, v in fields.get(2, []):  # legacy V1 layers
        name, _, blobs = _decode_v1_layer(v)
        if blobs and name not in out:
            out[name] = blobs
    return out


# --------------------------------------------------------------------------
# Conversion into the native param pytree (Caffe layout -> NHWC/HWIO)
# --------------------------------------------------------------------------


def conv_blob_to_hwio(blob: Blob, groups: int = 1) -> np.ndarray:
    """Caffe conv weight (Cout, Cin/g, kh, kw) -> HWIO (kh, kw, Cin/g, Cout)."""
    return blob.data.transpose(2, 3, 1, 0)


def deconv_blob_to_native(blob: Blob) -> np.ndarray:
    """Caffe deconv weight (Cin, Cout/g, kh, kw) -> (kh, kw, Cin, Cout/g)."""
    return blob.data.transpose(2, 3, 0, 1)


def blobs_to_params(
    blobs_by_name: "OrderedDict[str, List[Blob]]",
    *,
    deconv_names: Optional[List[str]] = None,
    bias_names: Optional[List[str]] = None,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Map Caffe blobs into the native param pytree by layer-name pattern.

    - 4-D first blob => conv weight (or deconv for names in `deconv_names`),
      optional 1-D second blob => bias
    - 3 blobs of shape (C,),(C,),(1,) => BatchNorm {mean, var, scale_factor}
    - 2 blobs (C,),(C,) => Scale {gamma, beta}; 1 blob (C,) => {gamma}
    - 2-D first blob => InnerProduct weight (N_out, K), kept Caffe layout
    - names in `bias_names` (Bias layers; 2-bottom Scale with bias_term,
      whose ONLY blob is the bias — scale_layer.cpp:15-60): single blob
      => {beta} at its stored shape (the shape heuristics above would
      otherwise misfile it as gamma or a weight)
    """
    deconv_set = set(deconv_names or [])
    bias_set = set(bias_names or [])
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for name, blobs in blobs_by_name.items():
        if name in bias_set and len(blobs) == 1:
            b = blobs[0]
            params[name] = {"beta": b.data.reshape(b.shape)}
            continue
        # Legacy V0 blobs are always 4-D ((1,1,1,C) vectors, (1,1,N,K) IP
        # weights — blob.cpp legacy shape); squeeze the unit leading dims so
        # the layout heuristics below see canonical ranks. Only blobs that
        # actually used the legacy num/channels fields are squeezed: a
        # MODERN (1,1,kh,kw) conv weight (Cin=Cout=1) must stay rank-4.
        canon = []
        for b in blobs:
            if (getattr(b, "legacy", False) and len(b.shape) == 4
                    and b.shape[0] == 1 and b.shape[1] == 1):
                new_shape = b.shape[3:] if b.shape[2] == 1 else b.shape[2:]
                b = Blob(new_shape, b.data.reshape(new_shape))
            canon.append(b)
        blobs = canon
        b0 = blobs[0]
        entry: Dict[str, np.ndarray] = {}
        if len(b0.shape) == 4:
            if name in deconv_set:
                entry["w"] = deconv_blob_to_native(b0)
            else:
                entry["w"] = conv_blob_to_hwio(b0)
            if len(blobs) > 1:
                entry["b"] = blobs[1].data.reshape(-1)
        elif len(blobs) == 3 and blobs[2].data.size == 1:
            entry = {
                "mean": blobs[0].data.reshape(-1),
                "var": blobs[1].data.reshape(-1),
                "scale_factor": blobs[2].data.reshape(-1),
            }
        elif len(blobs) == 2 and len(b0.shape) <= 1 and blobs[1].data.size == b0.data.size:
            entry = {"gamma": b0.data.reshape(-1), "beta": blobs[1].data.reshape(-1)}
        elif len(blobs) == 1 and len(b0.shape) <= 1:
            entry = {"gamma": b0.data.reshape(-1)}
        elif len(b0.shape) == 2:
            entry["w"] = b0.data
            if len(blobs) > 1:
                entry["b"] = blobs[1].data.reshape(-1)
        else:
            entry["blobs"] = [b.data for b in blobs]  # raw fallback
        params[name] = entry
    return params


def load_deepercut_params(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """One-shot: .caffemodel -> DeeperCut param pytree (Caffe names, HWIO)."""
    blobs = load_caffemodel(path)
    deconvs = [n for n in blobs if n.startswith("res5c_up_")]
    return blobs_to_params(blobs, deconv_names=deconvs)


# --------------------------------------------------------------------------
# Writer (snapshots interchangeable with the reference)
# --------------------------------------------------------------------------


def _encode_blob(arr: np.ndarray, *, legacy: bool = False,
                 diff: Optional[np.ndarray] = None) -> wire.Encoder:
    arr = np.asarray(arr, np.float32)
    blob = wire.Encoder()
    if legacy:
        # V0-era BlobProto: num/channels/height/width fields, always 4-D
        # (blob.cpp legacy shape; 1-D params stored as (1,1,1,C)).
        dims = (1,) * (4 - arr.ndim) + arr.shape if arr.ndim < 4 else arr.shape
        for f, d in zip((1, 2, 3, 4), dims):
            blob.varint(f, int(d))
    else:
        shape = wire.Encoder()
        shape.packed_int64s(1, arr.shape)
        blob.message(7, shape)
    blob.packed_floats(5, arr.reshape(-1))
    if diff is not None:
        blob.packed_floats(6, np.asarray(diff, np.float32).reshape(-1))
    return blob


def encode_netparameter(
    layers: "OrderedDict[str, List[np.ndarray]]", *, net_name: str = "net",
    container: str = "v2",
    layer_diffs: Optional[Dict[str, List[np.ndarray]]] = None,
) -> bytes:
    """Serialise weights as a binary NetParameter.

    container: 'v2' (LayerParameter, field 100 — what the reference writes
    today), 'v1' (V1LayerParameter, field 2, blobs at 6), or 'v0' (V1 entry
    nesting a V0LayerParameter at field 1 with blobs at 50, legacy 4-D blob
    shapes) — the three generations UpgradeNetAsNeeded accepts
    (upgrade_proto.cpp:19-67)."""
    assert container in ("v2", "v1", "v0")
    enc = wire.Encoder()
    enc.string(1, net_name)
    for name, blobs in layers.items():
        diffs = list((layer_diffs or {}).get(name, ()))
        # pad (never truncate): a diffs list shorter than the layer's blob
        # list must not drop DATA blobs from the zip below
        diffs += [None] * (len(blobs) - len(diffs))
        if container == "v2":
            layer = wire.Encoder()
            layer.string(1, name)
            layer.string(2, "")
            for arr, d in zip(blobs, diffs):
                layer.message(7, _encode_blob(arr, diff=d))
            enc.message(100, layer)
        elif container == "v1":
            layer = wire.Encoder()
            layer.string(4, name)
            for arr, d in zip(blobs, diffs):
                layer.message(6, _encode_blob(arr, diff=d))
            enc.message(2, layer)
        else:
            v0 = wire.Encoder()
            v0.string(1, name)
            for arr, d in zip(blobs, diffs):
                v0.message(50, _encode_blob(arr, legacy=True, diff=d))
            layer = wire.Encoder()
            layer.message(1, v0)
            enc.message(2, layer)
    return enc.tobytes()


def _entry_to_blobs(name: str, entry: Dict[str, np.ndarray],
                    deconv_names=()) -> List[np.ndarray]:
    """Native param entry -> ordered Caffe blob list (inverse of
    blobs_to_params). `deconv_names`: layers whose 4-D weight uses the
    deconv layout (kh,kw,Cin,Cout/g) -> Caffe (Cin,Cout/g,kh,kw); the
    res5c_up_ prefix covers the native DeeperCut head naming."""
    if "mean" in entry:
        return [np.asarray(entry["mean"]), np.asarray(entry["var"]),
                np.asarray(entry["scale_factor"])]
    if "gamma" in entry:
        blobs = [np.asarray(entry["gamma"])]
        if "beta" in entry:
            blobs.append(np.asarray(entry["beta"]))
        return blobs
    if "w" in entry:
        w = np.asarray(entry["w"])
        if w.ndim == 4:
            if name in deconv_names or name.startswith("res5c_up_"):
                w = w.transpose(2, 3, 0, 1)  # native deconv -> Caffe
            else:
                w = w.transpose(3, 2, 0, 1)  # HWIO -> Caffe OIHW
        blobs = [w]
        if "b" in entry:
            blobs.append(np.asarray(entry["b"]))
        return blobs
    return [np.asarray(v) for v in entry.values()]


def save_hdf5_weights(path: str, params: Dict[str, Dict[str, np.ndarray]],
                      *, deconv_names=(),
                      diffs: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
                      ) -> None:
    """Write weights in Caffe's HDF5 layout (Net::ToHDF5, net.cpp:948-980):
    group 'data' -> one group per layer -> datasets '0', '1', ... in Caffe
    blob layouts — interchangeable with reference `.caffemodel.h5` files.
    `deconv_names`: Deconvolution layer names (their 4-D weights export in
    Caffe's (Cin,Cout/g,kh,kw) order). `diffs`: optional gradient pytree,
    written under a sibling 'diff' group (ToHDF5's write_diff branch)."""
    import h5py

    with h5py.File(path, "w") as f:
        data = f.create_group("data")
        diff_group = f.create_group("diff") if diffs else None
        for name, entry in params.items():
            g = data.create_group(name)
            for i, blob in enumerate(
                    _entry_to_blobs(name, entry, deconv_names)):
                g.create_dataset(str(i), data=np.asarray(blob, np.float32))
            if diffs and name in diffs:
                dg = diff_group.create_group(name)
                for i, blob in enumerate(
                        _entry_to_blobs(name, diffs[name], deconv_names)):
                    dg.create_dataset(str(i),
                                      data=np.asarray(blob, np.float32))


def load_hdf5_weights(path: str) -> "OrderedDict[str, List[Blob]]":
    """Read a Caffe `.h5` weight file (CopyTrainedLayersFromHDF5 layout)."""
    import h5py

    out: "OrderedDict[str, List[Blob]]" = OrderedDict()
    with h5py.File(path, "r") as f:
        data = f["data"]
        diff_group = f["diff"] if "diff" in f else None
        for name in data:
            g = data[name]
            dg = (diff_group[name]
                  if diff_group is not None and name in diff_group else None)
            blobs = []
            for i in sorted(g, key=int):
                arr = np.asarray(g[i], np.float32)
                diff = (np.asarray(dg[i], np.float32)
                        if dg is not None and i in dg else None)
                blobs.append(Blob(arr.shape, arr, diff=diff))
            if blobs:
                out[name] = blobs
    return out


def encode_solverstate(it: int, history: List[np.ndarray], *,
                       learned_net: str = "", current_step: int = 0) -> bytes:
    """SolverState binaryproto (caffe.proto:246-251): iter, learned_net,
    repeated history BlobProto, current_step — the reference's
    SGDSolver::SnapshotSolverStateToBinaryProto layout. `history` is a flat
    blob list; both packages write the solver state's per-blob leaves in
    the JAX package's layouts, each dict's keys sorted (the order
    jax.tree_util flattens them in), state entry after state entry
    (SGD/Nesterov/AdaGrad/RMSProp: history; AdaDelta: history then
    update_sq; Adam: m then v — mirroring how the reference's solvers stack
    their state into history_)."""
    enc = wire.Encoder()
    enc.varint(1, int(it))
    if learned_net:
        enc.string(2, learned_net)
    for arr in history:
        enc.message(3, _encode_blob(np.asarray(arr, np.float32)))
    enc.varint(4, int(current_step))
    return enc.tobytes()


def decode_solverstate(buf: bytes) -> Tuple[int, str, List[Blob], int]:
    """-> (iter, learned_net, history blobs, current_step)."""
    fields = wire.decode(buf)
    it = int(fields[1][0][1]) if 1 in fields else 0
    learned = wire.read_string(fields[2][0]) if 2 in fields else ""
    history = [_decode_blob(v) for _, v in fields.get(3, [])]
    step = int(fields[4][0][1]) if 4 in fields else 0
    return it, learned, history, step


def save_caffemodel(path: str, params: Dict[str, Dict[str, np.ndarray]], *,
                    net_name: str = "net", container: str = "v2",
                    deconv_names=(),
                    diffs: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
                    ) -> None:
    """Write the native pytree back to a reference-readable .caffemodel.
    `deconv_names`: Deconvolution layer names (Caffe deconv weight order).
    `diffs`: optional pytree mirroring `params` whose leaves are written as
    each BlobProto's diff (field 6) — the `snapshot_diff: true` artifact the
    reference produces via Net::ToProto(write_diff) (solver.cpp:452-459,
    caffe.proto:196-198)."""
    layers: "OrderedDict[str, List[np.ndarray]]" = OrderedDict()
    layer_diffs: Dict[str, List[np.ndarray]] = {}
    for name, entry in params.items():
        blobs = _entry_to_blobs(name, entry, deconv_names)
        if blobs:
            layers[name] = blobs
            if diffs and name in diffs:
                layer_diffs[name] = _entry_to_blobs(name, diffs[name],
                                                    deconv_names)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_netparameter(layers, net_name=net_name,
                                    container=container,
                                    layer_diffs=layer_diffs))
