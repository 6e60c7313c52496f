"""The port's MATLAB MEX marshaller, driven for real through ctypes.

`deepcut_tpu_torch/matlab/build.py` compiles the port's caffe_.cpp (the
embedded-CPython MEX gateway importing `deepcut_tpu_torch.matlab_gateway`)
against the repository's mex API stub into ``build/deepcut_tpu_torch/``,
and the cases call mexFunction with mxArrays built through the same mx* C
calls MATLAB makes — the six scenarios of tests/test_matlab_mex.py
(argument and result marshalling, handle structs, the column-major byte
contract, the error path), each checked against the port's Python gateway
and, where the values are deterministic, against the JAX package's.
"""

import ctypes
from pathlib import Path

import numpy as np
import pytest

from deepcut_tpu_torch import matlab_gateway as tgw
from deepcut_tpu_torch.matlab import build
from test_matlab_mex import (
    Mex, _blob_handle, _handle_struct, _index_handle, _layer_handle, mxCHAR, mxDOUBLE,
    mxSTRUCT)

REPO = Path(__file__).resolve().parents[1]

SIGNATURES = [
    ("mxCreateString", ctypes.c_void_p, [ctypes.c_char_p]),
    ("mxCreateDoubleScalar", ctypes.c_void_p, [ctypes.c_double]),
    ("mxCreateDoubleMatrix", ctypes.c_void_p, [ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int]),
    ("mxCreateNumericArray", ctypes.c_void_p,
     [ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t), ctypes.c_int, ctypes.c_int]),
    ("mxGetData", ctypes.c_void_p, [ctypes.c_void_p]),
    ("mxGetPr", ctypes.POINTER(ctypes.c_double), [ctypes.c_void_p]),
    ("mxGetScalar", ctypes.c_double, [ctypes.c_void_p]),
    ("mxArrayToString", ctypes.c_char_p, [ctypes.c_void_p]),
    ("mxGetClassID", ctypes.c_int, [ctypes.c_void_p]),
    ("mxGetNumberOfElements", ctypes.c_size_t, [ctypes.c_void_p]),
    ("mxGetNumberOfDimensions", ctypes.c_size_t, [ctypes.c_void_p]),
    ("mxGetDimensions", ctypes.POINTER(ctypes.c_size_t), [ctypes.c_void_p]),
    ("mxGetField", ctypes.c_void_p, [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p]),
    ("mxGetNumberOfFields", ctypes.c_int, [ctypes.c_void_p]),
    ("mxGetFieldNameByNumber", ctypes.c_char_p, [ctypes.c_void_p, ctypes.c_int]),
    ("mxGetCell", ctypes.c_void_p, [ctypes.c_void_p, ctypes.c_size_t]),
    ("mex_test_call", ctypes.c_int,
     [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
      ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p, ctypes.c_int]),
    ("mex_test_drain_printed", ctypes.c_int, [ctypes.c_char_p, ctypes.c_int]),
]


def load_mex(path) -> Mex:
    """The port's MEX shared object with the stub's C API typed."""
    lib = ctypes.CDLL(str(path))
    for name, res, args in SIGNATURES:
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return Mex(lib)


@pytest.fixture(scope="module")
def mex():
    so = build.build_test_so()
    assert so.parent == REPO / "build" / "deepcut_tpu_torch"
    return load_mex(so)


@pytest.fixture(autouse=True)
def port_on_cpu(mex):
    mex.call("set_mode_cpu", nlhs=0)


@pytest.fixture(scope="module")
def net_file(tmp_path_factory):
    from test_matlab_binding import NET_FIXTURE
    p = tmp_path_factory.mktemp("mex") / "testnet.prototxt"
    p.write_text(NET_FIXTURE.format(num_output=13))
    return str(p)


def test_version_and_init_key(mex):
    (v,) = mex.call("version")
    assert mex.L.mxGetClassID(v) == mxCHAR
    text = mex.L.mxArrayToString(v).decode()
    assert "caffe 1.0.0-rc3" in text and "deepcut_tpu_torch" in text
    assert text == tgw.dispatch("version", [])[0]["v"]
    (k,) = mex.call("get_init_key")
    assert mex.L.mxGetClassID(k) == mxDOUBLE
    assert mex.L.mxGetScalar(k) == tgw.dispatch("get_init_key", [])[0]["v"]


def test_net_roundtrip_matches_gateway(mex, net_file):
    """get_net / net_get_attr / forward / blob data through the C layer,
    against the same commands through the port's Python gateway."""
    (h,) = mex.call("get_net", mex.str_(net_file), mex.str_("train"))
    assert mex.L.mxGetClassID(h) == mxSTRUCT
    (attr,) = mex.call("net_get_attr", h)
    assert mex.fieldnames(attr) == [
        "hLayer_layers", "hBlob_blobs", "input_blob_indices",
        "output_blob_indices", "layer_names", "blob_names"]
    py_attr = dict(tgw.dispatch("net_get_attr", [tgw.dispatch(
        "get_net", [net_file, "train"])[0]])[0]["fields"])
    assert mex.cellstr(mex.field(attr, "layer_names")) == py_attr["layer_names"]["v"] == [
        "data", "conv", "ip", "loss"]
    assert mex.cellstr(mex.field(attr, "blob_names")) == py_attr["blob_names"]["v"]
    assert mex.to_list(mex.field(attr, "output_blob_indices")) == [4.0]

    data_h = _blob_handle(mex, attr, "data")
    (sh,) = mex.call("blob_get_shape", data_h)
    assert mex.to_list(sh) == [4.0, 3.0, 2.0, 5.0]  # MATLAB W H C N

    tens = np.arange(5 * 2 * 3 * 4, dtype=np.float32).reshape(5, 2, 3, 4)
    mex.call("blob_set_data", data_h, mex.single(tens), nlhs=0)
    (back,) = mex.call("blob_get_data", data_h)
    np.testing.assert_array_equal(mex.to_np(back), tens)

    label_h = _blob_handle(mex, attr, "label")
    labels = np.random.RandomState(0).randint(0, 13, (5, 1, 1, 1))
    mex.call("blob_set_data", label_h, mex.single(labels), nlhs=0)
    mex.call("net_forward", h, nlhs=0)
    (loss,) = mex.call("blob_get_data", _blob_handle(mex, attr, "loss"))
    assert np.isfinite(mex.to_np(loss)).all()
    (lab,) = mex.call("blob_get_data", label_h)
    np.testing.assert_array_equal(mex.to_np(lab), labels)  # fill-once persisted

    mex.call("net_backward", h, nlhs=0)
    (dd,) = mex.call("blob_get_diff", _blob_handle(mex, attr, "data"))
    assert np.abs(mex.to_np(dd)).sum() > 0

    # the same diff through the Python gateway on the same net object
    ctx = tgw._deref({"ptr": int(mex.L.mxGetScalar(mex.field(h, "ptr"))),
                      "init_key": mex.L.mxGetScalar(mex.field(h, "init_key"))}, "net")
    np.testing.assert_array_equal(mex.to_np(dd), ctx.blob_diff("data"))

    # layer params come back in Caffe blob order, reversed for MATLAB
    conv_h = _layer_handle(mex, attr, "conv")
    (lattr,) = mex.call("layer_get_attr", conv_h)
    w_h = _index_handle(mex, mex.field(lattr, "hBlob_blobs"), 0)
    (wsh,) = mex.call("blob_get_shape", w_h)
    assert mex.to_list(wsh) == [2.0, 2.0, 2.0, 11.0]
    (w,) = mex.call("blob_get_data", w_h)
    np.testing.assert_array_equal(mex.to_np(w), ctx.net._net.params["conv"]["w"].numpy())
    (typ,) = mex.call("layer_get_type", conv_h)
    assert mex.L.mxArrayToString(typ).decode() == "Convolution"


def test_blob_reshape_through_dvec(mex, net_file):
    (h,) = mex.call("get_net", mex.str_(net_file), mex.str_("train"))
    (attr,) = mex.call("net_get_attr", h)
    data_h = _blob_handle(mex, attr, "data")
    mex.call("blob_reshape", data_h, mex.dvec([6, 5, 4, 3, 2, 1]), nlhs=0)
    (sh,) = mex.call("blob_get_shape", data_h)
    assert mex.to_list(sh) == [6.0, 5.0, 4.0, 3.0, 2.0, 1.0]


def test_solver_step_and_attr(mex, net_file, tmp_path):
    sfile = tmp_path / "solver.prototxt"
    sfile.write_text(f'net: "{net_file}"\nbase_lr: 0.01\nmomentum: 0.9\n'
                     'lr_policy: "fixed"\ndisplay: 0\nmax_iter: 100\n'
                     'snapshot_after_train: false\n')
    (hs,) = mex.call("get_solver", mex.str_(str(sfile)))
    (attr,) = mex.call("solver_get_attr", hs)
    hnet = _index_handle(mex, mex.field(attr, "hNet_net"), 0)
    (nattr,) = mex.call("net_get_attr", hnet)
    label_h = _blob_handle(mex, nattr, "label")
    labels = np.random.RandomState(2).randint(0, 13, (5, 1, 1, 1))
    mex.call("blob_set_data", label_h, mex.single(labels), nlhs=0)
    mex.call("solver_step", hs, mex.dbl(3), nlhs=0)
    (it,) = mex.call("solver_get_iter", hs)
    assert mex.L.mxGetScalar(it) == 3.0


def test_read_write_mean(mex, tmp_path):
    """The mean file crosses packages: the port's MEX writes, the JAX
    package's gateway reads the same bytes back."""
    from deepcut_tpu import matlab_gateway as jgw

    mean = (255 * np.random.RandomState(3).rand(3, 6, 4)).astype(np.float32)
    mfile = str(tmp_path / "mean.binaryproto")
    mex.call("write_mean", mex.single(mean), mex.str_(mfile), nlhs=0)
    (got,) = mex.call("read_mean", mex.str_(mfile))
    np.testing.assert_allclose(mex.to_np(got).reshape(mean.shape), mean)
    np.testing.assert_array_equal(
        np.frombuffer(jgw.dispatch("read_mean", [mfile])[0]["data"], "<f4"),
        mex.to_np(got).ravel())


def test_error_paths_and_reset(mex, net_file):
    with pytest.raises(RuntimeError, match="Unknown command"):
        mex.call("no_such_cmd")
    with pytest.raises(RuntimeError, match="Unknown command"):
        mex.call("")  # empty command string reaches dispatch verbatim
    # zero-argument call never reaches Python: Usage error from the C layer
    plhs = (ctypes.c_void_p * 1)()
    err = ctypes.create_string_buffer(256)
    assert mex.L.mex_test_call(1, plhs, 0, None, err, 256) == 1
    assert b"Usage" in err.value
    with pytest.raises(RuntimeError, match="Unknown phase"):
        mex.call("get_net", mex.str_(net_file), mex.str_("deploy"))

    (h,) = mex.call("get_net", mex.str_(net_file), mex.str_("train"))
    mex.call("reset", nlhs=0)
    assert "stand-alone nets" in mex.printed()  # mexPrintf side channel
    with pytest.raises(RuntimeError, match="init_key"):
        mex.call("net_forward", h, nlhs=0)
    # stale handle with a forged init_key is also rejected
    bad = _handle_struct(mex, 1, -1.0)
    with pytest.raises(RuntimeError, match="init_key"):
        mex.call("net_forward", bad, nlhs=0)


def test_matlab_package_assembles(tmp_path, capsys):
    """The MATLAB target: the repository's matcaffe classes with the port's
    MEX source under private/ (no MATLAB here: the mex line is printed)."""
    out = build.assemble_matlab_package(tmp_path)
    pkg = out / "+caffe"
    want = {p.relative_to(REPO / "matlab" / "+caffe") for p in (REPO / "matlab" / "+caffe").rglob(
        "*.m")}
    assert want and want <= {p.relative_to(pkg) for p in pkg.rglob("*.m")}
    assert (pkg / "private" / "caffe_.cpp").read_bytes() == build.SOURCE.read_bytes()
    assert not list(pkg.rglob("*.so"))
    assert "mex -outdir" in capsys.readouterr().out
