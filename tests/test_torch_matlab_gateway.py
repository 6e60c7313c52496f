"""The port's matcaffe gateway (`deepcut_tpu_torch.matlab_gateway`) against
the JAX package's (`deepcut_tpu.matlab_gateway`), command for command.

Each case mirrors one of tests/test_matlab_binding.py's scenarios (the
reference's matlab/+caffe/+test/{test_net,test_solver,test_io}.m) and sends
the same commands through both gateways:

- shapes, names, layer types and the handle structs' layout are equal;
- param blobs carried across by ``.caffemodel`` (one gateway's net_save,
  the other's net_copy_from) read back with the same bytes;
- forward / backward data and diffs agree within 16 f32 ulps at each
  blob's largest magnitude (the sums run in another order);
- solver_step trajectories agree within 2e-5 of each blob's scale.

The numeric cases stage the data and the labels through constant
DummyData tops (fill-once blobs): the fixture's gaussian top is refilled
from each package's own generator, which torch cannot share with JAX. The
port's gateway runs after set_mode_cpu (an autouse fixture).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from deepcut_tpu import matlab_gateway as jgw
from deepcut_tpu_torch import matlab_gateway as tgw
from test_matlab_binding import NET_FIXTURE, _arr, _fields, _single
from test_torch_layers import _steps

REPO = Path(__file__).resolve().parents[1]
ULPS = 16
RTOL = 2e-5

# NET_FIXTURE with both DummyData tops constant, so that the data and the
# labels are staged from the host and persist (the fill-once contract)
STAGED_FIXTURE = NET_FIXTURE.replace(
    'data_filler {{ type: "gaussian" std: 1 }}', 'data_filler {{ type: "constant" }}')
GATEWAYS = (jgw, tgw)


@pytest.fixture(autouse=True)
def port_on_cpu():
    tgw.dispatch("set_mode_cpu", [])
    yield
    tgw.dispatch("set_mode_cpu", [])


@pytest.fixture
def net_file(tmp_path):
    p = tmp_path / "testnet.prototxt"
    p.write_text(NET_FIXTURE.format(num_output=13))
    return str(p)


@pytest.fixture
def staged_file(tmp_path):
    p = tmp_path / "staged.prototxt"
    p.write_text(STAGED_FIXTURE.format(num_output=13))
    return str(p)


def _attr(gw, h):
    return _fields(gw.dispatch("net_get_attr", [h])[0])


def _blob(gw, attr, name):
    return attr["hBlob_blobs"]["v"][attr["blob_names"]["v"].index(name)]


def _layer(gw, attr, name):
    return attr["hLayer_layers"]["v"][attr["layer_names"]["v"].index(name)]


def _param_handles(gw, attr, layer):
    lattr = _fields(gw.dispatch("layer_get_attr", [_layer(gw, attr, layer)])[0])
    return lattr["hBlob_blobs"]["v"]


def _get(gw, cmd, h):
    return _arr(gw.dispatch(cmd, [h])[0])


def _tame(gw, attr, rng):
    """Seeded weights written through the param handles: the fixture's
    fillers (InnerProduct std 2.5 over 792 inputs) give logits of ~300,
    where the softmax's gradient amplifies a one-ulp difference of the
    logits by orders of magnitude; these give logits of a few units."""
    for layer, std in (("conv", 0.5), ("ip", 0.02)):
        for i, hb in enumerate(_param_handles(gw, attr, layer)):
            shape = _get(gw, "blob_get_data", hb).shape
            gw.dispatch("blob_set_data", [hb, _single(std * rng.randn(*shape) if i == 0
                                                      else 0.1 * rng.randn(*shape))])


def _carried_nets(path, tmp_path, phase="train"):
    """One net per gateway, the port's holding the JAX net's (tamed)
    weights through a .caffemodel: -> [(gateway, handle, attr)] for (JAX,
    port)."""
    jh = jgw.dispatch("get_net", [path, phase])[0]
    _tame(jgw, _attr(jgw, jh), np.random.RandomState(7))
    weights = str(tmp_path / "carried.caffemodel")
    jgw.dispatch("net_save", [jh, weights])
    th = tgw.dispatch("get_net", [path, phase])[0]
    tgw.dispatch("net_copy_from", [th, weights])
    return [(jgw, jh, _attr(jgw, jh)), (tgw, th, _attr(tgw, th))]


def _stage(nets, rng):
    data = rng.randn(5, 2, 3, 4).astype(np.float32)
    labels = rng.randint(0, 13, (5, 1, 1, 1)).astype(np.float32)
    for gw, _, attr in nets:
        gw.dispatch("blob_set_data", [_blob(gw, attr, "data"), _single(data)])
        gw.dispatch("blob_set_data", [_blob(gw, attr, "label"), _single(labels)])
    return data, labels


def assert_ulps(got, want, what):
    steps = _steps(got, want, "f32")
    assert steps <= ULPS, f"{what}: {steps} f32 ulps (held to {ULPS})"


def test_net_attr_names_and_indices(net_file):
    """The net_get_attr struct: field names in order, the names, the index
    vectors and the number of handles equal; the port's matches the
    reference fixture's expectations."""
    structs = [gw.dispatch("net_get_attr", [gw.dispatch("get_net", [net_file, "train"])[0]])[0]
               for gw in GATEWAYS]
    (jf, jt), (tf, tt) = [([n for n, _ in s["fields"]], [v["t"] for _, v in s["fields"]])
                          for s in structs]
    assert tf == jf and tt == jt
    j, t = (_fields(s) for s in structs)
    for key in ("layer_names", "blob_names", "input_blob_indices", "output_blob_indices"):
        assert t[key] == j[key], key
    for key in ("hLayer_layers", "hBlob_blobs"):
        assert len(t[key]["v"]) == len(j[key]["v"])
        assert all(set(h) == {"ptr", "init_key"} for h in t[key]["v"])
    assert t["layer_names"]["v"] == ["data", "conv", "ip", "loss"]
    assert t["blob_names"]["v"] == ["data", "label", "conv", "ip", "loss"]
    assert t["input_blob_indices"]["v"] == [] and t["output_blob_indices"]["v"] == [4.0]


def test_blob_set_get_data_diff_and_reshape(net_file):
    """test_net.m::test_blob through both gateways: every result item
    equal, byte for byte."""
    results = []
    for gw in GATEWAYS:
        h = gw.dispatch("get_net", [net_file, "train"])[0]
        data_h = _blob(gw, _attr(gw, h), "data")
        out = [gw.dispatch("blob_get_shape", [data_h])[0]]
        tens = np.full((5, 2, 3, 4), 10.0, np.float32)
        gw.dispatch("blob_set_data", [data_h, _single(tens)])
        out.append(gw.dispatch("blob_get_data", [data_h])[0])
        gw.dispatch("blob_set_diff", [data_h, _single(-2.0 * np.ones_like(tens))])
        out.append(gw.dispatch("blob_get_diff", [data_h])[0])
        gw.dispatch("blob_reshape", [data_h, [6.0, 5.0, 4.0, 3.0, 2.0, 1.0]])
        out.append(gw.dispatch("blob_get_shape", [data_h])[0])
        gw.dispatch("blob_reshape", [data_h, out[0]["v"]])
        gw.dispatch("net_reshape", [h])
        out.append(gw.dispatch("blob_get_shape", [data_h])[0])
        results.append(out)
    assert results[1] == results[0]
    assert results[1][0]["v"] == [4.0, 3.0, 2.0, 5.0]
    assert results[1][3]["v"] == [6.0, 5.0, 4.0, 3.0, 2.0, 1.0]
    np.testing.assert_array_equal(_arr(results[1][2]), -2.0)


def test_layer_params_and_type(net_file, tmp_path):
    """test_net.m::test_layer: the shapes in MATLAB order and the type
    string equal; the param bytes equal once carried by .caffemodel (the
    port holds Caffe's layouts, the JAX gateway transposes its HWIO)."""
    nets = _carried_nets(net_file, tmp_path)
    for layer in ("conv", "ip"):
        (jb, tb) = [_param_handles(gw, attr, layer) for gw, _, attr in nets]
        assert len(tb) == len(jb) == 2
        for hj, ht in zip(jb, tb):
            assert (tgw.dispatch("blob_get_shape", [ht])[0]
                    == jgw.dispatch("blob_get_shape", [hj])[0])
            assert (tgw.dispatch("blob_get_data", [ht])[0]
                    == jgw.dispatch("blob_get_data", [hj])[0])
    (_, _, tattr) = nets[1]
    wsh, bsh = [tgw.dispatch("blob_get_shape", [h])[0]["v"]
                for h in _param_handles(tgw, tattr, "conv")]
    assert wsh == [2.0, 2.0, 2.0, 11.0] and bsh == [11.0]
    for gw, _, attr in nets:
        assert gw.dispatch("layer_get_type", [_layer(gw, attr, "conv")])[0]["v"] == "Convolution"


def test_forward_backward_prefilled(staged_file, tmp_path):
    """test_net.m::test_forward_backward on staged data and labels: the
    fill-once labels persist; the loss, the top blobs and the data diff
    agree within 16 ulps."""
    nets = _carried_nets(staged_file, tmp_path)
    _, labels = _stage(nets, np.random.RandomState(0))
    got = []
    for gw, h, attr in nets:
        gw.dispatch("net_forward", [h])
        np.testing.assert_array_equal(_get(gw, "blob_get_data", _blob(gw, attr, "label")), labels)
        fwd = {nm: _get(gw, "blob_get_data", _blob(gw, attr, nm)) for nm in ("conv", "ip", "loss")}
        gw.dispatch("net_backward", [h])
        fwd["data_diff"] = _get(gw, "blob_get_diff", _blob(gw, attr, "data"))
        fwd["ip_diff"] = _get(gw, "blob_get_diff", _blob(gw, attr, "ip"))
        got.append(fwd)
    for nm, want in got[0].items():
        assert np.isfinite(want).all() and np.abs(want).sum() > 0, nm
        assert_ulps(got[1][nm], want, nm)


def test_injected_output_diff_scales_gradients(staged_file, tmp_path):
    """Net.backward(output_diff): diffs staged on every output are the
    cotangents; 2x the seed gives 2x the data diff, in both gateways, and
    the two agree."""
    nets = _carried_nets(staged_file, tmp_path)
    _stage(nets, np.random.RandomState(1))
    got = []
    for gw, h, attr in nets:
        gw.dispatch("net_forward", [h])
        loss_h, data_h = _blob(gw, attr, "loss"), _blob(gw, attr, "data")
        gw.dispatch("blob_set_diff", [loss_h, _single(np.float32(1.0))])
        gw.dispatch("net_backward", [h])
        g1 = _get(gw, "blob_get_diff", data_h).copy()
        gw.dispatch("blob_set_diff", [loss_h, _single(np.float32(2.0))])
        gw.dispatch("net_backward", [h])
        g2 = _get(gw, "blob_get_diff", data_h)
        np.testing.assert_allclose(g2, 2.0 * g1, rtol=1e-5)
        got.append((g1, g2))
    assert_ulps(got[1][0], got[0][0], "seed 1")
    assert_ulps(got[1][1], got[0][1], "seed 2")


def test_save_and_copy_from(net_file, tmp_path):
    """test_net.m::test_save_and_read: the port's net_save read back by the
    port's copy_from and by the JAX gateway's, every param blob's bytes
    equal."""
    h1 = tgw.dispatch("get_net", [net_file, "train"])[0]
    wfile = str(tmp_path / "w.caffemodel")
    tgw.dispatch("net_save", [h1, wfile])
    readers = [(tgw, tgw.dispatch("get_net", [net_file, "train"])[0]),
               (jgw, jgw.dispatch("get_net", [net_file, "train"])[0])]
    a1 = _attr(tgw, h1)
    for gw, h2 in readers:
        gw.dispatch("net_copy_from", [h2, wfile])
        a2 = _attr(gw, h2)
        for layer in ("conv", "ip"):
            for hb1, hb2 in zip(_param_handles(tgw, a1, layer), _param_handles(gw, a2, layer)):
                assert (gw.dispatch("blob_get_data", [hb2])[0]
                        == tgw.dispatch("blob_get_data", [hb1])[0])


def test_param_set_data_writes_through(net_file):
    """A param blob written through its handle reads back the same bytes
    in both gateways, and reaches the port net's parameter (the next
    forward's weights)."""
    new_w = np.random.RandomState(1).randn(11, 2, 2, 2).astype(np.float32)
    for gw in GATEWAYS:
        h = gw.dispatch("get_net", [net_file, "train"])[0]
        w_h = _param_handles(gw, _attr(gw, h), "conv")[0]
        gw.dispatch("blob_set_data", [w_h, _single(new_w)])
        np.testing.assert_array_equal(_get(gw, "blob_get_data", w_h), new_w)
        if gw is tgw:
            ctx = tgw._deref(h, "net")
            np.testing.assert_array_equal(ctx.net._net.params["conv"]["w"].numpy(), new_w)


def _solver_file(tmp_path, net, max_iter):
    sfile = tmp_path / "solver.prototxt"
    sfile.write_text(f"""
        net: "{net}"
        test_iter: 2 test_interval: 5 base_lr: 0.01 momentum: 0.9
        weight_decay: 0.0005 lr_policy: "inv" gamma: 0.0001 power: 0.75
        display: 0 max_iter: {max_iter} snapshot_after_train: false
    """)
    return str(sfile)


def test_solver_step_solve_iter(staged_file, tmp_path):
    """test_solver.m: iter 0 -> step -> solve to max_iter, data and labels
    staged on the train and test nets, the JAX solver's weights carried to
    the port's by .caffemodel; the params after step(5) and after solve
    agree within 2e-5 of each blob's scale."""
    sfile = _solver_file(tmp_path, staged_file, 12)
    rng = np.random.RandomState(2)
    data = rng.randn(5, 2, 3, 4).astype(np.float32)
    labels = rng.randint(0, 13, (5, 1, 1, 1)).astype(np.float32)
    solvers = []
    weights = str(tmp_path / "init.caffemodel")
    for gw in GATEWAYS:
        hs = gw.dispatch("get_solver", [sfile])[0]
        f = _fields(gw.dispatch("solver_get_attr", [hs])[0])
        hnet, htest = f["hNet_net"]["v"][0], f["hNet_test_nets"]["v"]
        assert len(htest) == 1
        if gw is jgw:
            _tame(gw, _attr(gw, hnet), np.random.RandomState(7))
            gw.dispatch("net_save", [hnet, weights])
        else:
            gw.dispatch("net_copy_from", [hnet, weights])
        for hn in [hnet] + htest:
            nattr = _attr(gw, hn)
            gw.dispatch("blob_set_data", [_blob(gw, nattr, "data"), _single(data)])
            gw.dispatch("blob_set_data", [_blob(gw, nattr, "label"), _single(labels)])
        assert gw.dispatch("solver_get_iter", [hs])[0]["v"] == 0.0
        solvers.append((gw, hs, _attr(gw, hnet)))

    def params(gw, attr):
        return {(layer, i): _get(gw, "blob_get_data", hb) for layer in ("conv", "ip")
                for i, hb in enumerate(_param_handles(gw, attr, layer))}

    for run, want_iter in ((lambda gw, hs: gw.dispatch("solver_step", [hs, 5.0]), 5.0),
                           (lambda gw, hs: gw.dispatch("solver_solve", [hs]), 12.0)):
        got = []
        for gw, hs, attr in solvers:
            run(gw, hs)
            assert gw.dispatch("solver_get_iter", [hs])[0]["v"] == want_iter
            got.append(params(gw, attr))
        for key, want in got[0].items():
            scale = max(float(np.abs(want).max()), 1e-30)
            d = float(np.abs(got[1][key] - want).max())
            assert d <= RTOL * scale, f"iter {want_iter} {key}: |d| {d:.3g} at scale {scale:.3g}"


def test_read_write_mean_roundtrip(tmp_path):
    """test_io.m::test_read_write_mean, across packages both ways: each
    gateway reads the other's file to the same bytes."""
    mean = (255 * np.random.RandomState(3).rand(3, 30, 20)).astype(np.float32)
    for writer, reader in ((tgw, jgw), (jgw, tgw), (tgw, tgw)):
        mfile = str(tmp_path / f"{writer.__name__}.binaryproto")
        writer.dispatch("write_mean", [_single(mean), mfile])
        got = reader.dispatch("read_mean", [mfile])[0]
        assert got["dims"] == [20, 30, 3]  # W x H x C, trailing num squeezed
        assert got == jgw.dispatch("read_mean", [mfile])[0]
        np.testing.assert_array_equal(_arr(got).reshape(mean.shape), mean)


def test_reset_invalidates_handles(net_file):
    h = tgw.dispatch("get_net", [net_file, "train"])[0]
    (k1,) = tgw.dispatch("get_init_key", [])
    (msg,) = tgw.dispatch("reset", [])
    assert msg["t"] == "print" and "stand-alone nets" in msg["v"]
    assert msg == jgw.dispatch("reset", [])[0] or "Cleared" in msg["v"]
    (k2,) = tgw.dispatch("get_init_key", [])
    assert k1["v"] != k2["v"]
    with pytest.raises(ValueError, match="init_key"):
        tgw.dispatch("net_forward", [h])


def test_version_and_unknown_command_and_bad_phase(net_file):
    """version names the port; an unknown command and a bad phase raise
    as in the JAX gateway; the device commands choose the build device
    (set_mode_cpu -> cpu, set_device(i) -> cuda:i); with no command the
    gateway builds on cuda:0 (read in a fresh interpreter; nothing is
    built there, so nothing launches)."""
    (v,) = tgw.dispatch("version", [])
    assert "caffe 1.0.0-rc3" in v["v"] and "deepcut_tpu_torch" in v["v"]
    for gw in GATEWAYS:
        with pytest.raises(ValueError, match="Unknown command"):
            gw.dispatch("no_such_cmd", [])
        with pytest.raises(ValueError, match="Unknown phase"):
            gw.dispatch("get_net", [net_file, "deploy"])
    tgw.dispatch("set_mode_cpu", [])
    assert tgw.device() == "cpu"
    h = tgw.dispatch("get_net", [net_file, "test"])[0]
    assert str(tgw._deref(h, "net").net._net.device) == "cpu"
    tgw.dispatch("set_device", [1.0])
    assert tgw.device() == "cuda:1"
    tgw.dispatch("set_device", [0.0])
    assert tgw.device() == "cuda:0"
    proc = subprocess.run(
        [sys.executable, "-c",
         "import deepcut_tpu_torch.matlab_gateway as g, torch; "
         "print(g.device(), torch.cuda.is_initialized())"],
        capture_output=True, text=True, timeout=120, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["cuda:0", "False"]
