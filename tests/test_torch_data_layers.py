"""The port's data slice (`deepcut_tpu_torch.data`: the stores, Datum, the
transformer and every data-layer source) against the JAX package's on the
CPU, on the same seeded numpy data.

- Stores: bytes written by one package are read by the other (LMDB, and
  LevelDB in its log and table modes), and both writers lay down the same
  bytes; a flipped payload byte fails the LevelDB crc either way.
- Datum and the transformer: the same bytes and the same arrays, the
  transformer's crop and mirror drawn from the same RandomState in the
  same order (mean first, then crop, mirror in any phase, then scale).
- Every source's first three batches are bit-equal through both packages'
  `Net.forward` (Data on LMDB and LevelDB with a mean file, crop and
  mirror; ImageData with shuffle, resize and rand_skip; WindowData with
  context padding; HDF5Data; PoseData), and HDF5Output writes the same
  file. Tolerance: none, the data tops are compared bit for bit.
- Prefetch threads are daemons and stop; the HDF5 paths raise ImportError
  naming h5py where it is missing.
"""

import os
import sys

import numpy as np
import pytest
from PIL import Image

from deepcut_tpu.core.graph import Net as JNet
from deepcut_tpu.data import datum as j_datum
from deepcut_tpu.data import layers as j_layers
from deepcut_tpu.data import leveldb_store as j_ldb
from deepcut_tpu.data import lmdb_store as j_lmdb
from deepcut_tpu.data import transformer as j_tf
from deepcut_tpu.proto import text_format as j_text
from deepcut_tpu_torch.core.graph import LayerSpec, Net
from deepcut_tpu_torch.data import datum as t_datum
from deepcut_tpu_torch.data import layers as t_layers
from deepcut_tpu_torch.data import leveldb_store as t_ldb
from deepcut_tpu_torch.data import lmdb_store as t_lmdb
from deepcut_tpu_torch.data import transformer as t_tf
from deepcut_tpu_torch.io import array_to_blobproto_bytes
from deepcut_tpu_torch.proto import text_format as t_text

STORES = {"lmdb": (j_lmdb.LMDBWriter, j_lmdb.LMDBReader, t_lmdb.LMDBWriter, t_lmdb.LMDBReader),
          "leveldb": (j_ldb.LevelDBWriter, j_ldb.LevelDBReader,
                      t_ldb.LevelDBWriter, t_ldb.LevelDBReader)}


def _items(seed=0, n=300, big=90000):
    """Keys and values that force LMDB's branch and overflow pages and
    LevelDB's FIRST / MIDDLE / LAST fragments."""
    rng = np.random.RandomState(seed)
    items = {f"k{i:06d}".encode(): rng.bytes(int(rng.randint(10, 400))) for i in range(n)}
    items[b"zz_big"] = rng.bytes(big)
    return items


def _files(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("store", ["lmdb", "leveldb-log", "leveldb-table"])
def test_store_bytes_cross_packages(tmp_path, store, writer):
    kind, _, mode = store.partition("-")
    jw, jr, tw, tr = STORES[kind]
    items = _items()
    kw = {"mode": mode} if mode else {}
    paths = {}
    for who, w in (("port", tw), ("jax", jw)):
        paths[who] = str(tmp_path / who)
        with w(paths[who], **kw) as out:
            for k, v in items.items():
                out.put(k, v)
    assert _files(paths["port"]) == _files(paths["jax"])  # the same bytes on disk
    reader = jr if writer == "port" else tr
    got = reader(paths[writer])
    assert len(got) == len(items)
    assert dict(got.items()) == items
    assert [k for k, _ in got.items()] == sorted(items)   # the cursor's key order
    assert got.get(b"k000007") == items[b"k000007"]


@pytest.mark.parametrize("reader", [j_ldb.LevelDBReader, t_ldb.LevelDBReader],
                         ids=["jax-reads", "port-reads"])
def test_leveldb_crc_failure_both_ways(tmp_path, reader):
    path = str(tmp_path / "ldb")
    with t_ldb.LevelDBWriter(path) as w:
        w.put(b"k", b"v" * 100)
    logf = os.path.join(path, "000003.log")
    buf = bytearray(open(logf, "rb").read())
    buf[40] ^= 0xFF  # a payload byte
    open(logf, "wb").write(bytes(buf))
    with pytest.raises(ValueError, match="crc"):
        reader(path)


def test_leveldb_deletion_and_overwrite_semantics(tmp_path):
    """Later sequence numbers shadow earlier ones, deletions hide values
    (tests/test_data_layers.py's case), through the port's reader."""
    path = str(tmp_path / "db")
    os.makedirs(path)
    log = t_ldb.LogWriter()
    log.add_record(t_ldb.encode_batch(1, [(t_ldb.TYPE_VALUE, b"a", b"old")]))
    log.add_record(t_ldb.encode_batch(2, [(t_ldb.TYPE_VALUE, b"a", b"new"),
                                          (t_ldb.TYPE_VALUE, b"b", b"gone")]))
    log.add_record(t_ldb.encode_batch(4, [(t_ldb.TYPE_DELETION, b"b", b"")]))
    with open(os.path.join(path, "000003.log"), "wb") as f:
        f.write(log.data())
    mlog = t_ldb.LogWriter()
    mlog.add_record(t_ldb.encode_version_edit(log_number=3, next_file=4, last_seq=4))
    with open(os.path.join(path, "MANIFEST-000002"), "wb") as f:
        f.write(mlog.data())
    with open(os.path.join(path, "CURRENT"), "w") as f:
        f.write("MANIFEST-000002\n")
    assert dict(t_ldb.LevelDBReader(path).items()) == dict(j_ldb.LevelDBReader(path).items()) \
        == {b"a": b"new"}


def test_datum_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    u8 = rng.randint(0, 255, (3, 8, 6), np.uint8)
    f32 = rng.randn(2, 4, 4).astype(np.float32)
    for arr, label in ((u8, 7), (f32, 1)):
        buf = t_datum.Datum.from_array(arr, label=label).encode()
        assert buf == j_datum.Datum.from_array(arr, label=label).encode()
        got, want = t_datum.Datum.decode(buf), j_datum.Datum.decode(buf)
        assert got.label == want.label == label
        np.testing.assert_array_equal(got.to_array(), want.to_array())
    # an encoded (PNG) datum decodes to the same BGR pixels
    png = tmp_path / "x.png"
    Image.fromarray(u8.transpose(1, 2, 0)).save(png)
    enc = j_datum.Datum.from_image_file(str(png), label=3, encoded=True).encode()
    assert enc == t_datum.Datum.from_image_file(str(png), label=3, encoded=True).encode()
    np.testing.assert_array_equal(t_datum.Datum.decode(enc).to_array(),
                                  j_datum.Datum.decode(enc).to_array())


@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
@pytest.mark.parametrize("mean", ["file", "value"])
def test_transformer_matches_jax(tmp_path, phase, mean):
    rng = np.random.RandomState(1)
    mean_blob = rng.uniform(0, 255, (1, 3, 10, 12)).astype(np.float32)
    (tmp_path / "mean.binaryproto").write_bytes(array_to_blobproto_bytes(mean_blob))
    meanp = (f'mean_file: "{tmp_path}/mean.binaryproto"' if mean == "file"
             else "mean_value: 104 mean_value: 117 mean_value: 123")
    text = f"crop_size: 7\nmirror: true\nscale: 0.25\n{meanp}"
    t = t_tf.DataTransformer(t_text.parse(text), phase)
    j = j_tf.DataTransformer(j_text.parse(text), phase)
    for _ in range(6):   # six draws of crop offsets and mirror flags
        x = rng.randint(0, 255, (3, 10, 12)).astype(np.float32)
        np.testing.assert_array_equal(t(x), j(x))
    assert t.rng.randint(1 << 30) == j.rng.randint(1 << 30)   # the same number of draws


# -- the sources through both packages' Net -------------------------------------------
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """24 seeded 20x24 PNG frames in 3 classes, their list file, LMDB and
    LevelDB stores of their Datums, a mean blob, an R-CNN window file, two
    HDF5 files, and a DeeperCut window file of 3 annotated frames."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(0)
    lines = []
    for i in range(24):
        p = root / f"f{i:02d}.png"
        Image.fromarray(rng.randint(0, 256, (20, 24, 3), np.uint8)).save(p)
        lines.append(f"{p} {i % 3}")
    (root / "list.txt").write_text("\n".join(lines) + "\n")
    from deepcut_tpu.tools.datasets import main as j_datasets

    for backend in ("lmdb", "leveldb"):
        assert j_datasets(["convert_imageset", str(root / "list.txt"), str(root / backend),
                           "--backend", backend]) == 0
    assert j_datasets(["compute_image_mean", str(root / "lmdb"),
                       str(root / "mean.binaryproto")]) == 0
    win = []
    for i in range(6):
        win.append(f"# {i}\n{root}/f{i:02d}.png\n3 20 24\n3\n"
                   f"{1 + i % 3} 0.8 2 3 15 17\n0 0.1 0 0 9 9\n{1 + i % 2} 0.6 -4 6 30 19")
    (root / "windows.txt").write_text("\n".join(win) + "\n")
    import h5py

    h5s = []
    for i in range(2):
        h5 = root / f"d{i}.h5"
        with h5py.File(h5, "w") as f:
            f["data"] = rng.rand(5, 2, 4, 4).astype(np.float32)
            f["label"] = np.arange(5 * i, 5 * i + 5, dtype=np.float32)
        h5s.append(str(h5))
    (root / "h5list.txt").write_text("\n".join(h5s) + "\n")
    from test_torch_cli import write_dataset

    (root / "pose").mkdir()
    write_dataset(root / "pose", n=3, h=120, w=144)
    return root


def source_layer(kind, root):
    """One data layer of each kind, as the example recipes write them."""
    tp = (f'transform_param {{ crop_size: 16 mirror: true mean_file: "{root}/mean.binaryproto" '
          'scale: 0.5 }')
    if kind in ("lmdb", "leveldb", "detect"):
        backend = {"lmdb": "backend: LMDB", "leveldb": "backend: LEVELDB", "detect": ""}[kind]
        src = root / ("leveldb" if kind == "detect" else kind)
        return (f'layer {{ name: "d" type: "Data" top: "data" top: "label" '
                f'data_param {{ source: "{src}" batch_size: 10 {backend} }} {tp} }}')
    if kind == "image":
        return ('layer { name: "d" type: "ImageData" top: "data" top: "label" '
                f'image_data_param {{ source: "{root}/list.txt" batch_size: 10 shuffle: true '
                'new_height: 22 new_width: 26 rand_skip: 7 } '
                'transform_param { crop_size: 16 mirror: true mean_value: 104 mean_value: 117 '
                'mean_value: 123 } }')
    if kind == "window":
        return ('layer { name: "d" type: "WindowData" top: "data" top: "label" '
                f'window_data_param {{ source: "{root}/windows.txt" batch_size: 8 '
                'fg_threshold: 0.5 bg_threshold: 0.5 fg_fraction: 0.25 context_pad: 3 } '
                f'transform_param {{ crop_size: 12 mirror: true mean_file: "{root}/mean.binaryproto" }} }}')
    if kind == "hdf5":
        return ('layer { name: "d" type: "HDF5Data" top: "data" top: "label" '
                f'hdf5_data_param {{ source: "{root}/h5list.txt" batch_size: 4 shuffle: true }} }}')
    assert kind == "pose"
    return ('layer { name: "d" type: "PoseData" top: "data" top: "part_score_targets" '
            'top: "part_score_weights" top: "locref_targets" top: "locref_weights" '
            f'pose_data_param {{ source: "{root}/pose/train_index.txt" batch_size: 2 '
            'num_classes: 14 scale: 0.8 scale_jitter_lo: 0.85 scale_jitter_up: 1.15 '
            'fg_threshold: 17 no_bg_class: true weight_targets: true location_refinement: true '
            'max_input_size: 700 cycle_training_data: true } }')


KINDS = ["lmdb", "leveldb", "detect", "image", "window", "hdf5", "pose"]


@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
@pytest.mark.parametrize("kind", KINDS)
def test_first_three_batches_bit_equal(corpus, kind, phase):
    if kind == "hdf5":
        pytest.importorskip("h5py")
    text = f'name: "src"\n{source_layer(kind, corpus)}\n'
    port = Net(t_text.parse(text), phase=phase, compute_dtype=None, device="cpu")
    jx = JNet(j_text.parse(text), phase=phase, compute_dtype=None)
    try:
        for _ in range(3):
            got, want = port.forward(), jx.forward()
            tops = port.data_sources["d"].tops
            assert [t for t in tops if t in got] == tops
            for top in tops:
                assert got[top].dtype == np.float32
                np.testing.assert_array_equal(got[top], want[top], err_msg=top)
    finally:
        port.close()
        for src in jx.data_sources.values():
            src.stop()
    # the port stopped its prefetch thread
    assert port.data_sources["d"]._pf is None


def test_data_layer_cursor_wraps_and_detects_backends(corpus, tmp_path):
    """The cursor wraps at the end of the store (24 items, batches of 10),
    and with no `backend` a store is recognised by CURRENT (LevelDB) or
    data.mdb (LMDB)."""
    seen = []
    for kind in ("lmdb", "leveldb"):
        node = t_text.parse(
            f'layer {{ name: "d" type: "Data" top: "data" top: "label" data_param {{ '
            f'source: "{corpus / kind}" batch_size: 10 }} }}').get_list("layer")[0]
        src = t_layers.LMDBDataSource(LayerSpec(node), "TEST")
        want = "LevelDBReader" if kind == "leveldb" else "LMDBReader"
        assert type(src.reader).__name__ == want
        labels = np.concatenate([src.next_batch()[1] for _ in range(3)])
        np.testing.assert_array_equal(labels, [i % 3 for i in range(30)])
        seen.append(labels)
    np.testing.assert_array_equal(*seen)


def test_image_data_reshuffle_and_rand_skip_match_jax(corpus):
    text = (f'layer {{ name: "d" type: "ImageData" top: "data" top: "label" '
            f'image_data_param {{ source: "{corpus}/list.txt" batch_size: 24 shuffle: true }} }}')
    t = t_layers.ImageDataSource(LayerSpec(t_text.parse(text).get_list("layer")[0]), "TRAIN")
    j = j_layers.ImageDataSource(j_layers_spec(text), "TRAIN")
    l1, l2 = t.next_batch()[1], t.next_batch()[1]
    np.testing.assert_array_equal(l1, j.next_batch()[1])
    np.testing.assert_array_equal(l2, j.next_batch()[1])
    assert l1.tolist() != l2.tolist()   # the wrap reshuffled the list
    text = text.replace("shuffle: true", "rand_skip: 5")
    t = t_layers.ImageDataSource(LayerSpec(t_text.parse(text).get_list("layer")[0]), "TRAIN")
    j = j_layers.ImageDataSource(j_layers_spec(text), "TRAIN")
    assert t.pos == j.pos and 0 < t.pos < 5   # skipped into the list


def j_layers_spec(text):
    from deepcut_tpu.core.graph import LayerSpec as JSpec

    return JSpec(j_text.parse(text).get_list("layer")[0])


@pytest.mark.parametrize("crop_mode", ["warp", "square"])
def test_window_data_geometry_matches_jax(corpus, crop_mode):
    """The context-pad clip / scaled-pad geometry and the square crop mode
    (window_data_layer.cpp:307-397), bg quota first: the same pixels."""
    text = ('layer { name: "w" type: "WindowData" top: "data" top: "label" '
            f'window_data_param {{ source: "{corpus}/windows.txt" batch_size: 6 '
            f'fg_fraction: 0.5 context_pad: 4 crop_mode: "{crop_mode}" cache_images: true }} '
            'transform_param { crop_size: 24 mirror: true mean_value: 100 } }')
    t = t_layers.WindowDataSource(LayerSpec(t_text.parse(text).get_list("layer")[0]), "TRAIN")
    j = j_layers.WindowDataSource(j_layers_spec(text), "TRAIN")
    for _ in range(2):
        (td, tl), (jd, jl) = t.next_batch(), j.next_batch()
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
        assert list(tl[:3]) == [0.0, 0.0, 0.0] and all(v > 0 for v in tl[3:])


def test_hdf5_output_writes_what_jax_writes(corpus, tmp_path):
    h5py = pytest.importorskip("h5py")
    files = {}
    for who, net_cls, text_mod in (("port", Net, t_text), ("jax", JNet, j_text)):
        files[who] = str(tmp_path / f"{who}.h5")
        text = (f'{source_layer("hdf5", corpus)}\n'
                'layer { name: "abs" type: "AbsVal" bottom: "data" top: "abs" }\n'
                'layer { name: "sink" type: "HDF5Output" bottom: "abs" bottom: "label" '
                f'hdf5_output_param {{ file_name: "{files[who]}" }} }}')
        kw = {"device": "cpu"} if who == "port" else {}
        net = net_cls(text_mod.parse(text), phase="TEST", compute_dtype=None, **kw)
        for _ in range(3):
            net.forward()
        net.hdf5_sinks[0].save()
        for src in net.data_sources.values():
            src.stop()
    with h5py.File(files["port"], "r") as a, h5py.File(files["jax"], "r") as b:
        assert sorted(a) == sorted(b) == ["data", "label"]
        assert a["data"].shape == (12, 2, 4, 4)
        for k in a:
            np.testing.assert_array_equal(a[k][:], b[k][:])


def test_prefetch_thread_is_a_daemon_and_stops():
    """FIFO order equals the synchronous cursor; the producer is a daemon
    thread, and close() ends it within a bounded wait."""
    class Counter(t_layers.DataLayerSource):
        tops = ["data"]

        def __init__(self):
            self.i = 0

        def next_batch(self):
            self.i += 1
            return [np.full((1,), self.i, np.float32)]

    src = t_layers.PrefetchedSource(Counter())
    assert [int(src.next_batch()[0][0]) for _ in range(10)] == list(range(1, 11))
    thread = src._pf._thread
    assert thread.daemon and thread.is_alive()
    src.close()
    thread.join(timeout=10)
    assert not thread.is_alive()
    assert src._pf is None


def test_hdf5_paths_name_h5py_where_it_is_missing(corpus, tmp_path, monkeypatch):
    """Where h5py is missing (the card's machine) each HDF5 path raises
    ImportError naming it, and nothing else breaks."""
    from deepcut_tpu_torch.proto.caffemodel import save_hdf5_weights
    from deepcut_tpu_torch.tools import cli

    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        Net(t_text.parse(source_layer("hdf5", corpus)), device="cpu")
    with pytest.raises(ImportError, match="h5py"):
        save_hdf5_weights(str(tmp_path / "w.h5"), {"ip": {"w": np.ones((2, 3), np.float32)}})
    net = Net(t_text.parse(
        'input: "x" input_shape { dim: 1 dim: 2 }\n'
        'layer { name: "s" type: "HDF5Output" bottom: "x" '
        f'hdf5_output_param {{ file_name: "{tmp_path}/o.h5" }} }}'), device="cpu")
    net.forward(x=np.ones((1, 2), np.float32))
    with pytest.raises(ImportError, match="h5py"):
        net.hdf5_sinks[0].save()
    (tmp_path / "m.prototxt").write_text('input: "x" input_shape { dim: 1 dim: 2 }\n'
                                         'layer { name: "a" type: "AbsVal" bottom: "x" top: "a" }')
    with pytest.raises(ImportError, match="h5py"):
        cli.main(["extract_features", "-model", str(tmp_path / "m.prototxt"), "-blobs", "a",
                  "-out", str(tmp_path / "f.h5"), "-device", "cpu"])
    assert not os.path.exists(tmp_path / "f.h5")
