"""Command-line front end of the port: train / test / time / device_query /
extract_features / upgrade_*.

    python -m deepcut_tpu_torch.tools.cli train -solver SOLVER.prototxt \\
        [-weights X.caffemodel] [-snapshot S.npz|S.solverstate] [-mixed_precision] [-remat] \\
        [-augment_device] [-host_targets] [-device cuda]
    torchrun --nproc_per_node N -m deepcut_tpu_torch.tools.cli train -solver S -mesh N
    python -m deepcut_tpu_torch.tools.cli test -model NET.prototxt [-weights X.caffemodel] \\
        [-iterations 50] [-fp32] [-device cuda]
    python -m deepcut_tpu_torch.tools.cli time -model NET.prototxt [-iterations 10] \\
        [-fold_bn] [-fp32] [-per_layer] [-trace DIR] [-device cuda]
    python -m deepcut_tpu_torch.tools.cli extract_features -model NET.prototxt -blobs a,b \\
        -out F.h5 [-weights X.caffemodel] [-iterations 10] [-fp32] [-device cuda]
    python -m deepcut_tpu_torch.tools.cli upgrade_net_proto OLD.prototxt NEW.prototxt
    python -m deepcut_tpu_torch.tools.cli upgrade_net_proto_binary OLD.caffemodel NEW.caffemodel
    python -m deepcut_tpu_torch.tools.cli upgrade_solver_proto OLD.prototxt NEW.prototxt
    python -m deepcut_tpu_torch.tools.cli device_query

Counterpart of `deepcut_tpu.tools.cli` (tools/caffe.cpp's brew verbs).

`train`, for solvers whose net has a PoseData layer: the layer's
pose_data_param configures the targets and the data source
(`data.pipeline.PoseDataSource`, uint8 canvases, compact annotations
rasterized on the device unless -host_targets), the ResNet trunk is built
natively, and `solver.solver.PoseSolver` trains it on one device. Any other
solver trains its prototxt net through the graph engine
(`solver.solver.GraphSolver`), finetuning from -weights (a comma-separated
list of .caffemodel files, copied by layer name in order) or resuming from
-snapshot (a .npz or a .solverstate); its nets are fed by their data
layers (Data on LMDB or LevelDB, ImageData, HDF5Data, WindowData,
MemoryData, DummyData) or Input tops. -mesh N trains data-parallel over
N GPUs, one process each under torchrun (WORLD_SIZE must equal N): the
solver's batch is the global batch, each rank trains on its rows, the
gradients are summed over the ranks, rank 0 logs and writes the
snapshots (`parallel.mesh`). -mesh N -spatial S lays the N ranks out as
(N / S data rows) x (S row shards): each rank also trains on its block of
the image rows, with halo exchange between the shards (the pose trainer:
`parallel.spatial`, canvases bucketed to max(64, 32 * S) rows so that H %
16S == 0 and H >= 32S; -augment_device is ignored there, as in the JAX
package; a graph net: `parallel.graph_spatial`, its rows sharded up to
the first layer that cannot shard). Precision: the reference trains in
pure f32, and cuDNN's default TF32 is not f32, so f32 training turns TF32
off for cuDNN and matmuls and says so in its first log line;
-mixed_precision (bf16 convs, f32 params, losses and updates) is the
DeeperCut fast path.

`test`, `time` and `extract_features` build the graph engine's
`core.graph.Net` (TEST phase) from a prototxt with data layers or declared
inputs, and run its stream `Net.make_forward`: bf16 from the inputs to the
outputs, each convolution and InnerProduct ending in the hand-written
`conv_epilogue` kernel, or f32 (TF32 off) with -fp32. The JAX package's
`test` runs `Net.forward` instead (bf16 operands, f32 blobs, every blob to
the host): the port reports the same outputs within bf16 roundings, and
copies to the host only the blobs it reports. `test` feeds it the data
layers' batches (seeded random inputs for a deploy net) and prints each
output's mean over the iterations (tools/caffe.cpp:229-298).
`extract_features` writes the named blobs of every iteration to an HDF5
file, one dataset per blob (tools/extract_features.cpp; h5py needed).
`time` times the same forward (-fold_bn folds BatchNorm and casts the
weights first) on one staged batch with CUDA events on the card (the host
clock on the CPU);
-per_layer times each layer alone on the staged stream, -trace writes a
`torch.profiler` trace, which carries the graph engine's spans
(``graph.forward`` around each forward, ``graph.<layer>`` around each
layer). The upgrade verbs rewrite legacy V0 / V1 net
definitions, legacy binary NetParameters and legacy solver enums in the
current form. The reference's deprecated tools (train_net, finetune_net,
test_net, net_speed_benchmark) print its warning and run their verb.
"""

from __future__ import annotations

import argparse
import os
import sys
import time as _time
from typing import Dict, List, Optional

import numpy as np

from deepcut_tpu_torch.data.pipeline import PoseDataSource, Prefetcher
from deepcut_tpu_torch.data.window_file import parse_stats_file
from deepcut_tpu_torch.pose.targets import TargetConfig
from deepcut_tpu_torch.proto import text_format

ENGINE_MESSAGE = ("the solver's net has no PoseData layer: a generic prototxt net trains "
                  "through solver.solver.GraphSolver (the train verb runs it)")


def _target_config_from_layer(node) -> "TargetConfig":
    pp = node.get("pose_data_param")
    if pp is None:
        raise ValueError("train net has no PoseData layer")
    kw = dict(
        num_classes=pp.get_int("num_classes", 14),
        scale=pp.get_float("scale", 1.0),
        fg_threshold=pp.get_float("fg_threshold", 17.0),
        soft_labels=pp.get_bool("soft_labels", False),
        gauss_blob_sigma=pp.get_float("gauss_blob_sigma", 10.0),
        multi_label=pp.get_bool("multi_label", False),
        no_bg_class=pp.get_bool("no_bg_class", False),
        location_refinement=pp.get_bool("location_refinement", False),
        regress_to_other=pp.get_bool("regress_to_other", False),
        weight_targets=pp.get_bool("weight_targets", False),
        max_input_size=pp.get_int("max_input_size", 700),
    )
    if pp.has("scale_jitter_lo") and pp.has("scale_jitter_up"):
        kw["scale_jitter_lo"] = pp.get_float("scale_jitter_lo")
        kw["scale_jitter_up"] = pp.get_float("scale_jitter_up")
    if pp.has("fg_fraction"):
        kw["fg_fraction"] = pp.get_float("fg_fraction")
    if pp.has("bg_threshold"):
        kw["bg_threshold"] = pp.get_float("bg_threshold")
    return TargetConfig(**kw), pp


def _pose_data_layer(sp):
    """The PoseData layer node of the solver's train net, or None."""
    model_def, _stages, _level = sp.resolve_train_net()
    net_proto = model_def if not isinstance(model_def, str) else text_format.parse_file(model_def)
    return next((layer for layer in net_proto.get_list("layer")
                 if layer.get_str("type") == "PoseData"), None)


def _tf32_off() -> None:
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("f32 training: TF32 off for cuDNN convolutions and matmuls "
          "(the reference trains in full f32; -mixed_precision is the fast path)")


def train_graph(args, sp, mesh=None) -> int:
    """`train` for a solver without a PoseData layer: GraphSolver over its
    prototxt net (caffe.cpp train with the generic net)."""
    from deepcut_tpu_torch.solver.solver import GraphSolver

    _tf32_off()
    solver = GraphSolver(sp, mesh=mesh, sigint_effect=args.sigint_effect,
                         sighup_effect=args.sighup_effect,
                         device=None if mesh is not None else args.device)
    if args.weights:
        # finetune: matching layers by name, file by file (caffe.cpp CopyLayers)
        for w in args.weights.split(","):
            solver.net.load_weights(w)
    if args.snapshot:
        solver.restore(args.snapshot)
    solver.solve()
    return 0


def pose_data(sp, *, workers: int = 4, host_targets: bool = False,
              augment_device: bool = False, bucket_step: int = 64):
    """The PoseData layer of a solver's train net -> ``(target_cfg,
    joint_stats, source, pose_data_param)``: the `TargetConfig`, the joint
    pair stats (None without ``joint_pairs_stats``) and a `PoseDataSource`
    of uint8 canvases with compact annotations for the device rasterizer
    (dense host maps with host_targets), seeded by the solver's
    random_seed, canvases bucketed to `bucket_step`. Close the source when
    done."""
    data_layer = _pose_data_layer(sp)
    if data_layer is None:
        raise NotImplementedError(ENGINE_MESSAGE)
    tcfg, pp = _target_config_from_layer(data_layer)
    stats = parse_stats_file(pp.get_str("joint_pairs_stats")) if pp.get_str("joint_pairs_stats") else None
    source = PoseDataSource(
        pp.get_str("source"), tcfg, stats,
        root_folder=pp.get_str("root_folder", ""),
        cycle=pp.get_bool("cycle_training_data", False),
        bucket_step=bucket_step,
        # random_seed < 0 = unseeded (solver.cpp:53-54)
        seed=(sp.random_seed if sp.random_seed >= 0
              else int.from_bytes(os.urandom(4), "little")),
        workers=max(workers, 0),
        uint8_images=True,
        device_targets=not host_targets,
        augment_device=augment_device,
    )
    return tcfg, stats, source, pp


def _train_mesh(args):
    """-mesh N [-spatial S]: this process's rank of the torchrun job (its
    process group joined on its card, or the CPU with -device cpu) -> the
    (N / S) x S ('data', 'spatial') mesh; None without -mesh."""
    if args.spatial < 1 or (args.spatial > 1 and not args.mesh):
        raise ValueError(f"-spatial {args.spatial} shards image rows over the ranks of a mesh: "
                         f"pass -mesh N (N = data x {args.spatial} ranks, under torchrun)")
    if not args.mesh:
        return None
    from deepcut_tpu_torch.parallel import distributed
    from deepcut_tpu_torch.parallel.mesh import make_mesh

    device = distributed.initialize(device="cpu" if args.device == "cpu" else "cuda")
    return make_mesh(args.mesh, spatial=args.spatial, device=device)


def train(args) -> int:
    from deepcut_tpu_torch.parallel import distributed

    mesh = _train_mesh(args)
    try:
        return _train(args, mesh)
    finally:
        if mesh is not None:
            distributed.shutdown()


def _train(args, mesh) -> int:
    import torch

    from deepcut_tpu_torch.models.resnet import deepercut_config, init_params
    from deepcut_tpu_torch.parallel.mesh import broadcast_int
    from deepcut_tpu_torch.solver.solver import PoseSolver, SolverParams

    sp = SolverParams.from_prototxt(args.solver)
    try:
        sp.resolve_train_net()
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    if mesh is not None and sp.random_seed < 0:
        # every rank pulls the same global batches: one seed, drawn on rank 0
        sp.random_seed = broadcast_int(mesh, int.from_bytes(os.urandom(4), "little") >> 1)
    if _pose_data_layer(sp) is None:
        return train_graph(args, sp, mesh)
    spatial = mesh.spatial if mesh is not None else 1
    if args.augment_device and spatial > 1:
        print(f"-augment_device is ignored with -spatial {spatial}: the host warps the canvases")
    # the spatial step needs canvas H % (16 * S) == 0 and H >= 32 * S
    # (parallel.spatial.check_spatial_shapes): buckets of 32 * S give both
    tcfg, stats, source, pp = pose_data(sp, workers=args.data_workers,
                                        host_targets=args.host_targets,
                                        augment_device=args.augment_device and spatial == 1,
                                        bucket_step=max(64, 32 * spatial))
    if args.mixed_precision:
        print("mixed precision: bf16 convolutions, f32 params, losses and updates")
    else:
        _tf32_off()
    model_cfg = deepercut_config(
        args.resnet, num_joints=tcfg.num_classes,
        location_refinement=tcfg.location_refinement, pairwise=tcfg.regress_to_other,
        mixed_train=args.mixed_precision, remat=args.remat)
    batch_size = args.batch_size or pp.get_int("batch_size", 1)
    prefetch = Prefetcher(lambda: source.next_batch(batch_size), depth=3)
    try:
        net_params = None
        if args.weights:
            # finetune: the file's layers over a fresh init; layers the file
            # lacks (new heads) keep the init
            from deepcut_tpu_torch.models.convert import load_caffemodel

            net_params = init_params(torch.Generator().manual_seed(0), model_cfg)
            loaded = load_caffemodel(args.weights)
            net_params.update({k: v for k, v in loaded.items() if k in net_params})
        solver = PoseSolver(
            sp, model_cfg, prefetch.get, net_params=net_params,
            target_cfg=None if args.host_targets else tcfg,
            target_stats=None if args.host_targets else stats,
            sigint_effect=args.sigint_effect, sighup_effect=args.sighup_effect,
            mesh=mesh, device=None if mesh is not None else args.device)
        if args.snapshot:
            solver.restore(args.snapshot)
        solver.solve()
    finally:
        prefetch.stop()
        source.close()
    return 0


def device_query(args) -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card is visible: the port runs on the CPU only with -device cpu")
        return 0
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        print(f"Device id:   {i}")
        print(f"  name:      {p.name}")
        print(f"  compute:   sm_{p.major}{p.minor}, {p.multi_processor_count} SMs")
        print(f"  memory:    {p.total_memory / 2**30:.2f} GiB")
    return 0


def _graph_net(args, **kw):
    import torch

    from deepcut_tpu_torch.core.graph import Net

    return Net(args.model, weights=args.weights or None, phase="TEST",
               compute_dtype=None if args.fp32 else torch.bfloat16, device=args.device, **kw)


def _forwards(net, iterations: int, outputs: Optional[List[str]] = None):
    """`iterations` forwards of a TEST net through its stream
    (`Net.make_forward`: bf16 through the convs' epilogue kernel, or f32
    with -fp32), each giving `outputs` (default: the net's outputs) as
    host arrays. Its data layers advance themselves; a deploy net takes
    seeded random inputs."""
    import torch

    net.materialize_params()
    fwd = net.make_forward(outputs)
    rng = np.random.RandomState(0)
    try:
        for _ in range(iterations):
            inputs: Dict[str, np.ndarray] = {nm: rng.randn(*sh).astype(np.float32)
                                             for nm, sh in net.input_shapes.items()}
            net._pull_data_layers(inputs)
            yield {nm: v.cpu().numpy() for nm, v in fwd(net.params, {
                nm: torch.from_numpy(np.asarray(a)) for nm, a in inputs.items()}).items()}
    finally:
        net.close()


def test(args) -> int:
    net = _graph_net(args)
    if not net.input_shapes and not net.data_sources:
        print("model has no declared inputs or data layers", file=sys.stderr)
        return 1
    sums: Dict[str, float] = {}
    for outs in _forwards(net, args.iterations):
        for nm, v in outs.items():
            sums[nm] = sums.get(nm, 0.0) + float(np.mean(v))
    # per-output averages over the run (tools/caffe.cpp:229-298)
    for nm, total in sums.items():
        print(f"{nm} = {total / args.iterations:.6f}")
    return 0


def extract_features(args) -> int:
    """tools/extract_features.cpp: run the net, write the named blobs of
    every iteration to an HDF5 file, one dataset per blob."""
    import h5py

    net = _graph_net(args)
    blob_names = args.blobs.split(",")
    collected: Dict[str, List[np.ndarray]] = {b: [] for b in blob_names}
    for outs in _forwards(net, args.iterations, blob_names):
        for b in blob_names:
            collected[b].append(outs[b])
    with h5py.File(args.out, "w") as f:
        for b, chunks in collected.items():
            f.create_dataset(b.replace("/", "_"), data=np.concatenate(chunks))
    print(f"wrote {args.out}")
    return 0


def upgrade_net_proto(args) -> int:
    """upgrade_net_proto_text: V0 nested / V1 enum-typed `layers`
    definitions -> a V2 prototxt (upgrade_proto.cpp:19-67)."""
    from deepcut_tpu_torch.core.graph import _V1_TYPE_NAMES
    from deepcut_tpu_torch.proto.upgrade import upgrade_net

    net = upgrade_net(text_format.parse_file(args.input))
    for layer in net.get_list("layer"):
        t = layer.get_str("type", "")
        if t in _V1_TYPE_NAMES:
            layer.fields["type"] = [_V1_TYPE_NAMES[t]]
    with open(args.output, "w") as f:
        f.write(text_format.dump(net) + "\n")
    print(f"wrote {args.output}")
    return 0


def upgrade_net_proto_binary(args) -> int:
    """upgrade_net_proto_binary: a legacy binary NetParameter (V0 nested /
    V1 layers containers) -> a V2 binary."""
    from collections import OrderedDict

    from deepcut_tpu_torch.proto.caffemodel import encode_netparameter, load_caffemodel

    blobs = load_caffemodel(args.input)  # V0 / V1 / V2 alike
    layers = OrderedDict((name, [b.data for b in bs]) for name, bs in blobs.items())
    with open(args.output, "wb") as f:
        f.write(encode_netparameter(layers))
    print(f"wrote {args.output} ({len(layers)} layers)")
    return 0


def upgrade_solver_proto(args) -> int:
    """upgrade_solver_proto_text: the legacy `solver_type: ENUM` -> `type: "Name"`."""
    from deepcut_tpu_torch.proto.upgrade import upgrade_solver

    with open(args.output, "w") as f:
        f.write(text_format.dump(upgrade_solver(text_format.parse_file(args.input))) + "\n")
    print(f"wrote {args.output}")
    return 0


class _Clock:
    """Milliseconds of `n` calls: CUDA events on the card, the host clock
    on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def __call__(self, fn, n: int) -> float:
        import torch

        if self.cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        t0 = _time.perf_counter()
        for _ in range(n):
            fn()
        return (_time.perf_counter() - t0) * 1e3


def time_cmd(args) -> int:
    import torch

    net = _graph_net(args)
    if not net.input_shapes and not net.data_sources:
        print("model has no declared inputs or data layers", file=sys.stderr)
        return 1
    print(f"Timing {net.name}: {len(net._plan)} layers, {args.iterations} iterations, "
          f"{'f32 (TF32 off)' if args.fp32 else 'bf16'} on {net.device}")
    inputs = {nm: torch.zeros(sh, device=net.device) for nm, sh in net.input_shapes.items()}
    if net.data_sources:   # a data-layer net: time one staged batch
        host: Dict[str, np.ndarray] = {}
        net._pull_data_layers(host)
        net.close()
        inputs.update({nm: torch.from_numpy(np.asarray(a)).to(net.device) for nm, a in host.items()})
        net._ensure_params({nm: tuple(v.shape) for nm, v in inputs.items()})
    if args.fold_bn:
        print(f"folded {net.fold_bn()} BN chains; weights cast to {'f32' if args.fp32 else 'bf16'}")
        net.cast_weights(torch.float32 if args.fp32 else torch.bfloat16)
    fwd = net.make_forward()
    clock = _Clock(net.device)
    clock(lambda: fwd(net.params, inputs), 2)  # warm-up: cuDNN plans, the weights' preparation
    ms = clock(lambda: fwd(net.params, inputs), args.iterations) / args.iterations
    print(f"Average forward (make_forward): {ms:.3f} ms")
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if net.device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            for _ in range(max(args.iterations, 3)):
                fwd(net.params, inputs)
            if net.device.type == "cuda":
                torch.cuda.synchronize()
        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, f"{net.name or 'net'}_forward.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace written to {path} (chrome://tracing, Perfetto)")
    if args.per_layer:
        # each layer alone on the staged stream (diagnostic: each call pays
        # its own launches and host time, which the whole forward overlaps)
        prepared = net._prepare(net.params)
        rows = []
        with torch.inference_mode():
            blobs = dict(net.stage_inputs(inputs))
            for fn, spec in net._plan:
                bottoms = [blobs[b] for b in spec.bottoms]
                entry = net._entry(prepared, spec.name)
                outs = fn(entry, bottoms)
                per = clock(lambda: fn(entry, bottoms), args.iterations) / args.iterations
                rows.append((spec.name, spec.type, per))
                for top, val in zip(spec.tops, outs if isinstance(outs, (list, tuple)) else [outs]):
                    blobs[top] = val
        print(f"{'layer':40s} {'type':20s} {'ms':>8s}")
        for name, typ, per in sorted(rows, key=lambda r: -r[2])[: args.top]:
            print(f"{name:40s} {typ:20s} {per:8.3f}")
        print(f"Sum of layers alone: {sum(r[2] for r in rows):.3f} ms "
              f"(against {ms:.3f} ms for the whole forward)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="deepcut_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="verb", required=True)
    p = sub.add_parser("train", help="train from a solver prototxt (DeeperCut or any graph net)")
    p.add_argument("-solver", required=True)
    p.add_argument("-snapshot", default="",
                   help="resume from a .npz or a graph net's .solverstate (either package's)")
    p.add_argument("-weights", default="",
                   help="finetune from a .caffemodel (a graph net: a comma-separated list)")
    p.add_argument("-batch_size", type=int, default=None,
                   help="override pose_data_param.batch_size (default: the prototxt's, else 1)")
    p.add_argument("-resnet", type=int, default=152, choices=(50, 101, 152))
    p.add_argument("-device", default="cuda", help="torch device to train on (cuda, cuda:1, cpu)")
    p.add_argument("-mesh", type=int, default=0,
                   help="train over N GPUs (the -gpu 0,1,.. analog): run under "
                        "torchrun --nproc_per_node N, one process per GPU")
    p.add_argument("-spatial", type=int, default=1,
                   help="with -mesh N: shard image rows over S of the N ranks (a (N/S) x S "
                        "data x spatial mesh, halo exchange between row shards)")
    p.add_argument("-data_workers", type=int, default=4,
                   help="decode threads in the input pipeline (0 = serial; same batches)")
    p.add_argument("-sigint_effect", default="stop", choices=["stop", "snapshot", "none"])
    p.add_argument("-sighup_effect", default="snapshot", choices=["stop", "snapshot", "none"])
    p.add_argument("-mixed_precision", action="store_true",
                   help="bf16 conv compute, f32 params/losses/updates")
    p.add_argument("-remat", action="store_true",
                   help="recompute each residual block in the backward pass (less memory)")
    p.add_argument("-augment_device", action="store_true",
                   help="warp/scale/canvas the decoded images on the device")
    p.add_argument("-host_targets", action="store_true",
                   help="rasterize dense target maps on the host (the reference layout)")
    p.set_defaults(fn=train)

    p = sub.add_parser("device_query", help="show the CUDA cards")
    p.set_defaults(fn=device_query)

    for verb, fn, what in (("test", test, "score a model on its data layers (or random inputs)"),
                           ("time", time_cmd, "time a model's serving forward"),
                           ("extract_features", extract_features, "dump named blobs to HDF5")):
        p = sub.add_parser(verb, help=what)
        p.add_argument("-model", required=True)
        p.add_argument("-weights", default="", help="a .caffemodel (default: the fillers' init)")
        p.add_argument("-iterations", type=int, default=50 if verb == "test" else 10)
        p.add_argument("-fp32", action="store_true", help="f32 layers (TF32 off) instead of bf16")
        p.add_argument("-device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
        p.set_defaults(fn=fn)
        if verb == "extract_features":
            p.add_argument("-blobs", required=True, help="comma-separated blob names")
            p.add_argument("-out", required=True, help="the .h5 file to write")
        if verb == "time":
            p.add_argument("-fold_bn", action="store_true",
                           help="fold BatchNorm (+Scale) into the convs and cast the weights")
            p.add_argument("-per_layer", action="store_true",
                           help="also time each layer alone on the staged stream")
            p.add_argument("-top", type=int, default=30, help="layers shown by -per_layer")
            p.add_argument("-trace", default="", help="write a torch.profiler trace into this "
                           "directory; it carries the graph engine's spans (graph.forward, "
                           "graph.<layer>)")

    for verb, fn, what in (
            ("upgrade_net_proto", upgrade_net_proto, "legacy prototxt -> V2"),
            ("upgrade_net_proto_binary", upgrade_net_proto_binary,
             "legacy binary NetParameter -> V2 binary"),
            ("upgrade_solver_proto", upgrade_solver_proto, "legacy solver_type enum -> type string")):
        p = sub.add_parser(verb, help=what)
        p.add_argument("input")
        p.add_argument("output")
        p.set_defaults(fn=fn)

    # the reference's deprecated single-purpose tools (tools/train_net.cpp,
    # finetune_net.cpp, test_net.cpp, net_speed_benchmark.cpp LOG(FATAL)
    # "Deprecated. Use caffe <verb> ..."): the same warning, then the verb
    def deprecated(name, new_form, remap):
        def fn(a):
            print(f"{name} is deprecated. Use: deepcut_tpu_torch {new_form}", file=sys.stderr)
            return main(remap(a))
        return fn

    p = sub.add_parser("train_net", help="deprecated: use train")
    p.add_argument("solver")
    p.add_argument("snapshot", nargs="?", default="")
    p.set_defaults(fn=deprecated("train_net", "train -solver ... [-snapshot ...]", lambda a: (
        ["train", "-solver", a.solver] + (["-snapshot", a.snapshot] if a.snapshot else []))))

    p = sub.add_parser("finetune_net", help="deprecated: use train -weights")
    p.add_argument("solver")
    p.add_argument("weights")
    p.set_defaults(fn=deprecated("finetune_net", "train -solver ... -weights ...", lambda a: (
        ["train", "-solver", a.solver, "-weights", a.weights])))

    p = sub.add_parser("test_net", help="deprecated: use test")
    p.add_argument("model")
    p.add_argument("weights", nargs="?", default="")
    p.add_argument("iterations", nargs="?", type=int, default=50)

    def remap_test_net(a):
        # `test_net model.prototxt 20`: an all-digits second argument is the count
        weights, iters = a.weights, a.iterations
        if weights.isdigit():
            weights, iters = "", int(weights)
        return (["test", "-model", a.model, "-iterations", str(iters)]
                + (["-weights", weights] if weights else []))
    p.set_defaults(fn=deprecated("test_net", "test -model ... -weights ... -iterations N",
                                 remap_test_net))

    p = sub.add_parser("net_speed_benchmark", help="deprecated: use time")
    p.add_argument("model")
    p.add_argument("iterations", nargs="?", type=int, default=10)
    p.set_defaults(fn=deprecated("net_speed_benchmark", "time -model ... -iterations N", lambda a: (
        ["time", "-model", a.model, "-iterations", str(a.iterations)])))
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
