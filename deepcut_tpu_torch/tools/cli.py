"""Command-line front end of the port: train / test / time / device_query.

    python -m deepcut_tpu_torch.tools.cli train -solver SOLVER.prototxt \\
        [-weights X.caffemodel] [-snapshot S.npz] [-mixed_precision] [-remat] \\
        [-augment_device] [-host_targets] [-device cuda]
    python -m deepcut_tpu_torch.tools.cli test -model DEPLOY.prototxt [-weights X.caffemodel] \\
        [-iterations 50] [-fp32] [-device cuda]
    python -m deepcut_tpu_torch.tools.cli time -model DEPLOY.prototxt [-iterations 10] \\
        [-fold_bn] [-fp32] [-per_layer] [-trace DIR] [-device cuda]
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
-snapshot; its nets are fed by MemoryData, DummyData or Input tops, and a
net with another data layer (Data, ImageData, HDF5Data, WindowData) raises
NotImplementedError (the data slice of the port). -mesh / -spatial
(multi-GPU) raise NotImplementedError. Precision: the reference trains in
pure f32, and cuDNN's default TF32 is not f32, so f32 training turns TF32
off for cuDNN and matmuls and says so in its first log line;
-mixed_precision (bf16 convs, f32 params, losses and updates) is the
DeeperCut fast path.

`test` and `time` build the graph engine's `core.graph.Net` from a prototxt
with declared inputs. `test` runs `Net.forward` on seeded random inputs and
prints each output's mean over the iterations (tools/caffe.cpp:229-298).
`time` times the serving forward `Net.make_forward` (bf16 stream, or f32
with -fp32; -fold_bn folds BatchNorm and casts the weights first) with CUDA
events on the card (the host clock on the CPU); -per_layer times each layer
alone on the staged stream, -trace writes a `torch.profiler` trace.
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
MULTI_GPU_MESSAGE = ("-mesh / -spatial (data-parallel and spatial training) belong to the "
                     "multi-GPU slice of the port, which is not ported yet")


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


def train_graph(args, sp) -> int:
    """`train` for a solver without a PoseData layer: GraphSolver over its
    prototxt net (caffe.cpp train with the generic net)."""
    from deepcut_tpu_torch.solver.solver import GraphSolver

    _tf32_off()
    solver = GraphSolver(sp, sigint_effect=args.sigint_effect, sighup_effect=args.sighup_effect,
                         device=args.device)
    if args.weights:
        # finetune: matching layers by name, file by file (caffe.cpp CopyLayers)
        for w in args.weights.split(","):
            solver.net.load_weights(w)
    if args.snapshot:
        solver.restore(args.snapshot)
    solver.solve()
    return 0


def pose_data(sp, *, workers: int = 4, host_targets: bool = False,
              augment_device: bool = False):
    """The PoseData layer of a solver's train net -> ``(target_cfg,
    joint_stats, source, pose_data_param)``: the `TargetConfig`, the joint
    pair stats (None without ``joint_pairs_stats``) and a `PoseDataSource`
    of uint8 canvases with compact annotations for the device rasterizer
    (dense host maps with host_targets), seeded by the solver's
    random_seed. Close the source when done."""
    data_layer = _pose_data_layer(sp)
    if data_layer is None:
        raise NotImplementedError(ENGINE_MESSAGE)
    tcfg, pp = _target_config_from_layer(data_layer)
    stats = parse_stats_file(pp.get_str("joint_pairs_stats")) if pp.get_str("joint_pairs_stats") else None
    source = PoseDataSource(
        pp.get_str("source"), tcfg, stats,
        root_folder=pp.get_str("root_folder", ""),
        cycle=pp.get_bool("cycle_training_data", False),
        bucket_step=64,
        # random_seed < 0 = unseeded (solver.cpp:53-54)
        seed=(sp.random_seed if sp.random_seed >= 0
              else int.from_bytes(os.urandom(4), "little")),
        workers=max(workers, 0),
        uint8_images=True,
        device_targets=not host_targets,
        augment_device=augment_device,
    )
    return tcfg, stats, source, pp


def train(args) -> int:
    import torch

    from deepcut_tpu_torch.models.resnet import deepercut_config, init_params
    from deepcut_tpu_torch.solver.solver import PoseSolver, SolverParams

    if args.mesh or args.spatial > 1:
        raise NotImplementedError(MULTI_GPU_MESSAGE)
    sp = SolverParams.from_prototxt(args.solver)
    try:
        sp.resolve_train_net()
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    if _pose_data_layer(sp) is None:
        return train_graph(args, sp)
    tcfg, stats, source, pp = pose_data(sp, workers=args.data_workers,
                                        host_targets=args.host_targets,
                                        augment_device=args.augment_device)
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
            device=args.device)
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


def test(args) -> int:
    net = _graph_net(args)
    if not net.input_shapes:
        print("model has no declared inputs", file=sys.stderr)
        return 1
    rng = np.random.RandomState(0)
    sums: Dict[str, float] = {}
    for _ in range(args.iterations):
        outs = net.forward(**{nm: rng.randn(*sh).astype(np.float32)
                              for nm, sh in net.input_shapes.items()})
        for nm in net.output_names():
            sums[nm] = sums.get(nm, 0.0) + float(np.mean(outs[nm]))
    for nm, total in sums.items():
        print(f"{nm} = {total / args.iterations:.6f}")
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
    if not net.input_shapes:
        print("model has no declared inputs", file=sys.stderr)
        return 1
    print(f"Timing {net.name}: {len(net._plan)} layers, {args.iterations} iterations, "
          f"{'f32 (TF32 off)' if args.fp32 else 'bf16'} on {net.device}")
    if args.fold_bn:
        print(f"folded {net.fold_bn()} BN chains; weights cast to {'f32' if args.fp32 else 'bf16'}")
        net.cast_weights(torch.float32 if args.fp32 else torch.bfloat16)
    inputs = {nm: torch.zeros(sh, device=net.device) for nm, sh in net.input_shapes.items()}
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
    p.add_argument("-snapshot", default="", help="resume from a .npz snapshot (either package's)")
    p.add_argument("-weights", default="",
                   help="finetune from a .caffemodel (a graph net: a comma-separated list)")
    p.add_argument("-batch_size", type=int, default=None,
                   help="override pose_data_param.batch_size (default: the prototxt's, else 1)")
    p.add_argument("-resnet", type=int, default=152, choices=(50, 101, 152))
    p.add_argument("-device", default="cuda", help="torch device to train on (cuda, cuda:1, cpu)")
    p.add_argument("-mesh", type=int, default=0, help="multi-GPU: not ported yet (raises)")
    p.add_argument("-spatial", type=int, default=1, help="multi-GPU: not ported yet (raises)")
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

    for verb, fn, what in (("test", test, "score a deploy prototxt on seeded random inputs"),
                           ("time", time_cmd, "time a deploy prototxt's serving forward")):
        p = sub.add_parser(verb, help=what)
        p.add_argument("-model", required=True)
        p.add_argument("-weights", default="", help="a .caffemodel (default: the fillers' init)")
        p.add_argument("-iterations", type=int, default=50 if verb == "test" else 10)
        p.add_argument("-fp32", action="store_true", help="f32 layers (TF32 off) instead of bf16")
        p.add_argument("-device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
        p.set_defaults(fn=fn)
        if verb == "time":
            p.add_argument("-fold_bn", action="store_true",
                           help="fold BatchNorm (+Scale) into the convs and cast the weights")
            p.add_argument("-per_layer", action="store_true",
                           help="also time each layer alone on the staged stream")
            p.add_argument("-top", type=int, default=30, help="layers shown by -per_layer")
            p.add_argument("-trace", default="", help="write a torch.profiler trace into this directory")
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
