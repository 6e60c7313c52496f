"""Command-line front end of the port: the `train` verb for DeeperCut nets.

    python -m deepcut_tpu_torch.tools.cli train -solver SOLVER.prototxt \\
        [-weights X.caffemodel] [-snapshot S.npz] [-mixed_precision] [-remat] \\
        [-augment_device] [-host_targets] [-device cuda]

Counterpart of `deepcut_tpu.tools.cli train` for solvers whose net has a
PoseData layer: the layer's pose_data_param configures the targets and the
data source (`data.pipeline.PoseDataSource`, uint8 canvases,
compact annotations rasterized on the device unless -host_targets), the
ResNet trunk is built natively, and `solver.solver.PoseSolver` trains it on
one device. -mesh / -spatial (multi-GPU) and solvers without a PoseData
layer (the generic graph engine) raise NotImplementedError.

Precision: the reference trains in pure f32, and cuDNN's default TF32 is
not f32, so f32 training turns TF32 off for cuDNN and matmuls and says so
in its first log line; -mixed_precision (bf16 convs, f32 params, losses
and updates) is the fast path.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from deepcut_tpu_torch.data.pipeline import PoseDataSource, Prefetcher
from deepcut_tpu_torch.data.window_file import parse_stats_file
from deepcut_tpu_torch.pose.targets import TargetConfig
from deepcut_tpu_torch.proto import text_format

ENGINE_MESSAGE = ("the solver's net has no PoseData layer: generic prototxt nets train "
                  "through the graph engine, which belongs to the engine slice of the "
                  "port and is not ported yet")
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


def pose_data(sp, *, workers: int = 4, host_targets: bool = False,
              augment_device: bool = False):
    """The PoseData layer of a solver's train net -> ``(target_cfg,
    joint_stats, source, pose_data_param)``: the `TargetConfig`, the joint
    pair stats (None without ``joint_pairs_stats``) and a `PoseDataSource`
    of uint8 canvases with compact annotations for the device rasterizer
    (dense host maps with host_targets), seeded by the solver's
    random_seed. Close the source when done."""
    model_def, _stages, _level = sp.resolve_train_net()
    net_proto = model_def if not isinstance(model_def, str) else text_format.parse_file(model_def)
    data_layer = next((layer for layer in net_proto.get_list("layer")
                       if layer.get_str("type") == "PoseData"), None)
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
    tcfg, stats, source, pp = pose_data(sp, workers=args.data_workers,
                                        host_targets=args.host_targets,
                                        augment_device=args.augment_device)
    if args.mixed_precision:
        print("mixed precision: bf16 convolutions, f32 params, losses and updates")
    else:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        print("f32 training: TF32 off for cuDNN convolutions and matmuls "
              "(the reference trains in full f32; -mixed_precision is the fast path)")
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


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="deepcut_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="verb", required=True)
    p = sub.add_parser("train", help="train a DeeperCut model from a solver prototxt")
    p.add_argument("-solver", required=True)
    p.add_argument("-snapshot", default="", help="resume from a .npz snapshot (either package's)")
    p.add_argument("-weights", default="", help="finetune from a .caffemodel")
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
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
