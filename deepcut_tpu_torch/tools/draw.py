"""Network visualisation: NetParameter -> graphviz dot (reference: python/caffe/draw.py).

Usage: python -m deepcut_tpu_torch.tools.draw model.prototxt out.dot [out.png]
(PNG rendering requires a graphviz `dot` binary; the .dot text is always
written.)

The port's own copy of `deepcut_tpu.tools.draw` (jax-free; held against the
original by tests/test_torch_tools.py).
"""

from __future__ import annotations

import subprocess
import sys
from typing import Dict, List, Optional

from deepcut_tpu_torch.proto import text_format
from deepcut_tpu_torch.proto.text_format import PbNode

_TYPE_COLORS = {
    "Convolution": "#FB8072", "Deconvolution": "#FB8072",
    "InnerProduct": "#FB8072",
    "Pooling": "#80B1D3",
    "ReLU": "#B3DE69", "Sigmoid": "#B3DE69", "TanH": "#B3DE69",
    "BatchNorm": "#BEBADA", "Scale": "#BEBADA", "LRN": "#BEBADA",
    "Eltwise": "#FDB462", "Concat": "#FDB462", "Crop": "#FDB462",
}


def _layer_label(layer: PbNode) -> str:
    name = layer.get_str("name", "?")
    ltype = layer.get_str("type", "?")
    extras = []
    cp = layer.get("convolution_param")
    if cp is not None:
        ks = cp.get_list("kernel_size")
        if ks:
            extras.append(f"k{ks[0]}")
        if cp.get_int("stride", 1) != 1:
            extras.append(f"s{cp.get_int('stride')}")
        if cp.get_int("dilation", 1) != 1:
            extras.append(f"d{cp.get_int('dilation')}")
        extras.append(f"n{cp.get_int('num_output', 0)}")
    pp = layer.get("pooling_param")
    if pp is not None:
        extras.append(f"{pp.get_str('pool', 'MAX')} k{pp.get_int('kernel_size', 0)} s{pp.get_int('stride', 1)}")
    suffix = f"\\n{' '.join(extras)}" if extras else ""
    return f"{name}\\n({ltype}){suffix}"


def net_to_dot(net: PbNode, *, rankdir: str = "TB", show_blobs: bool = False) -> str:
    lines = [f'digraph "{net.get_str("name", "net")}" {{',
             f"  rankdir={rankdir};",
             '  node [shape=record, style=filled, fontsize=10];']
    producers: Dict[str, str] = {}
    for nm in net.get_list("input"):
        producers[str(nm)] = f"blob_{nm}"
        lines.append(f'  "blob_{nm}" [label="{nm}", shape=oval, fillcolor="#FFFFB3"];')
    for layer in net.get_list("layer"):
        name = layer.get_str("name", "?")
        color = _TYPE_COLORS.get(layer.get_str("type", ""), "#D9D9D9")
        lines.append(f'  "{name}" [label="{_layer_label(layer)}", fillcolor="{color}"];')
        for b in layer.get_list("bottom"):
            src = producers.get(str(b))
            if src:
                lines.append(f'  "{src}" -> "{name}";')
        for t in layer.get_list("top"):
            producers[str(t)] = name
    lines.append("}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 1
    net = text_format.parse_file(argv[0])
    dot = net_to_dot(net)
    with open(argv[1], "w") as f:
        f.write(dot)
    print(f"wrote {argv[1]}")
    if len(argv) > 2:
        try:
            subprocess.run(["dot", "-Tpng", argv[1], "-o", argv[2]], check=True)
            print(f"wrote {argv[2]}")
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"dot rendering failed: {e}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
