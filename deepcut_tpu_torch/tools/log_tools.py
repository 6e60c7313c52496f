"""Log/net inspection tools: the tools/extra/ suite of the reference.

- ``summarize``      — tabular net listing (tools/extra/summarize.py)
- ``extract_seconds``— per-iteration elapsed seconds from a training log
                       (tools/extra/extract_seconds.py)
- ``plot``           — chart training-log fields (loss/lr vs iters/seconds)
                       (tools/extra/plot_training_log.py.example)

Usage:
  python -m deepcut_tpu_torch.tools.log_tools summarize NET.prototxt
  python -m deepcut_tpu_torch.tools.log_tools extract_seconds LOG OUT.txt
  python -m deepcut_tpu_torch.tools.log_tools plot LOG OUT.png [--y loss|lr] [--x iters|seconds]

The port's own copy of `deepcut_tpu.tools.log_tools` (jax-free; held against the
original by tests/test_torch_tools.py).
"""

from __future__ import annotations

import argparse
import datetime
import os
import re
import sys
from typing import Dict, List, Optional, Tuple


# -- extract_seconds ---------------------------------------------------------

_GLOG_RE = re.compile(r"^[IWEF](\d{2})(\d{2}) (\d{2}):(\d{2}):(\d{2})\.(\d+)")
_ISO_RE = re.compile(r"^(\d{4})-(\d{2})-(\d{2})[ T](\d{2}):(\d{2}):(\d{2})")


def _line_datetime(line: str, year: int) -> Optional[datetime.datetime]:
    m = _GLOG_RE.match(line)
    if m:
        mo, d, h, mi, s, us = (int(g) for g in m.groups())
        return datetime.datetime(year, mo, d, h, mi, s, us)
    m = _ISO_RE.match(line)
    if m:
        y, mo, d, h, mi, s = (int(g) for g in m.groups())
        return datetime.datetime(y, mo, d, h, mi, s)
    return None


def extract_seconds(log_path: str, out_path: str) -> int:
    """Write elapsed seconds for each `Iteration N` line, measured from the
    `Solving` line (or the first iteration line) — reference
    extract_seconds.py semantics."""
    year = datetime.datetime.fromtimestamp(os.path.getctime(log_path)).year
    start: Optional[datetime.datetime] = None
    rows: List[float] = []
    with open(log_path) as f:
        for line in f:
            dt = _line_datetime(line, year)
            if dt is None:
                continue
            if start is None and ("Solving" in line or "Iteration" in line):
                start = dt
            if "Iteration" in line and start is not None:
                delta = (dt - start).total_seconds()
                if delta < 0:  # year rollover in glog timestamps
                    delta += 366 * 24 * 3600
                rows.append(delta)
    with open(out_path, "w") as f:
        for sec in rows:
            f.write(f"{sec:.6f}\n")
    print(f"wrote {len(rows)} timestamps to {out_path}")
    return 0


# -- summarize ---------------------------------------------------------------


def _layer_descr(spec) -> str:
    t = spec.get_str("type", "?")
    bits = []
    cp = spec.get("convolution_param")
    if cp is not None:
        ks = cp.get_list("kernel_size") or [cp.get_int("kernel_h", 0)]
        st = cp.get_list("stride") or [1]
        dil = cp.get_list("dilation") or [1]
        bits.append(f"{cp.get_int('num_output', 0)}x{ks[0]}k s{st[0]}" +
                    (f" d{dil[0]}" if dil and int(dil[0]) != 1 else ""))
    pp = spec.get("pooling_param")
    if pp is not None:
        bits.append(f"{pp.get_str('pool', 'MAX')} {pp.get_int('kernel_size', 0)}k "
                    f"s{pp.get_int('stride', 1)}")
    ip = spec.get("inner_product_param")
    if ip is not None:
        bits.append(f"out={ip.get_int('num_output', 0)}")
    return " ".join([t] + bits)


def summarize(prototxt: str, out=sys.stdout) -> int:
    """Concise tabular net listing (reference tools/extra/summarize.py):
    name, type/config, bottoms -> tops, ParamSpec multipliers."""
    from deepcut_tpu_torch.proto import text_format
    from deepcut_tpu_torch.proto.upgrade import upgrade_net

    net = upgrade_net(text_format.parse_file(prototxt))
    rows: List[Tuple[str, str, str, str]] = [("name", "layer", "wiring", "params")]
    for spec in net.get_list("layer"):
        wiring = ",".join(str(b) for b in spec.get_list("bottom"))
        tops = ",".join(str(t) for t in spec.get_list("top"))
        if wiring == tops and wiring:
            wiring = f"{wiring} (in-place)"
        elif wiring or tops:
            wiring = f"{wiring} -> {tops}"
        pbits = []
        for ps in spec.get_list("param"):
            s = ps.get_str("name", "")
            if ps.get_float("lr_mult", 1.0) != 1.0:
                s += f" x{ps.get_float('lr_mult')}"
            if ps.get_float("decay_mult", 1.0) != 1.0:
                s += f" Dx{ps.get_float('decay_mult')}"
            pbits.append(s.strip())
        rows.append((spec.get_str("name", "?"), _layer_descr(spec),
                     wiring, " ".join(pbits)))
    widths = [min(max(len(r[j]) for r in rows) + 1, 40) for j in range(4)]
    for r in rows:
        out.write("".join(c.ljust(w) for c, w in zip(r, widths)).rstrip() + "\n")
    out.write(f"{len(rows) - 1} layers\n")
    return 0


# -- plot --------------------------------------------------------------------


def plot(log_path: str, out_path: str, *, y: str = "loss",
         x: str = "iters") -> int:
    """Chart a parsed training log. y: 'loss', 'lr', or any named metric
    column; x: 'iters' or 'seconds' (needs timestamped log lines)."""
    from deepcut_tpu_torch.tools.parse_log import parse_log

    rows = parse_log(log_path)
    if not rows:
        print("no iteration lines found", file=sys.stderr)
        return 1
    ykey = {"loss": "loss", "lr": "LearningRate"}.get(y, y)
    ys = [r.get(ykey) for r in rows]
    if x == "seconds":
        # timestamps must come from the SAME lines parse_log kept (loss
        # lines); pairing against extract_seconds' every-Iteration-line
        # stream would misalign after any test/snapshot Iteration line
        import datetime

        from deepcut_tpu_torch.tools.parse_log import _ITER_RE

        year = datetime.datetime.now().year
        stamps = []
        with open(log_path) as f:
            for line in f:
                # EXACTLY parse_log's row filter, so pairs stay aligned
                if _ITER_RE.search(line) and "loss" in line:
                    dt = _line_datetime(line, year)
                    if dt is not None:
                        stamps.append(dt)
        if len(stamps) != len(ys):
            print("timestamped loss lines do not match parsed rows; "
                  "falling back to iterations", file=sys.stderr)
            xs = [r["NumIters"] for r in rows]
            xlabel = "iteration"
        else:
            t0 = stamps[0]
            xs = [(s - t0).total_seconds() for s in stamps]
            xlabel = "seconds"
    else:
        xs = [r["NumIters"] for r in rows]
        xlabel = "iteration"
    pairs = [(a, b) for a, b in zip(xs, ys) if b is not None]
    if not pairs:
        print(f"field {ykey!r} not present in log", file=sys.stderr)
        return 1
    xs, ys = zip(*pairs)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(xs, ys, marker=".", linewidth=1)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ykey)
    ax.set_title(os.path.basename(log_path))
    ax.grid(True, alpha=0.3)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    print(f"wrote {out_path} ({len(xs)} points)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="deepcut_tpu_torch.tools.log_tools")
    sub = parser.add_subparsers(dest="verb", required=True)

    p = sub.add_parser("summarize")
    p.add_argument("prototxt")
    p.set_defaults(fn=lambda a: summarize(a.prototxt))

    p = sub.add_parser("extract_seconds")
    p.add_argument("log")
    p.add_argument("out")
    p.set_defaults(fn=lambda a: extract_seconds(a.log, a.out))

    p = sub.add_parser("plot")
    p.add_argument("log")
    p.add_argument("out")
    p.add_argument("--y", default="loss")
    p.add_argument("--x", default="iters", choices=["iters", "seconds"])
    p.set_defaults(fn=lambda a: plot(a.log, a.out, y=a.y, x=a.x))

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
