"""The serving trunk's 3x3 convolutions (`deepcut_tpu_torch.ops.conv3x3`):
which convolutions its rule sends to the kernel, the wrapper's checks, the
packed weights, and the CPU route, which stays `exact_conv`'s plain
`F.conv2d`.

The kernel itself runs only on the card (`chip_smoke.py` holds it against
cuDNN there). On the CPU the rule is read on the geometry alone: every
convolution the folded ResNet-152 runs at the 704 canvas is recorded on
meta tensors, and the kernel's route is followed by standing in a
shape-only rule for the card's, with the wrapper's plain version behind
it. Tolerance: none; the CPU route computes the same `F.conv2d`.
"""

import pytest
import torch
import torch.nn.functional as F

from deepcut_tpu_torch.models import quantize as tq
from deepcut_tpu_torch.models import resnet as tr
from deepcut_tpu_torch.ops import conv3x3
from deepcut_tpu_torch.ops.conv import conv2d_rounded, deconv2d_rounded, exact_conv
from deepcut_tpu_torch.ops.conv_epilogue import conv_epilogue

CL = torch.channels_last
# a ResNet whose every stage's 3x3 convs the kernel takes (widths multiples of 64)
SMALL_KW = dict(depths=(1, 1, 1, 1), stage_widths=(64, 64, 128, 128), num_joints=4,
                pairwise=False)


def _bf16(*shape, gen, scale=1.0) -> torch.Tensor:
    return (torch.randn(shape, generator=gen) * scale).to(torch.bfloat16).float()


def _walk(cfg, n: int, size: int):
    """Every convolution of the folded serving forward over an (n, 3, size,
    size) canvas: (layer, x shape, w shape, stride, pad, dilation), the
    trunk's recorded on meta tensors, the serving heads' (pose, locref) from
    their layers' geometry."""
    params = {name: {k: v.to("meta") for k, v in p.items()}
              for name, p in tr.init_params(torch.Generator().manual_seed(0), cfg).items()}
    names = {id(p["w"]): name for name, p in params.items() if "w" in p}
    seen = []

    def conv_fn(op, x, w, b=None, *, stride=1, pad=0, dilation=1, **_):
        seen.append((names[id(w)], tuple(x.shape), tuple(w.shape), stride, pad, dilation))
        return F.conv2d(x, w, None, stride=stride, padding=pad, dilation=dilation)

    res5c, skip = tr.run_trunk(params, torch.empty((n, 3, size, size), device="meta"), cfg,
                               folded=True, conv_fn=conv_fn)
    for head in ("pose", "locref"):
        up, sk = params[f"res5c_up_{head}"]["w"], params[f"res3d_{head}"]["w"]
        seen.append((f"res5c_up_{head}", tuple(res5c.shape), tuple(up.shape), 2, 0, 1))
        seen.append((f"res3d_{head}", tuple(skip.shape), tuple(sk.shape), 1, 0, 1))
    return seen


@pytest.mark.parametrize("n", [1, 4])
def test_rule_takes_exactly_the_trunk_3x3_convs(n):
    """ResNet-152 at the 704 canvas: of the trunk's 155 convolutions and
    the serving heads' 4, the kernel's geometry takes the 50 branch2b
    convs of res2 to res5 (res5's dilated by 2) and nothing else."""
    convs = _walk(tr.deepercut_config(152), n, 704)
    assert len(convs) == 159
    taken = [name for name, xs, ws, stride, pad, dil in convs
             if not name.startswith("res5c_up") and conv3x3.fits(xs[1], ws, stride, pad, dil)]
    assert len(taken) == 50
    assert all(name.endswith("_branch2b") for name in taken)
    assert sum(name.startswith("res5") for name in taken) == 3
    assert {name for name, *_ in convs if name.endswith("_branch2b")} == set(taken)


@pytest.mark.parametrize("case", [
    ("stem 7x7/2", 3, (64, 3, 7, 7), 2, 3, 1, 1),
    ("1x1", 256, (64, 256, 1, 1), 1, 0, 1, 1),
    ("1x1 stride 2", 256, (128, 256, 1, 1), 2, 0, 1, 1),
    ("heads' skip 1x1", 512, (18, 512, 1, 1), 1, 0, 1, 1),
    ("3x3 stride 2", 64, (64, 64, 3, 3), 2, 1, 1, 1),
    ("grouped", 64, (64, 32, 3, 3), 1, 1, 1, 2),
    ("row-sharded halo: no padding on H", 256, (256, 256, 3, 3), 1, (0, 1), 1, 1),
    ("padding other than the dilation", 512, (512, 512, 3, 3), 1, 1, 2, 1),
    ("dilation past the kernel's", 64, (64, 64, 3, 3), 1, 9, 9, 1),
    ("Cin no multiple of 64", 96, (128, 96, 3, 3), 1, 1, 1, 1),
    ("Cout no multiple of 64", 128, (42, 128, 3, 3), 1, 1, 1, 1),
    ("1x3", 64, (64, 64, 1, 3), 1, (0, 1), 1, 1),
], ids=lambda c: c[0])
def test_rule_bypasses(case):
    _, cin, ws, stride, pad, dil, groups = case
    assert not conv3x3.fits(cin, ws, stride, pad, dil, groups)


def test_rule_bypasses_cpu_and_autograd():
    gen = torch.Generator().manual_seed(1)
    x = _bf16(1, 64, 6, 6, gen=gen).contiguous(memory_format=CL)
    w = _bf16(64, 64, 3, 3, gen=gen, scale=0.05)
    assert conv3x3.fits(64, tuple(w.shape), 1, 1, 1)
    assert not conv3x3.engages(x, w, 1, 1, 1)                     # a CPU tensor
    x_meta, w_meta = x.to("meta"), w.to("meta")
    assert not conv3x3.engages(x_meta, w_meta, 1, 1, 1)           # nor any but CUDA
    assert not conv3x3.engages(x.requires_grad_(), w, 1, 1, 1)    # no backward


@pytest.fixture
def shape_rule(monkeypatch):
    """The card's rule on the geometry alone (any device), and each launch
    the wrapper takes recorded: (x, wk, dilation)."""
    calls = []
    monkeypatch.setattr(conv3x3, "engages", lambda x, w, stride=1, pad=0, dilation=1, groups=1: (
        x.dim() == 4 and conv3x3.fits(x.shape[1], tuple(w.shape), stride, pad, dilation, groups)
        and not (x.requires_grad or w.requires_grad)))
    real = conv3x3.conv3x3

    def record(x, wk, dilation):
        calls.append((x, wk, dilation))
        return real(x, wk, dilation)

    monkeypatch.setattr(conv3x3, "conv3x3", record)
    return calls


def test_folded_forward_takes_the_kernel_route(shape_rule):
    """The folded bf16 forward sends each 3x3 conv the rule takes through
    the wrapper, channels_last, with the weight's packed copy, and its
    answer is the route's it replaced, bit for bit (on the CPU the wrapper
    computes the same f32 `F.conv2d`)."""
    cfg = tr.DeeperCutConfig(**SMALL_KW)
    params = tr.cast_params(tr.fold_bn(tr.init_params(torch.Generator().manual_seed(2), cfg), cfg))
    model = tr.DeeperCut(params, cfg).to(memory_format=CL)
    x = (torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(3)) * 40
         ).contiguous(memory_format=CL)
    with torch.inference_mode():
        got = model(x)
    assert len(shape_rule) == 4                      # one branch2b a stage
    weights = {name: p["w"] for name, p in model.param_dict().items()}
    for (xk, wk, dil), stage in zip(shape_rule, ("2a", "3a", "4a", "5a")):
        assert xk.is_contiguous(memory_format=CL)
        w = weights[f"res{stage}_branch2b"]
        assert wk is conv3x3.packed(w) and torch.equal(conv3x3.unpack(wk), w)
        assert dil == (2 if stage == "5a" else 1)
    shape_rule.clear()
    with torch.inference_mode(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(conv3x3, "engages", lambda *a, **k: False)
        want = model(x)
    assert not shape_rule
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_heads_and_int8_never_take_the_kernel(shape_rule):
    """The transposed heads and the int8 network (its stem and heads run
    `conv2d_rounded`, its trunk int8 convs) launch no 3x3 kernel."""
    gen = torch.Generator().manual_seed(4)
    x = _bf16(1, 128, 5, 6, gen=gen).contiguous(memory_format=CL)
    deconv2d_rounded(x, _bf16(128, 64, 3, 3, gen=gen, scale=0.05), None, stride=2)
    deconv2d_rounded(x, _bf16(128, 64, 3, 3, gen=gen, scale=0.05), None, stride=1, pad=1)
    assert not shape_rule
    cfg = tr.DeeperCutConfig(compute_dtype=torch.float32, **SMALL_KW)
    params = tr.fold_bn(tr.init_params(torch.Generator().manual_seed(5), cfg), cfg)
    img = torch.randn(1, 3, 64, 64, generator=gen) * 40
    qp, sc = tq.prepare_int8(params, cfg, img)
    with torch.inference_mode():
        tq.forward_int8(qp, sc, img, cfg)
    assert not shape_rule


@pytest.mark.parametrize("fault", ["x bf16", "x f64", "x NCHW", "x requires grad",
                                   "wk requires grad", "wk f32", "wk not contiguous",
                                   "wk Cin mismatch", "Cout 96", "dilation 0", "dilation 9",
                                   "x on meta", "wk on meta"])
def test_wrapper_raises(fault):
    gen = torch.Generator().manual_seed(6)
    x = _bf16(1, 64, 7, 9, gen=gen).contiguous(memory_format=CL)
    w = _bf16(128, 64, 3, 3, gen=gen, scale=0.05)
    wk, dil = conv3x3.pack(w), 1
    if fault == "x bf16":
        x = x.to(torch.bfloat16)
    elif fault == "x f64":
        x = x.double()
    elif fault == "x NCHW":
        x = x.contiguous()
    elif fault == "x requires grad":
        x.requires_grad_()
    elif fault == "wk requires grad":
        wk = wk.float().requires_grad_().to(torch.bfloat16)
    elif fault == "wk f32":
        wk = wk.float()
    elif fault == "wk not contiguous":
        wk = conv3x3.pack(_bf16(128, 64, 3, 3, gen=gen)).transpose(1, 2)
    elif fault == "wk Cin mismatch":
        wk = conv3x3.pack(_bf16(128, 128, 3, 3, gen=gen))
    elif fault == "Cout 96":
        wk = conv3x3.pack(_bf16(96, 64, 3, 3, gen=gen))
    elif fault == "dilation 0":
        dil = 0
    elif fault == "dilation 9":
        dil = 9
    elif fault == "x on meta":
        x = x.to("meta")
    elif fault == "wk on meta":
        wk = wk.to("meta")
    with pytest.raises(ValueError):
        conv3x3.conv3x3(x, wk, dil)


@pytest.mark.parametrize("cin", [64, 128, 512])
def test_packed_weights_hold_the_weights(cin):
    """bf16 (Cout, 3, 3, Cin), each 16-channel group in PERM's order: the
    same values as the OIHW f32 weights, exactly."""
    gen = torch.Generator().manual_seed(cin)
    w = _bf16(64, cin, 3, 3, gen=gen, scale=0.05)
    wk = conv3x3.pack(w)
    assert wk.dtype == torch.bfloat16 and wk.is_contiguous() and wk.shape == (64, 3, 3, cin)
    for j in (0, 5, 17, cin - 1):
        c = 16 * (j // 16) + conv3x3.PERM[j % 16]
        assert torch.equal(wk[:, :, :, j].float(), w[:, c])
    assert torch.equal(conv3x3.unpack(wk), w)
    assert torch.equal(conv3x3.pack(w.to(torch.bfloat16)), wk)


def test_packed_is_made_once_per_weight():
    """`packed` keeps the packed copy beside its weight and packs anew when
    the weight's data change: in place, or by `.data` (`Module.to`)."""
    gen = torch.Generator().manual_seed(7)
    w = torch.nn.Parameter(_bf16(64, 64, 3, 3, gen=gen), requires_grad=False)
    first = conv3x3.packed(w)
    assert conv3x3.packed(w) is first
    with torch.no_grad():
        w.mul_(2)
    second = conv3x3.packed(w)
    assert second is not first and torch.equal(conv3x3.unpack(second), w)
    w.data = _bf16(64, 64, 3, 3, gen=gen)
    third = conv3x3.packed(w)
    assert third is not second and torch.equal(conv3x3.unpack(third), w)
    with torch.inference_mode():
        v = _bf16(64, 64, 3, 3, gen=gen)
    assert conv3x3.packed(v) is conv3x3.packed(v)


def test_warm_packs_only_card_weights():
    """A CPU module packs nothing: the CPU route never takes the kernel."""
    gen = torch.Generator().manual_seed(8)
    w = _bf16(64, 64, 3, 3, gen=gen)
    conv3x3.warm([w, _bf16(64, 32, 3, 3, gen=gen)])
    assert w not in conv3x3._PACKED


@pytest.mark.parametrize("dil", [1, 2])
@pytest.mark.parametrize("residual", [False, True])
def test_cpu_route_is_exact_conv(dil, residual):
    """On the CPU `conv2d_rounded` is still `exact_conv`'s plain f32
    `F.conv2d` then the epilogue, and the wrapper's plain version computes
    that same `F.conv2d` from the packed weights."""
    gen = torch.Generator().manual_seed(9 + dil)
    x = _bf16(2, 64, 11, 9, gen=gen).contiguous(memory_format=CL)
    w = _bf16(128, 64, 3, 3, gen=gen, scale=0.05)
    b = torch.randn(128, generator=gen)
    res = _bf16(2, 128, 11, 9, gen=gen).contiguous(memory_format=CL) if residual else None
    y = exact_conv(x, w, pad=dil, dilation=dil)
    assert torch.equal(y, F.conv2d(x, w, None, padding=dil, dilation=dil))
    assert torch.equal(conv2d_rounded(x, w, b, pad=dil, dilation=dil, residual=res, relu=True),
                       conv_epilogue(y, b, res, True))
    assert torch.equal(conv3x3.conv3x3(x, conv3x3.pack(w), dil), y)
