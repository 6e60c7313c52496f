"""The losses and the Accuracy of the graph engine and the fork, in NCHW.

Counterpart of `deepcut_tpu.ops.losses`. The fork's two pose losses, `smooth_l1_loss`
and `softmax_loss_vec`, have a backward that is not the autograd of their
forward, so each is a `torch.autograd.Function`:

- both clamp the backward normaliser at ``max(., 100)``
  (softmax_loss_vec_layer.cpp:225-230, smooth_L1_loss_layer.cu:86);
- the smooth L1 backward does not apply the weight a second time
  (Fast R-CNN heritage, where the weights are 0/1 masks);
- the weighted `softmax_loss_vec` backward skips the ignore-zeroing
  (softmax_loss_vec_layer.cpp:171-176).

A `gradcheck` therefore fails by design; the tests hold the cotangents
against `jax.vjp` of the JAX package instead. Tensors are NCHW: the
reference's channel axis 1, which the JAX package moved to -1.

Upstream Caffe's losses (SoftmaxWithLoss, SigmoidCrossEntropy, Euclidean,
Hinge, Contrastive, Infogain, MultinomialLogistic) and `accuracy` follow
the JAX package's single-device forms, whose gradients are autodiff's:
here autograd's.

Data parallelism (`sharded_losses(axis)`, the counterpart of the JAX
package's psum'ed variants): each rank holds its rows of the global batch,
and every normaliser that depends on the batch (the ``/ N`` of each loss,
the VALID / BATCH_SIZE / FULL counts, the weight sums, Accuracy's counts)
and every loss sum is all-reduced over the mesh's 'data' axis (under a
spatial axis the ranks of one data row compute the same heads), so each
rank reports the global loss and its gradients are its share of the
global gradient (their SUM over the ranks is the single-device gradient).
The all-reduces run in the forward of an autograd Function and never in
its backward, which passes the cotangent through unchanged: an all-reduce
on the differentiation path would scale the gradients by the world size.
Outside the context nothing changes, op for op.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepcut_tpu_torch.ops.shard_rng import as_axis

IGNORE_VALUE = 1000.0  # softmax_loss_vec_layer.cpp:12
FLT_MIN = 1.175494e-38  # the reference's log clamp

# the axis the batch is sharded over (`sharded_losses`)
_AXIS = None


class sharded_losses:
    """Context: ``with sharded_losses(axis): ...`` makes every loss and
    Accuracy here reduce its sums and normalisers over the axis
    (`parallel.mesh.Axis`; a `parallel.mesh.Mesh` stands for its 'data'
    axis); ``sharded_losses(None)`` is a no-op."""

    def __init__(self, axis):
        self.axis = as_axis(axis)

    def __enter__(self):
        global _AXIS
        self._prev, _AXIS = _AXIS, self.axis
        return self

    def __exit__(self, *exc):
        global _AXIS
        _AXIS = self._prev
        return False


class _GlobalSums(torch.autograd.Function):
    """Stacked partial sums -> their sums over the axis, all-reduced in the
    forward; the backward hands each rank's partial sum the cotangent
    unchanged (the counterpart of a psum inside the JAX package's
    custom_vjp)."""

    @staticmethod
    def forward(ctx, stacked, mesh):
        return mesh.all_reduce_(stacked.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def _global_sums(*parts: torch.Tensor, mesh=None):
    """Each 0-dim partial sum summed over `mesh` (an axis; default: the axis
    of `sharded_losses`) in one f32 all-reduce, back in its own dtype;
    unchanged without one."""
    mesh = mesh if mesh is not None else _AXIS
    if mesh is None:
        return parts
    stacked = _GlobalSums.apply(torch.stack([p.float() for p in parts]), mesh)
    return tuple(v.to(p.dtype) for v, p in zip(stacked.unbind(0), parts))


def _batch(n: int) -> float:
    """A local batch size -> the global one (every rank holds as many rows)."""
    return float(n * (_AXIS.size if _AXIS is not None else 1))


def _smooth_l1(d: torch.Tensor) -> torch.Tensor:
    ad = d.abs()
    return torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)


def _smooth_l1_grad(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d.abs() < 1.0, d, torch.sign(d))


class _SmoothL1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, target, weights, mesh):
        d = pred - target
        if weights is not None:
            d = d * weights
            wsum = weights.abs().sum()
        else:
            wsum = torch.tensor(float(pred.numel()), dtype=torch.float32, device=pred.device)
        err = _smooth_l1(d).sum()
        if mesh is not None:   # global sums; the backward is local math over them
            err, wsum = _global_sums(err, wsum, mesh=mesh)
        loss = torch.where(wsum != 0, err / torch.where(wsum == 0, 1.0, wsum), 0.0)
        ctx.save_for_backward(d, wsum)
        return loss

    @staticmethod
    def backward(ctx, g):
        d, wsum = ctx.saved_tensors
        grad = g * _smooth_l1_grad(d) / torch.clamp(wsum, min=100.0)
        return grad, -grad, None, None


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Huber loss, fork semantics (smooth_L1_loss_layer.cu).

    forward: d = w*(pred-target); loss = sum f(d) / sum(|w|)  (0 if sum w == 0)
    backward: dpred = f'(d) / max(sum w, 100)   — no second w factor."""
    return _SmoothL1.apply(pred, target, weights, _AXIS)


def _sigmoid_ce_elem(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-element sigmoid cross-entropy, the overflow-safe Caffe form:
    -(x*(t - (x>=0)) - log(1 + exp(x - 2x*(x>=0))))."""
    pos = (x >= 0).to(x.dtype)
    return -(x * (t - pos) - torch.log1p(torch.exp(x - 2.0 * x * pos)))


class _SoftmaxLossVec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scores, labels, weights, cross_entropy, no_softmax, normalize, mesh):
        x = scores.float()
        t = labels.float()
        n = float(x.shape[0] * (mesh.size if mesh is not None else 1))
        if cross_entropy:
            live = t != IGNORE_VALUE
            w = weights if weights is not None else torch.ones_like(x)
            elem = _sigmoid_ce_elem(x, torch.where(live, t, 0.0)) * w
            loss_sum = torch.where(live, elem, 0.0).sum()
            count = live.any(dim=1).sum().float()
            prob = torch.sigmoid(x)
        else:
            prob = x if no_softmax else torch.softmax(x, dim=1)
            label_value = torch.argmax(t, dim=1, keepdim=True)      # ties -> first
            picked = torch.gather(prob, 1, label_value)[:, 0]
            live_pos = t[:, 0] != IGNORE_VALUE
            loss_sum = -torch.where(live_pos, torch.log(torch.clamp(picked, min=FLT_MIN)),
                                    0.0).sum()
            count = live_pos.sum().float()
            live = live_pos[:, None].expand_as(x)
        # backward numerator: the channel-0 weight sum when weighted
        # (softmax_loss_vec_layer.cpp:185-189), else the live count
        bwd_norm = weights[:, 0].sum() if weights is not None else count
        if mesh is not None:   # global sums; the backward is local math over them
            loss_sum, count, bwd_norm = _global_sums(loss_sum, count, bwd_norm, mesh=mesh)
        denom = torch.clamp(count, min=100.0) if normalize else n
        ctx.normalize, ctx.n = normalize, n
        ctx.save_for_backward(prob, t, weights, live, bwd_norm)
        return loss_sum / denom

    @staticmethod
    def backward(ctx, g):
        prob, t, weights, live, bwd_norm = ctx.saved_tensors
        if weights is not None:
            # the weighted arm shadows both zeroing arms in the reference:
            # (prob - label) * w even where label == IGNORE_VALUE
            diff = (prob - t) * weights
        else:
            diff = prob - torch.where(live, t, prob)              # zero where ignored
        denom = torch.clamp(bwd_norm, min=100.0) if ctx.normalize else ctx.n
        return g * diff / denom, None, None, None, None, None, None


def softmax_loss_vec(scores: torch.Tensor, labels: torch.Tensor,
                     weights: Optional[torch.Tensor] = None, *,
                     cross_entropy: bool = True, no_softmax: bool = False,
                     normalize: bool = True) -> torch.Tensor:
    """The fork's SoftmaxWithLossVec over dense score-map labels, NCHW.

    cross_entropy=True: per-channel sigmoid CE; elements labelled
    IGNORE_VALUE are skipped; `count` = positions with >= 1 live channel.
    cross_entropy=False: softmax over channels (or the scores as they are
    with no_softmax), target class = argmax of the label vector; a position
    is ignored when its channel-0 label is IGNORE_VALUE.
    Forward normaliser: max(count, 100) if normalize else N;
    backward normaliser: max(channel-0 weight sum or count, 100)."""
    return _SoftmaxLossVec.apply(scores, labels, weights, cross_entropy, no_softmax, normalize,
                                 _AXIS)


# -- upstream Caffe's losses (autograd backward, as the JAX package's) ---------
def _nan_if(bad: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.where(bad, torch.full_like(v, float("nan")), v)


def softmax_with_loss(scores: torch.Tensor, labels: torch.Tensor, *,
                      ignore_label: Optional[int] = None,
                      normalization: str = "VALID") -> torch.Tensor:
    """SoftmaxWithLoss (softmax_loss_layer.cpp) over the LAST axis of
    `scores` (the layer moves Caffe's softmax axis there); labels: the
    scores' leading shape, integer-valued.

    normalization: VALID (the count of labels not equal to ignore_label,
    at least 1), BATCH_SIZE (scores.shape[0]), FULL (every label) or NONE.
    A live label outside [0, C) makes the loss NaN, as the JAX package
    poisons it (Caffe CHECKs the range). The gradient is autograd's,
    ``(softmax - onehot) * live / denom``, as the JAX package's."""
    x = scores.float()
    logp = torch.log_softmax(x, dim=-1)
    lab = labels.to(torch.int64)
    c = x.shape[-1]
    picked = torch.gather(logp, -1, lab.clamp(0, c - 1).unsqueeze(-1))[..., 0]
    live = lab != ignore_label if ignore_label is not None else torch.ones_like(lab, dtype=torch.bool)
    picked = _nan_if((live & ((lab < 0) | (lab >= c))).any(), picked)
    loss_sum = -torch.where(live, picked, torch.zeros_like(picked)).sum()
    valid = live.sum().float()
    if _AXIS is not None:
        loss_sum, valid = _global_sums(loss_sum, valid)
    if normalization == "VALID":
        denom = torch.clamp(valid, min=1.0)
    elif normalization == "BATCH_SIZE":
        denom = _batch(scores.shape[0])
    elif normalization == "FULL":
        denom = _batch(lab.numel())
    else:
        denom = 1.0
    return loss_sum / denom


def sigmoid_cross_entropy_loss(scores: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """SigmoidCrossEntropyLoss: the overflow-safe elementwise CE summed,
    over the batch size (sigmoid_cross_entropy_loss_layer.cpp)."""
    (total,) = _global_sums(_sigmoid_ce_elem(scores.float(), targets.float()).sum())
    return total / _batch(scores.shape[0])


def euclidean_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """EuclideanLoss: 0.5 * sum((a - b)^2) / N (euclidean_loss_layer.cpp)."""
    d = a.float() - b.float()
    (total,) = _global_sums((d * d).sum())
    return 0.5 * total / _batch(a.shape[0])


def hinge_loss(scores: torch.Tensor, labels: torch.Tensor, *, norm: str = "L1") -> torch.Tensor:
    """HingeLoss (hinge_loss_layer.cpp): one-vs-all margins over the
    scores flattened per item in C, H, W order; L1 sums them, L2 their
    squares, over N."""
    x = scores.float().reshape(scores.shape[0], -1)
    n, c = x.shape
    onehot = torch.nn.functional.one_hot(labels.to(torch.int64).reshape(-1), c) > 0
    margins = torch.clamp(1.0 + torch.where(onehot, -1.0, 1.0) * x, min=0.0)
    (total,) = _global_sums(((margins * margins) if norm == "L2" else margins).sum())
    return total / _batch(n)


def contrastive_loss(a: torch.Tensor, b: torch.Tensor, y: torch.Tensor, *,
                     margin: float = 1.0, legacy_version: bool = False) -> torch.Tensor:
    """ContrastiveLoss (contrastive_loss_layer.cpp): similar pairs (y = 1)
    pay the squared distance, dissimilar ones max(margin - d, 0)^2
    (legacy: max(margin - d^2, 0)), summed over 2N."""
    d = a.float().reshape(a.shape[0], -1) - b.float().reshape(b.shape[0], -1)
    dist_sq = (d * d).sum(dim=1)
    yf = y.float().reshape(-1)
    if legacy_version:
        neg = torch.clamp(margin - dist_sq, min=0.0)
    else:
        neg = torch.square(torch.clamp(margin - torch.sqrt(dist_sq + 1e-12), min=0.0))
    (total,) = _global_sums((yf * dist_sq + (1 - yf) * neg).sum())
    return total / (2.0 * _batch(a.shape[0]))


def infogain_loss(prob: torch.Tensor, labels: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """InfogainLoss: -sum_k H[label, k] log(max(prob_k, 1e-20)) / N. The
    bottom holds PROBABILITIES (a Softmax before it), not logits
    (infogain_loss_layer.cpp:59-67)."""
    p = torch.clamp(prob.float().reshape(prob.shape[0], -1), min=1e-20)
    rows = H.float()[labels.to(torch.int64).reshape(-1)]
    (total,) = _global_sums(-(rows * torch.log(p)).sum())
    return total / _batch(prob.shape[0])


def multinomial_logistic_loss(prob: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """MultinomialLogisticLoss: -sum log(max(prob[label], FLT_MIN)) / N over
    the last axis of `prob`."""
    p = prob.float()
    picked = torch.gather(p, -1, labels.to(torch.int64).unsqueeze(-1))
    (total,) = _global_sums(-torch.log(torch.clamp(picked, min=FLT_MIN)).sum())
    return total / _batch(prob.shape[0])


def accuracy(scores: torch.Tensor, labels: torch.Tensor, *, top_k: int = 1,
             ignore_label: Optional[int] = None, per_class: bool = False):
    """Accuracy layer (accuracy_layer.cpp) over the LAST axis of `scores`:
    a label is a hit when it is among the top_k scores, ties ranking the
    lower index first (as `lax.top_k`); the share of hits among the live
    labels. per_class: also each class's share among its live labels, 0
    for a class that never occurs (the optional second top)."""
    lab = labels.to(torch.int64)
    topk = torch.argsort(-scores.float(), dim=-1, stable=True)[..., :top_k]
    hit = (topk == lab.unsqueeze(-1)).any(dim=-1)
    live = lab != ignore_label if ignore_label is not None else torch.ones_like(lab, dtype=torch.bool)
    hits, lives = _global_sums((hit & live).sum().float(), live.sum().float())
    total = hits / torch.clamp(lives, min=1.0)
    if not per_class:
        return total
    c = scores.shape[-1]
    livef = live.reshape(-1, 1).float()
    flat = lab.reshape(-1)
    livef = livef * ((flat >= 0) & (flat < c)).float().reshape(-1, 1)   # one_hot's zero rows
    onehot = torch.nn.functional.one_hot(flat.clamp(0, c - 1), c).float() * livef
    counts = onehot.sum(dim=0)
    correct = (onehot * hit.reshape(-1, 1).float()).sum(dim=0)
    if _AXIS is not None:
        counts, correct = _AXIS.all_reduce_(torch.stack([counts, correct])).unbind(0)
    return total, torch.where(counts == 0, 0.0, correct / torch.clamp(counts, min=1.0))
