"""The fork's two pose losses, with its forward AND its backward, in NCHW.

Counterpart of `deepcut_tpu.ops.losses` (`smooth_l1_loss`,
`softmax_loss_vec`). Neither backward is the autograd of its forward, so
each is a `torch.autograd.Function`:

- both clamp the backward normaliser at ``max(., 100)``
  (softmax_loss_vec_layer.cpp:225-230, smooth_L1_loss_layer.cu:86);
- the smooth L1 backward does not apply the weight a second time
  (Fast R-CNN heritage, where the weights are 0/1 masks);
- the weighted `softmax_loss_vec` backward skips the ignore-zeroing
  (softmax_loss_vec_layer.cpp:171-176).

A `gradcheck` therefore fails by design; the tests hold the cotangents
against `jax.vjp` of the JAX package instead. Tensors are NCHW: the
reference's channel axis 1, which the JAX package moved to -1.
"""

from __future__ import annotations

from typing import Optional

import torch

IGNORE_VALUE = 1000.0  # softmax_loss_vec_layer.cpp:12
FLT_MIN = 1.175494e-38  # the reference's log clamp


def _smooth_l1(d: torch.Tensor) -> torch.Tensor:
    ad = d.abs()
    return torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)


def _smooth_l1_grad(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d.abs() < 1.0, d, torch.sign(d))


class _SmoothL1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, target, weights):
        d = pred - target
        if weights is not None:
            d = d * weights
            wsum = weights.abs().sum()
        else:
            wsum = torch.tensor(float(pred.numel()), dtype=torch.float32, device=pred.device)
        err = _smooth_l1(d).sum()
        loss = torch.where(wsum != 0, err / torch.where(wsum == 0, 1.0, wsum), 0.0)
        ctx.save_for_backward(d, wsum)
        return loss

    @staticmethod
    def backward(ctx, g):
        d, wsum = ctx.saved_tensors
        grad = g * _smooth_l1_grad(d) / torch.clamp(wsum, min=100.0)
        return grad, -grad, None


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Huber loss, fork semantics (smooth_L1_loss_layer.cu).

    forward: d = w*(pred-target); loss = sum f(d) / sum(|w|)  (0 if sum w == 0)
    backward: dpred = f'(d) / max(sum w, 100)   — no second w factor."""
    return _SmoothL1.apply(pred, target, weights)


def _sigmoid_ce_elem(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-element sigmoid cross-entropy, the overflow-safe Caffe form:
    -(x*(t - (x>=0)) - log(1 + exp(x - 2x*(x>=0))))."""
    pos = (x >= 0).to(x.dtype)
    return -(x * (t - pos) - torch.log1p(torch.exp(x - 2.0 * x * pos)))


class _SoftmaxLossVec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scores, labels, weights, cross_entropy, no_softmax, normalize):
        x = scores.float()
        t = labels.float()
        n = float(x.shape[0])
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
        return g * diff / denom, None, None, None, None, None


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
    return _SoftmaxLossVec.apply(scores, labels, weights, cross_entropy, no_softmax, normalize)
