"""Port device rasterizer (`deepcut_tpu_torch.pose.targets_device`) against
the JAX package's `make_batch_rasterizer`.

Batches of `compact_sample` annotations (the JAX package's own host half,
records of different sizes so that the bucket padding is exercised) go
through both rasterizers on the CPU, over the configurations of
tests/test_targets_device.py: hard and soft labels, multi-label,
weight_targets, fg_fraction sampling with and without bg_threshold,
pairwise regression, the skip class, scale jitter, empty records.

Tolerance: labels and weights bit-equal wherever they come from
comparisons and counts (hard labels, every weight map); soft labels are
exp() of a distance, and XLA's exp and PyTorch's round differently (one
ULP near 1, more relative error in the 1e-25 tail), so they are held to
rtol 1e-6 with atol 1.2e-7, one f32 ULP at 1.0. Locref and pairwise targets are divisions of
the same f32 differences: 4 ULP (rtol 5e-7, atol 1e-6 near 0).
"""

import jax
import numpy as np
import pytest
import torch

from deepcut_tpu.data.window_file import ImageRecord, Person
from deepcut_tpu.pose import targets_device as JT
from deepcut_tpu.pose.targets import TargetConfig, grid_geometry
from deepcut_tpu_torch.pose import targets_device as TT


def _record(rng, num_people=1, height=160, width=200, with_skip=False):
    people = []
    for _ in range(num_people):
        k = rng.randint(5, 15)
        classes = rng.permutation(14)[:k] + 1
        if with_skip:
            classes = np.concatenate([classes, [15]])
        xy = np.stack([rng.uniform(0, width, len(classes)),
                       rng.uniform(0, height, len(classes))], axis=1).astype(np.float32)
        people.append(Person(classes.astype(np.int32), xy))
    return ImageRecord("x.png", 3, height, width, people)


CONFIGS = [
    TargetConfig(soft_labels=False, location_refinement=True),
    TargetConfig(soft_labels=True, gauss_blob_sigma=10.0, location_refinement=True),
    TargetConfig(soft_labels=False, multi_label=True, no_bg_class=True,
                 location_refinement=True, regress_to_other=True),
    TargetConfig(soft_labels=False, weight_targets=True, fg_fraction=0.25,
                 location_refinement=True, regress_to_other=True),
    TargetConfig(soft_labels=False, fg_fraction=0.25, bg_threshold=17.0,
                 location_refinement=True),
    TargetConfig(soft_labels=True, no_bg_class=True, location_refinement=True,
                 regress_to_other=True, scale=0.6),
]


def _batch(records, cfg, seed, pad=(0, 0)):
    """compact_sample per record, collated as PoseDataSource collates them."""
    rng = np.random.RandomState(seed)
    limits = JT.record_limits(records)
    samples, grids = [], []
    for i, rec in enumerate(records):
        scale = cfg.scale * (1.0 + 0.05 * i)
        samples.append(JT.compact_sample(rec, cfg, rng=rng, scale=scale, limits=limits))
        grids.append(grid_geometry(rec.height, rec.width, scale)[:2])
    gh = max(g[0] for g in grids) + pad[0]
    gw = max(g[1] for g in grids) + pad[1]
    batch = {}
    for k in JT.ANNO_KEYS:
        if k == "anno_neg_mask":
            ms = np.zeros((len(samples), gh, gw), np.uint8)
            for i, s in enumerate(samples):
                ms[i, :s[k].shape[0], :s[k].shape[1]] = s[k]
            batch[k] = ms
        else:
            batch[k] = np.stack([np.asarray(s[k]) for s in samples])
    batch["image"] = np.zeros((len(samples), gh * 8, gw * 8, 3), np.uint8)
    return batch


_jax_rasters = {}


def _jax_maps(batch, cfg):
    if cfg not in _jax_rasters:
        _jax_rasters[cfg] = jax.jit(JT.make_batch_rasterizer(cfg))
    out = _jax_rasters[cfg](batch)
    return {k: np.asarray(v) for k, v in out.items() if not k.startswith("anno_") and k != "image"}


def _port_maps(batch, cfg):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["image"] = tb["image"].permute(0, 3, 1, 2)
    out = TT.make_batch_rasterizer(cfg)(tb)
    assert not any(k.startswith("anno_") for k in out)
    return {k: v.permute(0, 2, 3, 1).numpy() for k, v in out.items() if k != "image"}


def _assert_match(got, ref, cfg, ctx):
    assert set(got) == set(ref), (set(got), set(ref))
    for k in ref:
        assert got[k].shape == ref[k].shape, (k, got[k].shape, ref[k].shape)
        if k.endswith("_weights") or (k == "part_score_targets" and not cfg.soft_labels):
            assert np.array_equal(got[k], ref[k]), f"{k} {ctx}: not bit-equal"
        elif k == "part_score_targets":
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1.2e-7, err_msg=f"{k} {ctx}")
        else:
            np.testing.assert_allclose(got[k], ref[k], rtol=5e-7, atol=1e-6, err_msg=f"{k} {ctx}")


@pytest.mark.parametrize("cfg_idx", range(len(CONFIGS)))
@pytest.mark.parametrize("num_people,with_skip", [(1, False), (3, True)])
def test_port_rasterizer_matches_jax(cfg_idx, num_people, with_skip):
    cfg = CONFIGS[cfg_idx]
    rng = np.random.RandomState(100 + cfg_idx)
    records = [_record(rng, num_people, 160, 200, with_skip),
               _record(rng, num_people, 120, 168, with_skip),
               _record(rng, 1, 144, 96)]
    batch = _batch(records, cfg, seed=7)
    _assert_match(_port_maps(batch, cfg), _jax_maps(batch, cfg), cfg, f"config {cfg_idx}")


def test_bucket_padding_and_hard_labels_bit_equal():
    """Padding beyond every sample's grid, hard labels at scale 1: every
    map but locref/pairwise bit-equal, those within 4 ULP."""
    cfg = TargetConfig(location_refinement=True, regress_to_other=True,
                       weight_targets=True, fg_fraction=0.25)
    rng = np.random.RandomState(5)
    records = [_record(rng, 2, with_skip=True), _record(rng, 1, 104, 152)]
    batch = _batch(records, cfg, seed=7, pad=(3, 5))
    got, ref = _port_maps(batch, cfg), _jax_maps(batch, cfg)
    _assert_match(got, ref, cfg, "padded")
    assert (got["part_score_targets"][:, -3:] == 1000.0).all()
    assert (got["part_score_weights"][:, -3:] == 0.0).all()


def test_empty_records():
    """Zero-person records across negative-handling modes, beside a
    non-empty one in the same batch."""
    rng = np.random.RandomState(9)
    for cfg in [TargetConfig(),
                TargetConfig(weight_targets=True, fg_fraction=0.25),
                TargetConfig(fg_fraction=0.25),
                TargetConfig(soft_labels=True),
                TargetConfig(no_bg_class=True, multi_label=True)]:
        records = [ImageRecord("e.png", 3, 96, 128, []), _record(rng, 1, 96, 128)]
        batch = _batch(records, cfg, seed=1)
        _assert_match(_port_maps(batch, cfg), _jax_maps(batch, cfg), cfg, str(cfg))


def test_dense_batch_passes_through():
    cfg = TargetConfig()
    batch = {"image": torch.zeros(1, 3, 16, 16), "part_score_targets": torch.ones(1, 15, 2, 2)}
    out = TT.make_batch_rasterizer(cfg)(batch)
    assert out.keys() == batch.keys() and out["part_score_targets"] is batch["part_score_targets"]
