"""A run with the timed path broken underneath, past the look for a card:
``correct`` comes out false for each fault a cell can have (one chip, no
training step: half of the batch left out, and an answer altered where it
is produced)."""

from __future__ import annotations

import pytest
import torch

from conftest import run_small


def _serve_fault(monkeypatch, fault):
    import kde_tpu_torch
    real = kde_tpu_torch.BatchedProductSampler.sample

    def sample(self, key=None, select="auto"):
        pts, labels = real(self, key, select)
        pts, labels = pts.clone(), labels.clone()
        if fault == "half":          # the second half of the sets left out
            h = pts.shape[0] // 2
            pts[h:], labels[h:] = pts[:h], labels[:h]
        else:                        # one draw altered
            pts[0, 0, 0] += 1.0
        return pts, labels
    monkeypatch.setattr(kde_tpu_torch.BatchedProductSampler, "sample",
                        sample)


def _star_fault(monkeypatch, fault):
    import kde_tpu_torch
    real = kde_tpu_torch.product

    def product(densities, add_entropy=True, key=None):
        out = real(densities, add_entropy=add_entropy, key=key)
        if fault == "half":          # half of the chains left out
            pts = out.points.clone()
            h = pts.shape[0] // 2
            pts[h:2 * h] = pts[:h]
            out.points = pts
        else:                        # the refit's answer altered
            out.bw = out.bw * 4.0
        return out
    monkeypatch.setattr(kde_tpu_torch, "product", product)


def _fit_fault(monkeypatch, fault):
    import kde_tpu_torch
    real = kde_tpu_torch.kde

    def kde(points, bw=None, *a, **kw):
        if fault == "half":          # the search's mean over half the points
            return real(points[:, :points.shape[1] // 2], bw, *a, **kw)
        out = real(points, bw, *a, **kw)
        out.bw = out.bw * 4.0        # the answer altered
        return out
    monkeypatch.setattr(kde_tpu_torch, "kde", kde)


CASES = [("serve_point2_b6x1k", _serve_fault),
         ("star_point2_2x20k", _star_fault),
         ("star_pose2_2x20k", _star_fault),
         ("fit_point2_100k", _fit_fault)]


@pytest.mark.parametrize("name,patch", CASES)
@pytest.mark.parametrize("fault", ["half", "altered"])
def test_fault_is_not_correct(monkeypatch, name, patch, fault):
    patch(monkeypatch, fault)
    out = run_small(name)
    assert out["attempted"] > 0
    assert not out["correct"], out["checks"]


def test_sound_run_is_correct():
    assert run_small("fit_point2_100k")["correct"]
    assert torch.get_default_dtype() == torch.float32


@pytest.mark.parametrize("name", ["star_point2_2x20k", "star_pose2_2x20k"])
def test_chains_on_one_belief_fail_draw_z(name):
    """The reference in the program's place with its chains run on the
    second belief alone (the ``last_alone`` fault, a K3 that leaves a belief
    out): ``draw_z`` reads over its limit."""
    ch = run_small(name, control="last_alone")["checks"]["draw_z"]
    assert ch["value"] > ch["limit"]
