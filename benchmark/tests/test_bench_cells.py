"""One tiny cell of each traffic end to end on the CPU, through the
program's plain paths, and the faults the check must catch: the harness's
look for a chip is skipped, the rest of a run is driven with the timed path
broken underneath, and `correct` must come out false."""

import dataclasses
import time

import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests.tiny import make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("bench")),
                     {"serve": {"frames": 6, "check_frames": 2, "trace_views": 3},
                      "train": {"trace_iterations": 2}})


def run(root, cell, trace=False, seconds=2.0, seed=2**31 + 11):
    return run_cell(cell, seed, seconds, trace, time.perf_counter(), torch.device("cpu"), root)[0]


def test_train_cell(root):
    res = run(root, "tiny.train")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"train_iter_per_s", "setup_s"}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["checks"]["densify_slots"]["value"] == 0  # the window held a densify event
    assert res["checks"]["follow_grad_gap"]["value"] is not None  # and the followed steps
    assert res["checks"]["start_promoted"]["value"] == 0


def test_train_window_short_of_its_events_is_not_correct(root):
    """A window that ends before the densify event and the followed steps
    fails the check instead of leaving them out."""
    res = run(root, "tiny.train", seconds=0.0)
    assert not res["correct"]
    assert res["checks"]["densify_gap"]["value"] is None
    assert res["checks"]["follow_loss_gap"]["value"] is None


def test_serve_cell(root):
    res = run(root, "tiny.serve")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"views_per_s", "view_ms_p95", "setup_s"}


@pytest.mark.parametrize("cell,names", [
    ("tiny.train", {"step_mfu.train", "densify_ms.train", "from_matches_s.setup",
                    "idle_pct.train"}),
    ("tiny.serve", {"view_mfu.serve", "view_ms_p50.serve", "idle_pct.serve"}),
])
def test_traced_cell_reads_its_per_layer_metrics(root, cell, names):
    res = run(root, cell, trace=True, seconds=3.0)
    assert res["correct"], res["checks"]
    assert names <= set(res["metrics"])
    assert res["breakdown"] is not None


def _half(fn):
    def half(img, gt, *args, **kwargs):
        h = img.shape[1] // 2
        return fn(img[:, h:], gt[:, h:], *args, **kwargs)
    return half


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "state_unchanged_late",
                                   "init_unchanged", "knn_doubled"])
def test_train_fault_is_not_correct(root, monkeypatch, fault):
    from scgaussian_tpu_torch.model import gaussians
    from scgaussian_tpu_torch.model import matches as matches_mod
    from scgaussian_tpu_torch.train import main_stage

    apply_update = main_stage.apply_update
    if fault == "state_unchanged":
        monkeypatch.setattr(main_stage, "apply_update",
                            lambda model, opt_state, grads, iteration, cfg: (model, opt_state))
    elif fault == "state_unchanged_late":  # only the steps the window's check follows
        monkeypatch.setattr(
            main_stage, "apply_update",
            lambda model, opt_state, grads, iteration, cfg: (model, opt_state) if iteration >= 7
            else apply_update(model, opt_state, grads, iteration, cfg))
    elif fault == "half_batch":
        monkeypatch.setattr(main_stage, "l1_loss", _half(main_stage.l1_loss))
        monkeypatch.setattr(main_stage, "ssim", _half(main_stage.ssim))
    elif fault == "init_unchanged":  # the init stage hands its start depths back
        monkeypatch.setattr(matches_mod, "run_init_stage",
                            lambda bundle, z0, **kw: matches_mod.InitStageResult(
                                best_z=z0, min_err=matches_mod.matchloss_from_base(z0, bundle)[1],
                                final_loss=z0.sum()))
    else:
        knn = gaussians.knn_mean_sq_dist
        monkeypatch.setattr(gaussians, "knn_mean_sq_dist", lambda p, k: 2.0 * knn(p, k))
    res = run(root, "tiny.train")
    assert not res["correct"], res["checks"]


def test_serve_answer_altered_is_not_correct(root, monkeypatch):
    from scgaussian_tpu_torch.train import main_stage

    render_model = main_stage.render_model

    def altered(*args, **kwargs):
        out = render_model(*args, **kwargs)
        img = out.render.clone()
        img[:, :8, :8] = 1.0 - img[:, :8, :8]
        return dataclasses.replace(out, render=img)

    monkeypatch.setattr(main_stage, "render_model", altered)
    assert not run(root, "tiny.serve")["correct"]
