"""A run of each cell at a tiny size on the CPU, past the look for a card:
the port's CPU path against the reference, the result's line, and the
faults that `correct` has to catch."""

import json

import pytest
import torch

import run

TINY = {"traffic": {"width": 40, "height": 24, "warmup_calls": 1},
        "cell": {"check_pixels": 192}}
# At 768 segments a step the gaps are set by the batch's noise, not by
# precision: sound tiny runs read up to 0.0017 / 0.0045 / 0.0029 (loss /
# grad / change), the planted faults 0.0077-0.17 / 0.056-1 / 0.0043-1, so
# the tiny runs take limits between those.
TINY_TRAIN = {"traffic": {"batch": 768},
              "cell": {"limits": {"loss_gap": 0.005, "grad_gap": 0.02,
                                  "change_gap": 0.02}}}
RENDER = ["sphere_lane16.view", "knot_lane16.evaluate", "knot_lane16.gt_view"]
CELLS = RENDER + ["knot_lane16.train"]


def _run(workload, trace=False, seed=20260918123):
    tiny = TINY_TRAIN if workload.endswith(".train") else TINY
    res, out, err = run.run_cell(workload, seed, 0.3, trace, device="cpu",
                                 overrides=tiny)
    return res


@pytest.mark.parametrize("workload", CELLS)
def test_cpu_run_is_correct_and_well_formed(workload):
    res = _run(workload)
    assert res["correct"], res["compared"]
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "compared"
    assert set(keys) == {"correct", "attempted", "failed", "metrics",
                         "device", "compared"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert "setup_s" in res["metrics"]
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    json.dumps(res)


def test_traced_cpu_run_has_breakdown():
    res = _run("sphere_lane16.view", trace=True)
    assert list(res)[-1] == "compared"
    assert set(res) == {"correct", "attempted", "failed", "metrics",
                        "device", "breakdown", "compared"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "setup_s" not in res["metrics"]
    # The frame tail comes from the untraced window ahead of the traced
    # one, and the check covers the calls of both.
    assert res["metrics"]["frame_ms_p95.view"]["value"] > 0.0
    assert res["attempted"] >= 2


def _fault_frame_unchanged(monkeypatch):
    """A step that returns its state unchanged: the frame adds nothing to
    the accumulation."""
    from neural_renderer_tpu_torch.render import pathtrace, neural_frame
    orig = pathtrace.finalize

    def stale(params, radiance, accum):
        return orig(params, torch.zeros_like(radiance), accum)
    monkeypatch.setattr(pathtrace, "finalize", stale)
    monkeypatch.setattr(neural_frame.pt, "finalize", stale)


def _fault_half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest: every
    other sample dropped and the rest counted twice."""
    from neural_renderer_tpu_torch.render import pathtrace
    orig = pathtrace.finalize

    def half(params, radiance, accum):
        keep = torch.arange(radiance.shape[1]) % 2 == 0
        return orig(params, torch.where(keep[None, :], 2.0 * radiance, 0.0),
                    accum)
    monkeypatch.setattr(pathtrace, "finalize", half)


def _fault_step_unchanged(monkeypatch):
    """A training step that returns its state unchanged: the optimizer's
    update skipped."""
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None:
                        None)


def _fault_half_rows(monkeypatch):
    """Half of the training batch left out, the loss the mean over the
    rest."""
    from neural_renderer_tpu_torch.train import trainer
    orig = trainer.shell_losses

    def half(outputs, batch, *args, **kwargs):
        even = torch.arange(batch.valid.shape[0]) % 2 == 0
        return orig(outputs, batch._replace(valid=batch.valid & even),
                    *args, **kwargs)
    monkeypatch.setattr(trainer, "shell_losses", half)


def _fault_target_altered(monkeypatch):
    """An answer altered where it is produced: every tenth segment's
    presence target flipped by the sampler."""
    from neural_renderer_tpu_torch.train import trainer
    orig = trainer.sample_segment_batch

    def altered(*args, **kwargs):
        b = orig(*args, **kwargs)
        flip = (torch.arange(b.presence.shape[0]) % 10 == 0).float()
        return b._replace(presence=b.presence * (1 - flip)
                          + (1 - b.presence) * flip)
    monkeypatch.setattr(trainer, "sample_segment_batch", altered)


def _fault_answer_altered(monkeypatch):
    """An answer altered where it is produced: the network's presence
    logit negated on every tenth row, and every tenth closest hit of the
    mesh dropped."""
    from neural_renderer_tpu_torch.models import nbvh
    from neural_renderer_tpu_torch.ops import traversal
    orig_apply, orig_trace = nbvh.apply, traversal.trace_mesh

    def apply(net, inputs, active=None):
        out = orig_apply(net, inputs, active=active).clone()
        out[0, ::10] = -out[0, ::10]
        return out

    def trace_mesh(mesh, origins, dirs, mode=0, active=None,
                   presorted=False):
        res = orig_trace(mesh, origins, dirs, mode, active, presorted)
        drop = torch.arange(res.hit.shape[0]) % 10 == 3
        return res._replace(hit=res.hit & ~drop,
                            t=torch.where(drop, 1e30, res.t))
    monkeypatch.setattr(nbvh, "apply", apply)
    monkeypatch.setattr(traversal, "trace_mesh", trace_mesh)


@pytest.mark.parametrize("fault", [_fault_frame_unchanged, _fault_half_batch,
                                   _fault_answer_altered])
@pytest.mark.parametrize("workload", RENDER)
def test_planted_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(workload)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("fault", [_fault_step_unchanged, _fault_half_rows,
                                   _fault_target_altered])
def test_planted_training_fault_is_not_correct(fault, monkeypatch):
    workload = "knot_lane16.train"
    fault(monkeypatch)
    res = _run(workload)
    assert not res["correct"], res["compared"]
