"""The training cell at a small size on the CPU: the reference follows the
program's first steps; the control (the program's bfloat16 path) and each
fault the cell can have come out not correct.  The weights the benchmark
makes fit the program's model."""

import pytest
import torch

import benchcopy

from benchmarks import run
from benchmarks.harness import registry

CELLS = benchcopy.cells("fit_synthetic")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return benchcopy.tiny_copy(str(tmp_path_factory.mktemp("bench")))


def _run(root, hook=None, trace=False):
    result, _ = run.run_cell(CELLS[0], 2**31 + 9, 1.0, trace, device="cpu", root=root,
                             driver_hook=hook)
    return result


def test_initial_weights_fit_the_model():
    from softspoken_tpu_torch.models.unet import SpecUNet2D

    driver = registry.load_module("drivers", "fit_synthetic")
    sd = driver.init_weights(2**31 + 1, "cpu")
    model = SpecUNet2D(folded=False)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected
    assert all(k.endswith(("running_mean", "running_var", "num_batches_tracked"))
               for k in missing)
    w = sd["conv2_1.conv2.0.weight"]
    assert float(w.abs().max()) <= 1.0 / (64 * 9) ** 0.5
    assert torch.equal(sd["conv2_1.conv2.1.weight"], torch.ones(64))


def test_a_sound_run_is_correct(root):
    r = _run(root)
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["loss_step1_rel"]["value"] < 1e-5
    assert set(r["metrics"]) == {"train_steps_per_s", "setup_s"}


def test_a_traced_run_reports_mfu(root):
    r = _run(root, trace=True)
    assert r["correct"] is True, r["checks"]
    assert "mfu.train" in r["metrics"]


def test_the_control_is_not_correct(root):
    r = _run(root, hook=lambda d: d.use_control(d.cell.config["control"]))
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(root, monkeypatch, fault):
    r = _run(root, hook=lambda d: d.plant_fault(fault, monkeypatch.setattr))
    assert r["correct"] is False, r["checks"]
