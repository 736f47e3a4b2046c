"""Each cell's control, on the card at the cell's own size: the reference
computed a precision lower than the configuration states, put in the
program's place, has to come out as not correct under the cell's limits;
so has each fault planted in the training reference. Run on the card with
`python -m pytest perfbench/tests -m cuda -s` (prints each reading)."""

import pytest

from harness import check, manifest, train

SEEDS = (7001, 2718281828, 3141592653, 1618033988)
MAN = manifest.load()


def _numbers(workload, seed, device, fault=None):
    wl = manifest.workload(MAN, workload)
    spec = manifest.read_json("cells", workload)
    traffic = manifest.read_json("traffic", wl["traffic"])
    cfg = manifest.config_path(MAN, wl["config"])
    if traffic["kind"] == "train":
        numbers = train.control_numbers(cfg, traffic, spec, seed, device,
                                        fault)
    else:
        numbers = check.control_numbers(cfg, traffic, spec, seed, device)
    print(f"control {workload} {fault or spec['control']} seed {seed}: "
          f"{numbers}")
    return numbers, spec["limits"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_control_is_not_correct(workload, seed, cuda_device):
    numbers, limits = _numbers(workload, seed, cuda_device)
    assert any(numbers[k] > limits[k] for k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("fault", ["half", "altered"])
@pytest.mark.parametrize("workload", [
    w["name"] for w in MAN["workloads"]
    if manifest.read_json("traffic", w["traffic"])["kind"] == "train"])
def test_training_fault_is_not_correct(workload, fault, seed, cuda_device):
    numbers, limits = _numbers(workload, seed, cuda_device, fault)
    assert any(numbers[k] > limits[k] for k in limits)
