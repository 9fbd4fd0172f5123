"""The port's example scripts on the CPU at tiny sizes:
``scripts/train_mnist_torch.py`` (the MLP's loss below 1e-3 by step 100,
as on the card) and ``scripts/train_resnet_torch.py`` (ResNet-50 through
the prefetching pipeline at the example's env knobs), each printing the
example's lines; both refuse to fall back to the CPU unasked."""

import os
import re
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "scripts"))

import train_mnist_torch  # noqa: E402
import train_resnet_torch  # noqa: E402


@pytest.fixture(autouse=True)
def few_torch_threads():
    """At most two torch threads: the suite's workers share the cores, and
    torch's many small ops on all of them spin against each other (ten
    times slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_mnist_script_learns_and_prints_the_examples_lines(capsys):
    losses = train_mnist_torch.main(["--device", "cpu", "--steps", "101"])
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"step    0 loss \d+\.\d{4} \(\d+ imgs/s\)", out[1])
    assert out[-1] == "done" and len(losses) == 2
    assert losses[1] < 1e-3 < losses[0]


def test_resnet_script_runs_the_example_at_its_env_sizes(monkeypatch, capsys):
    for name, value in (("BATCH", "2"), ("IMAGE", "32"), ("STEPS", "3"), ("LOG_EVERY", "1")):
        monkeypatch.setenv(f"DEVSPACE_EXAMPLE_{name}", value)
    losses = train_resnet_torch.main(["--device", "cpu", "--stem", "space_to_depth"])
    out = capsys.readouterr().out.splitlines()
    steps = [ln for ln in out if ln.startswith("step")]
    assert [ln.split()[1] for ln in steps] == ["1", "2"]
    assert all(re.fullmatch(r"step +\d+ loss \d+\.\d{3} \d+ imgs/sec", ln) for ln in steps)
    assert out[-1] == "done" and len(losses) == 3


@pytest.mark.parametrize("script", [train_mnist_torch, train_resnet_torch])
def test_scripts_run_on_the_card_unless_asked(script):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        script.main([])
