"""Two copies of chip_smoke.py's ``deploy`` phase at once on one host, as
two checkouts of the repo run their CPU rehearsals side by side: each
hands the rendered chart's torchrun a master port, and both must train.
With a fixed port (torchrun's default 29500, which the phase used to
prefer) the second torchrun to bind it fails with EADDRINUSE. Its own
file, so that ``--dist loadfile`` puts it beside the other rehearsals."""

import threading

import torch

import chip_smoke as cs


def test_two_deploy_phases_at_once_each_train(monkeypatch):
    monkeypatch.setitem(cs.DEPLOY, "steps", 101)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # two trainers share the host's cores
    lines, errors = [], []

    def phase():
        try:
            lines.append(cs.phase_deploy(torch.device("cpu"), "cpu"))
        except BaseException as e:  # noqa: BLE001 — re-raised below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=phase) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(cs.DEPLOY["timeout_s"] + 60)
    assert not errors, errors[0]
    ports = [line["argv"][5] for line in lines]
    assert len(lines) == 2 and ports[0] != ports[1], ports
    assert all(line["loss_at_check_step"] < cs.DEPLOY["below"] for line in lines)
