"""The command a rendered ``chart-gpu`` gives its pods, run on the CPU: a
torch project scaffolded as chip_smoke's ``deploy`` phase scaffolds it,
at ``gpu: {workers: 2}``, loaded and preflighted by the port and
rendered by its chart renderer; both pods' containers run here as two
torchrun processes (``NODE_RANK`` 0 and 1, the master at ``127.0.0.1``,
``--device=cpu``), forming a gloo world of two that trains the MNIST
example a few steps. Both exit 0, and each step's loss equals a world
of one's at the same global batch of 256, within ``LOSS_RTOL``."""

import os
import sys

import pytest
import torch

import chip_smoke as cs
import devspace_tpu_torch.lint as tlint
from devspace_tpu_torch.deploy.chart import ChartDeployer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "scripts"))
import train_mnist_torch  # noqa: E402

STEPS = 6
# two ranks sum their halves of the batch's gradient where one process
# reduces all 256 rows: float32 summation order, through Adam's steps
LOSS_RTOL = 1e-5
POD_TIMEOUT_S = 240  # a pod that runs longer is killed and the test fails


@pytest.fixture
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_two_rendered_pods_train_as_one_world(tmp_path, few_torch_threads):
    root = str(tmp_path)
    args = ["train.py", "--steps", str(STEPS), "--log-every", "1"]
    cs.deploy_project(root, args, {"workers": 2, "perWorker": 1})
    project = tlint.load_project(root)
    findings, _ = tlint.collect_project_findings(project)
    assert not tlint.has_errors(findings), [f.legacy() for f in findings]
    (deployment,) = project.config.deployments
    docs = ChartDeployer(None, deployment, project.namespace,
                         base_dir=project.root).render_manifests(gpu=project.config.gpu)
    (sts,) = [d for d in docs if d["kind"] == "StatefulSet"]
    assert sts["spec"]["replicas"] == 2

    port = cs.free_port()
    procs = []
    try:
        for rank in (0, 1):
            argv, env, subs = cs.pod_command(sts, rank, port, root)
            assert argv[-len(args):] == args and env == {"NODE_RANK": str(rank)}
            assert f"--node-rank={rank}" in argv and "--nnodes=2" in argv
            assert "--master-addr=127.0.0.1" in argv and f"--master-port={port}" in argv
            procs.append(cs.run_pod(argv + ["--device=cpu"], {**env, "OMP_NUM_THREADS": "2"},
                                    root))
        pods = [cs.pod_result(p, POD_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, pod in enumerate(pods):
        assert pod["rc"] == 0, pod["tail"]
        assert pod["launches"] == 0  # the plain path on the CPU launches no kernel
        assert len(pod["losses"]) == STEPS
    lead = pods[0]
    assert lead["done"] and lead["world"].endswith("backend gloo, world 2"), lead["tail"]
    # the global loss of each step is the same on both ranks
    assert pods[1]["losses"] == lead["losses"]

    one = train_mnist_torch.main(["--device", "cpu", "--steps", str(STEPS), "--log-every", "1"])
    assert lead["losses"] == pytest.approx(one, rel=LOSS_RTOL)
    assert one[-1] < one[0]
