"""The port's scaffold (devspace_tpu_torch/generator/): language detection
with a torch sniff, the Dockerfile and chart each language gets, and the
GPU chart rendered through the port's own chart renderer
(``devspace_tpu_torch.deploy.chart.render_chart``) at one and two
workers, its sizes from the ``gpu`` render context: equal to the JAX
package's renderer on the same context, clean under both packages' DS1xx
packs and the port's GPU job rules, NODE_RANK from the pod index,
``nvidia.com/gpu`` at ``perWorker``, torchrun's flags from the context.
The torch Dockerfile is clean under the port's image pack, which flags
the GPU image faults it exists for."""

import os

import pytest

import devspace_tpu.lint as jlint
import devspace_tpu_torch.lint as tlint
from devspace_tpu.deploy.chart import render_chart as jrender_chart
from devspace_tpu.generator import generator as jgen
from devspace_tpu_torch.config.latest import GPUConfig
from devspace_tpu_torch.deploy.chart import gpu_context, render_chart
from devspace_tpu_torch.generator import generator as gen
from devspace_tpu_torch.lint import lint_dockerfile

TEMPLATES = gen.TEMPLATES_DIR
GPU_CHART = os.path.join(TEMPLATES, "chart-gpu")


def write(root, files: dict):
    for rel, text in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            fh.write(text)
    return str(root)


@pytest.mark.parametrize("files, language", [
    ({"train.py": "import torch\n", "util.py": "x = 1\n"}, "torch"),
    ({"src/k.py": "from triton import language as tl\n"}, "torch"),
    ({"a.js": "", "b.js": "", "c.py": ""}, "node"),
    ({"main.go": "package main\n"}, "go"),
    ({"train.py": "import jax\n"}, "python"),  # the port ships no TPU chart
    ({"node_modules/x.py": "import torch\n", "README.md": ""}, "python"),
])
def test_detect_language(tmp_path, files, language):
    assert gen.detect_language(write(tmp_path, files)) == language


def test_scaffolds_copy_the_templates_and_keep_existing(tmp_path):
    for language, chart in (("torch", "chart-gpu"), ("python", "chart-cpu"),
                            ("node", "chart-cpu")):
        root = tmp_path / language
        root.mkdir()
        dockerfile = gen.create_dockerfile(str(root), language)
        with open(dockerfile) as fh, open(os.path.join(TEMPLATES, "dockerfiles", language,
                                                       "Dockerfile")) as want:
            assert fh.read() == want.read()
        dest = gen.create_chart(str(root), language)
        assert sorted(os.listdir(os.path.join(dest, "templates"))) == sorted(
            os.listdir(os.path.join(TEMPLATES, chart, "templates")))
        (root / "Dockerfile").write_text("FROM mine\n")
        assert gen.create_dockerfile(str(root), language) == dockerfile
        assert (root / "Dockerfile").read_text() == "FROM mine\n"
        assert gen.create_chart(str(root), language) == dest
    # an unknown language falls back to python's Dockerfile, as the reference's
    root = tmp_path / "rust"
    root.mkdir()
    with open(gen.create_dockerfile(str(root), "rust")) as fh:
        assert fh.read().startswith("FROM python:3.12-slim")


def test_shared_templates_equal_the_reference():
    ref = os.path.join(os.path.dirname(jgen.__file__), "templates")
    for rel in ["dockerfiles/python/Dockerfile", "dockerfiles/node/Dockerfile",
                "dockerfiles/go/Dockerfile"] + [
            os.path.join("chart-cpu", d, f) for d, f in (
                ("", "chart.yaml"), ("", "values.yaml"), ("templates", "deployment.yaml"),
                ("templates", "service.yaml"), ("templates", "hpa.yaml"),
                ("templates", "volumes.yaml"))]:
        with open(os.path.join(TEMPLATES, rel)) as a, open(os.path.join(ref, rel)) as b:
            assert a.read() == b.read(), rel


def rendered(values: dict, gpu: GPUConfig = None, render=render_chart) -> list:
    return render(GPU_CHART, release_name="app", namespace="ml", values=values,
                  extra_context={"gpu": gpu_context(gpu)})


@pytest.mark.parametrize("workers, per_worker", [(1, 1), (2, 4)])
def test_gpu_chart_renders_and_lints_clean(workers, per_worker):
    gpu = GPUConfig(workers=workers, per_worker=per_worker)
    values = {"persistence": {"volumes": [{"name": "ckpt", "size": "50Gi"}],
                              "mounts": [{"name": "ckpt", "mountPath": "/ckpt"}]}}
    docs = rendered(values, gpu)
    # the JAX package's renderer gives the same objects on the same context
    assert docs == rendered(values, gpu, render=jrender_chart)
    assert sorted(d["kind"] for d in docs) == ["PodDisruptionBudget", "Service", "StatefulSet"]
    got = tlint.lint_docs(docs, gpu=gpu, artifact="chart-gpu")
    want = jlint.lint_docs(docs, artifact="chart-gpu", categories={"manifest", "hygiene"})
    assert got == [] and want == [] and jlint.lint_docs(docs) == []
    sts = next(d for d in docs if d["kind"] == "StatefulSet")
    assert sts["spec"]["replicas"] == workers and sts["spec"]["serviceName"] == "app"
    pod = sts["spec"]["template"]["spec"]
    (c,) = pod["containers"]
    env = {e["name"]: e for e in c["env"]}
    assert env["NODE_RANK"]["valueFrom"]["fieldRef"]["fieldPath"] == (
        "metadata.labels['apps.kubernetes.io/pod-index']")
    assert c["resources"] == {"requests": {"nvidia.com/gpu": per_worker},
                              "limits": {"nvidia.com/gpu": per_worker}}
    assert c["command"] == ["torchrun", f"--nnodes={workers}",
                            f"--nproc-per-node={per_worker}", "--node-rank=$(NODE_RANK)",
                            "--master-addr=app-0.app", "--master-port=29500"]
    assert c["args"] == ["train.py"]
    assert pod["tolerations"][0]["key"] == "nvidia.com/gpu"
    assert sts["spec"]["volumeClaimTemplates"][0]["metadata"]["name"] == "ckpt"
    svc = next(d for d in docs if d["kind"] == "Service")
    assert svc["spec"]["clusterIP"] == "None"
    assert {p["port"] for p in svc["spec"]["ports"]} == {8080, 29500}
    assert not any("google.com/tpu" in str(d) for d in docs)


def test_gpu_chart_hpa_for_one_worker_serving():
    docs = rendered({"autoscaling": {"horizontal": {"maxReplicas": 4, "averageCPU": 70}}})
    (hpa,) = [d for d in docs if d["kind"] == "HorizontalPodAutoscaler"]
    assert hpa["spec"]["scaleTargetRef"] == {"apiVersion": "apps/v1", "kind": "StatefulSet",
                                             "name": "app"}
    assert tlint.lint_docs(docs) == [] == jlint.lint_docs(docs)


def dockerfile(name: str) -> str:
    with open(os.path.join(TEMPLATES, "dockerfiles", name, "Dockerfile")) as fh:
        return fh.read()


def test_torch_dockerfile_is_clean_under_the_gpu_image_pack():
    assert lint_dockerfile(dockerfile("torch"), gpu_flavor=True) == []
    for name in ("python", "node", "go"):
        assert lint_dockerfile(dockerfile(name)) == []


@pytest.mark.parametrize("text, ids", [
    # a -runtime base has no nvcc; a CPU wheel never sees the card
    ("FROM nvidia/cuda:12.4.1-runtime-ubuntu22.04\n"
     "RUN pip install torch --index-url https://download.pytorch.org/whl/cpu\n"
     'CMD ["python", "serve.py"]\n', ["IMG401", "IMG401"]),
    ("FROM python:3.12-slim\nRUN pip install torch\nCMD [\"python\", \"a.py\"]\n", ["IMG401"]),
    ("FROM nvidia/cuda:12.4.1-devel-ubuntu22.04\nCMD [\"python\", \"a.py\"]\n", ["IMG401"]),
    ("FROM nvidia/cuda:12.4.1-runtime-ubuntu22.04\nRUN apt-get install -y cuda-nvcc-12-4 "
     "&& pip install torch\nENTRYPOINT [\"torchrun\"]\nCMD [\"a.py\"]\n", []),
    ("FROM pytorch/pytorch:2.4.1-cuda12.4-cudnn9-devel\nRUN pip install 'jax[tpu]'\n"
     'CMD ["python", "a.py"]\n', ["IMG402"]),
    ("FROM pytorch/pytorch:2.4.1-cuda12.4-cudnn9-devel\nENV TPU_WORKER_ID=0\n"
     'CMD ["bash"]\n', ["IMG402", "IMG404"]),
    ("FROM pytorch/pytorch:2.4.1-cuda12.4-cudnn9-devel\n", ["IMG403"]),
    ("RUN pip install torch\n", ["IMG401", "IMG402", "IMG403"]),
])
def test_gpu_image_faults(text, ids):
    assert sorted(f.rule_id for f in lint_dockerfile(text, gpu_flavor=True)) == ids
