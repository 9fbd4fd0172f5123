"""The port's project config (devspace_tpu_torch/config/) against the JAX
package's: the loaders give equal ``to_dict`` on every example config
without a ``tpu`` block, and the four with one are refused with a
``ConfigError`` that names the ``gpu`` block; the ``gpu`` block loads,
upgrades from ``tpu/v1alpha1`` and is validated; strict parsing, merge
and split, ``${var}`` resolution, the generated cache and saving agree
with the reference's."""

import glob
import os

import pytest
import yaml

from devspace_tpu.config import loader as jloader
from devspace_tpu.config import merge as jmerge
from devspace_tpu.config import structs as jstructs
from devspace_tpu.config import variables as jvariables
from devspace_tpu.config.generated import GeneratedConfig as JGenerated
from devspace_tpu_torch.config import latest, loader, merge, structs, variables, versions
from devspace_tpu_torch.config.generated import GeneratedConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(os.path.dirname(os.path.dirname(p))
                  for p in glob.glob(os.path.join(REPO, "examples", "*", ".devspace",
                                                  "config.yaml")))
WITH_TPU = {"jax-mnist", "jax-resnet-tpu", "llama-inference", "long-context"}


def test_the_examples_are_the_ones_this_file_names():
    names = {os.path.basename(p) for p in EXAMPLES}
    assert WITH_TPU < names and len(names) >= 12
    for root in EXAMPLES:
        with open(os.path.join(root, ".devspace", "config.yaml")) as fh:
            assert ("tpu" in yaml.safe_load(fh)) == (os.path.basename(root) in WITH_TPU), root


@pytest.mark.parametrize("root", [r for r in EXAMPLES if os.path.basename(r) not in WITH_TPU],
                         ids=os.path.basename)
def test_loader_equals_the_reference_on_example(root):
    got = loader.ConfigLoader(root).load(interactive=False)
    want = jloader.ConfigLoader(root).load(interactive=False)
    assert structs.to_dict(got) == jstructs.to_dict(want)
    assert got.version == latest.VERSION == want.version
    assert loader.get_default_namespace(got) == jloader.get_default_namespace(want)
    for s in (got.dev.selectors if got.dev else None) or []:
        assert structs.to_dict(loader.get_selector(got, s.name)) == jstructs.to_dict(
            jloader.get_selector(want, s.name))


@pytest.mark.parametrize("root", [r for r in EXAMPLES if os.path.basename(r) in WITH_TPU],
                         ids=os.path.basename)
def test_a_tpu_block_is_refused_naming_the_gpu_block(root):
    with pytest.raises(structs.ConfigError, match=r"tpu: .*'gpu' block"):
        loader.ConfigLoader(root).load(interactive=False)
    # the reference loads it
    assert jloader.ConfigLoader(root).load(interactive=False).tpu is not None


def write_config(tmp_path, tree: dict, name: str = "config.yaml") -> str:
    os.makedirs(tmp_path / ".devspace", exist_ok=True)
    with open(tmp_path / ".devspace" / name, "w") as fh:
        yaml.safe_dump(tree, fh, sort_keys=False)
    return str(tmp_path)


def test_gpu_block_loads_in_chart_gpu_names(tmp_path):
    root = write_config(tmp_path, {
        "version": "tpu/v1", "gpu": {"workers": 2, "perWorker": 8, "product": "NVIDIA-H100"},
        "deployments": [{"name": "app", "chart": {"path": "./chart"}}]})
    cfg = loader.ConfigLoader(root).load(interactive=False)
    assert cfg.gpu == latest.GPUConfig(workers=2, per_worker=8, product="NVIDIA-H100")
    assert structs.to_dict(cfg)["gpu"] == {"workers": 2, "perWorker": 8,
                                           "product": "NVIDIA-H100"}
    with open(os.path.join(REPO, "devspace_tpu_torch", "generator", "templates", "chart-gpu",
                           "templates", "statefulset.yaml")) as fh:
        assert "gpu.perWorker" in fh.read()
    # the chart's defaults
    assert (latest.DEFAULT_GPU_WORKERS, latest.DEFAULT_GPU_PER_WORKER,
            latest.DEFAULT_GPU_PRODUCT) == (1, 1, "NVIDIA-H100-80GB-HBM3")


@pytest.mark.parametrize("gpu, message", [
    ({"workers": 0}, "gpu.workers must be >= 1"),
    ({"perWorker": 0}, "gpu.perWorker must be >= 1"),
    ({"workers": "two"}, "gpu.workers: expected int"),
    ({"chipsPerWorker": 4}, "unknown key 'chipsPerWorker'"),
])
def test_gpu_block_is_validated(tmp_path, gpu, message):
    root = write_config(tmp_path, {"version": "tpu/v1", "gpu": gpu})
    with pytest.raises(structs.ConfigError, match=message):
        loader.ConfigLoader(root).load(interactive=False)


def test_v1alpha1_upgrades_as_the_reference_with_its_gpu_block():
    tree = {"version": "tpu/v1alpha1",
            "deployments": [{"name": "app", "autoReload": True, "chart": {"path": "c"}}],
            "sync": [{"selector": "s", "containerPath": "/app", "localSubPath": "."}],
            "ports": [{"selector": "s", "localPort": 1, "remotePort": 2}],
            "terminal": {"selector": "s", "command": ["bash"]}}
    got = structs.to_dict(versions.parse(dict(tree, gpu={"workers": 2})))
    want = jstructs.to_dict(jloader.versions.parse(tree))
    assert got.pop("gpu") == {"workers": 2}
    assert got == want
    with pytest.raises(structs.ConfigError, match="'gpu' block"):
        versions.parse(dict(tree, tpu={"workers": 2}))
    for bad, message in (([], "must be a mapping"), ({}, "missing the 'version'"),
                         ({"version": "tpu/v9"}, "unknown config version")):
        with pytest.raises(structs.ConfigError, match=message):
            versions.parse(bad)


@pytest.mark.parametrize("data", [
    {"version": "tpu/v1", "images": {"x": {"image": "r/x", "build": {"disabled": True}}}},
    {"version": "tpu/v1", "dev": {"sync": [{"containerPath": "/a", "verifyInterval": 5}]}},
    {"version": "tpu/v1", "cluster": {"namespace": 3}},
    {"version": "tpu/v1", "bogus": 1},
    {"version": "tpu/v1", "dev": {"terminal": {"disabled": "yes"}}},
])
def test_strict_parsing_equals_the_reference(data):
    def outcome(mod, cls):
        try:
            return mod.to_dict(mod.from_dict(cls, data))
        except mod.ConfigError as e:
            return str(e)

    from devspace_tpu.config import latest as jlatest

    assert outcome(structs, latest.Config) == outcome(jstructs, jlatest.Config)


def test_merge_split_and_variables_equal_the_reference(monkeypatch):
    base = {"a": {"b": 1, "c": [1, 2]}, "d": "x"}
    over = {"a": {"b": 2, "e": {"f": 3}}, "g": None}
    assert merge.merge(base, over) == jmerge.merge(base, over)
    merged = merge.merge(base, over)
    assert merge.split(merged, over) == jmerge.split(merged, over)
    tree = {"img": "${repo}/app:${tag}", "n": "${count}", "k": ["${repo}"]}
    monkeypatch.setenv("DEVSPACE_VAR_REPO", "reg.local")
    cache_t, cache_j = {"tag": "1.0"}, {"tag": "1.0"}
    answers = []
    got = variables.resolve_vars(tree, cache_t, asker=lambda q: answers.append(q) or "7")
    want = jvariables.resolve_vars(tree, cache_j, asker=lambda q: "7")
    assert got == want and cache_t == cache_j == {"tag": "1.0", "count": "7"}
    assert answers[0].question == "Please enter a value for 'count'"
    assert variables.find_vars(tree) == jvariables.find_vars(tree) == ["repo", "tag", "count"]
    assert variables.substitute_known("${repo}:${nope}", {}) is None


def test_generated_cache_round_trips_through_both_packages(tmp_path):
    gen = GeneratedConfig(str(tmp_path))
    gen.get_cache(dev_mode=False).chart_hashes["app"] = "abc"
    gen.get_active().vars["tag"] = "1.0"
    gen.save()
    back = JGenerated.load(str(tmp_path))
    assert back.get_cache(dev_mode=False).chart_hashes == {"app": "abc"}
    assert back.get_active().vars == {"tag": "1.0"}
    again = GeneratedConfig.load(str(tmp_path))
    assert again.get_active() == gen.get_active()
    (tmp_path / ".devspace" / "generated.yaml").write_text("{{{ not yaml")
    assert GeneratedConfig.load(str(tmp_path)).configs == {}


def test_configs_yaml_overrides_save_and_find_root(tmp_path, monkeypatch):
    """Multi-config with a file-backed base and an override: the merged
    config, and ``save`` writing back the base without the override's
    values and with ``${var}`` placeholders kept, as the reference's."""
    monkeypatch.setenv("DEVSPACE_VAR_TAG", "v2")
    for pkg_loader, sub in ((loader, "port"), (jloader, "ref")):
        root = tmp_path / sub
        write_config(root, {"version": "tpu/v1", "images": {"x": {"image": "r/x",
                                                                   "tag": "${tag}"}},
                            "cluster": {"namespace": "base"}}, "base.yaml")
        write_config(root, {"default": {"config": {"path": ".devspace/base.yaml"},
                                        "overrides": [{"config": {"cluster": {
                                            "namespace": "over"}}}]}}, "configs.yaml")
        (root / "sub" / "dir").mkdir(parents=True)
        assert pkg_loader.find_root(str(root / "sub" / "dir")) == str(root)
        ld = pkg_loader.ConfigLoader(str(root))
        cfg = ld.load(interactive=False)
        assert cfg.cluster.namespace == "over" and cfg.images["x"].tag == "v2"
        cfg.images["x"].image = "r/y"
        ld.save(cfg)
    with open(tmp_path / "port" / ".devspace" / "base.yaml") as a, \
            open(tmp_path / "ref" / ".devspace" / "base.yaml") as b:
        saved = a.read()
        assert saved == b.read()
    assert "${tag}" in saved and "over" not in saved and "r/y" in saved
