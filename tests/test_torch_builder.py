"""The port's builder/ against the JAX package's: ``build_all``'s rebuild
and skip decisions and its cache, the build context tarball, registry
and docker-auth parsing and the pull secrets, each on the same inputs;
the reference's builder tests on the port; and the one intended
difference: where the reference would pick its in-cluster Kaniko
builder, the port's ``create_builder`` raises."""

import base64
import dataclasses
import io
import itertools
import json
import os
import tarfile
import time

import pytest

from devspace_tpu.builder import builders as jbuilders
from devspace_tpu.builder import dockerclient as jdocker
from devspace_tpu.builder import images as jimages
from devspace_tpu.builder import registry as jregistry
from devspace_tpu.config.generated import CacheConfig as JCacheConfig
from devspace_tpu.config.loader import ConfigLoader as JLoader
from devspace_tpu.kube.fake import FakeCluster as JFakeCluster
from devspace_tpu_torch.builder import builders, dockerclient, images, registry
from devspace_tpu_torch.builder.builders import FakeBuilder
from devspace_tpu_torch.config import latest
from devspace_tpu_torch.config.generated import CacheConfig
from devspace_tpu_torch.config.loader import ConfigLoader
from devspace_tpu_torch.kube.fake import FakeCluster
from devspace_tpu_torch.utils.fsutil import write_file

CONFIG = """\
version: tpu/v1
images:
  default:
    image: gcr.io/p/app
    dockerfile: Dockerfile
    context: .
  pinned:
    image: gcr.io/p/pinned
    tag: v1
    dockerfile: Dockerfile
    context: sub
    skipPush: true
    build:
      options:
        buildArgs: {A: "1"}
        target: final
  off:
    image: gcr.io/p/off
    build:
      disabled: true
dev:
  overrideImages:
    - name: default
      entrypoint: ["sleep", "999999999"]
"""


def _project(root):
    write_file(os.path.join(root, ".devspace", "config.yaml"), CONFIG)
    write_file(os.path.join(root, "Dockerfile"), "FROM python:3.12\nCMD ['x']\n")
    write_file(os.path.join(root, "src", "app.py"), "print(1)")
    write_file(os.path.join(root, "sub", "Dockerfile"), "FROM scratch\n")
    write_file(os.path.join(root, "sub", "x.txt"), "x")
    write_file(os.path.join(root, ".dockerignore"), "*.log\n")


def _bump(path, seconds):
    t = time.time() + seconds
    os.utime(path, (t, t))


def _tags(monkeypatch, module):
    counter = itertools.count()
    monkeypatch.setattr(module, "random_string", lambda n=7: f"{next(counter):0{n}d}")


def test_build_all_decides_and_caches_as_the_reference(tmp_path, monkeypatch):
    """The same config, edits and flags through both packages'
    ``build_all``: the same builds (with the same arguments), tags, skips
    and cache, ``random_string`` fixed in both."""
    root = str(tmp_path)
    _project(root)
    _tags(monkeypatch, jimages)
    _tags(monkeypatch, images)
    jcfg = JLoader(root).load(interactive=False)
    cfg = ConfigLoader(root).load(interactive=False)
    jcache, cache = JCacheConfig(), CacheConfig()

    def both(**kw):
        jb, b = jbuilders.FakeBuilder(), FakeBuilder()
        want = jimages.build_all(jcfg, jcache, base_dir=root,
                                 builder_factory=lambda _: jb, **kw)
        got = images.build_all(cfg, cache, base_dir=root, builder_factory=lambda _: b, **kw)
        assert got == want
        assert (b.builds, b.pushes) == (jb.builds, jb.pushes)
        assert dataclasses.asdict(cache) == dataclasses.asdict(jcache)
        return got, b

    tags, b = both(dev_mode=True)
    assert len(b.builds) == 2 and b.builds[0]["entrypoint_override"] == ["sleep", "999999999"]
    assert tags == {"default": "gcr.io/p/app:0000000", "pinned": "gcr.io/p/pinned:v1"}
    assert b.pushes == [("gcr.io/p/app", "0000000")]  # pinned skips its push
    _, b = both(dev_mode=True)
    assert b.builds == []  # unchanged: both skipped
    write_file(os.path.join(root, "src", "app.py"), "print(2)")
    _bump(os.path.join(root, "src", "app.py"), 5)
    _, b = both()
    assert [x["image"] for x in b.builds] == ["gcr.io/p/app"]  # only its context changed
    _bump(os.path.join(root, "sub", "Dockerfile"), 10)
    _, b = both()  # sub/ lies in both contexts
    assert [x["image"] for x in b.builds] == ["gcr.io/p/app", "gcr.io/p/pinned"]
    _, b = both(force=True)
    assert len(b.builds) == 2


def test_build_all_with_cache(tmp_path):
    write_file(str(tmp_path / "Dockerfile"), "FROM python:3.12\nCMD ['x']\n")
    write_file(str(tmp_path / "src" / "app.py"), "print(1)")
    cfg = latest.Config(
        version=latest.VERSION,
        images={"default": latest.ImageConfig(image="gcr.io/p/app", dockerfile="Dockerfile",
                                              context=".")},
        dev=latest.DevConfig(override_images=[
            latest.ImageOverrideConfig(name="default", entrypoint=["sleep", "999999999"])]),
    )
    cache = CacheConfig()
    builder = FakeBuilder()
    tags = images.build_all(cfg, cache, dev_mode=True, base_dir=str(tmp_path),
                            builder_factory=lambda _: builder)
    assert len(builder.builds) == 1 and tags["default"].startswith("gcr.io/p/app:")
    tag1 = cache.image_tags["default"]
    assert len(tag1) == 7
    builder2 = FakeBuilder()
    tags2 = images.build_all(cfg, cache, dev_mode=True, base_dir=str(tmp_path),
                             builder_factory=lambda _: builder2)
    assert builder2.builds == [] and tags2["default"].endswith(tag1)
    write_file(str(tmp_path / "src" / "app.py"), "print(2)")
    _bump(str(tmp_path / "src" / "app.py"), 5)
    builder3 = FakeBuilder()
    images.build_all(cfg, cache, base_dir=str(tmp_path), builder_factory=lambda _: builder3)
    assert len(builder3.builds) == 1 and builder3.builds[0]["entrypoint_override"] is None
    assert cache.image_tags["default"] != tag1


def _members(blob):
    """(name, type, size, bytes) of each member of a gzipped tar, in
    order: the gzip header holds a time, so the blobs differ."""
    with tarfile.open(fileobj=io.BytesIO(blob), mode="r:gz") as tf:
        return [(m.name, m.type, m.size,
                 tf.extractfile(m).read() if m.isfile() else None) for m in tf.getmembers()]


@pytest.mark.parametrize("case", ["plain", "outside", "override"])
def test_build_context_has_the_same_members(tmp_path, case):
    ctx = tmp_path / "ctx"
    write_file(str(ctx / "Dockerfile"), "FROM scratch\n")
    write_file(str(ctx / "app" / "main.py"), "print('hi')\n")
    write_file(str(ctx / "app" / "debug.log"), "noise")
    write_file(str(ctx / "build" / "out.bin"), "artifact")
    write_file(str(ctx / "keep" / "a.txt"), "a")
    write_file(str(ctx / ".dockerignore"), "*.log\nbuild/\n")
    write_file(str(tmp_path / "Dockerfile.other"), "FROM busybox\n")
    kw = {"plain": {}, "outside": {"dockerfile_path": str(tmp_path / "Dockerfile.other")},
          "override": {"dockerfile_override": b"FROM alpine\nENTRYPOINT [\"sleep\"]\n"}}[case]
    want = _members(jdocker.DockerClient.make_build_context(str(ctx), **kw))
    got = _members(dockerclient.DockerClient.make_build_context(str(ctx), **kw))
    assert got == want
    names = [m[0] for m in got]
    assert "app/debug.log" not in names and not any(n.startswith("build") for n in names)
    assert names.count("Dockerfile") == 1


@pytest.mark.parametrize("image", ["gcr.io/p/app", "nginx", "library/nginx:1.25",
                                   "localhost:5000/app", "localhost/app", "my.reg:443/a/b:c",
                                   "user/repo"])
def test_registry_from_image_equals_the_reference(image):
    assert dockerclient.registry_from_image(image) == jdocker.registry_from_image(image)
    assert registry.secret_name(dockerclient.registry_from_image(image)) == \
        jregistry.secret_name(jdocker.registry_from_image(image))


def test_docker_auths_equal_the_reference(tmp_path, monkeypatch):
    cfg = {"auths": {"gcr.io": {"auth": base64.b64encode(b"u:p:q").decode()},
                     "docker.io": {"username": "x", "password": "y"},
                     "bad.io": {"auth": "!!notbase64"}}}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    monkeypatch.setenv("DOCKER_CONFIG", str(tmp_path))
    got = dockerclient.load_docker_auths()
    assert got == jdocker.load_docker_auths()
    assert got["gcr.io"]["username"] == "u" and got["gcr.io"]["password"] == "p:q"
    # a credential helper that is not installed gives nothing in both
    (tmp_path / "config.json").write_text(json.dumps({"credsStore": "no-such-helper"}))
    assert dockerclient.load_docker_auths() == jdocker.load_docker_auths() == {}
    # save then load round-trips in both
    path = dockerclient.save_docker_auth("r.io", "a", "b", str(tmp_path / "c2.json"))
    assert jdocker.load_docker_auths(path)["r.io"]["password"] == "b"


def test_pull_secrets_equal_the_reference(tmp_path, monkeypatch):
    docker_dir = tmp_path / "docker"
    docker_dir.mkdir()
    (docker_dir / "config.json").write_text(json.dumps(
        {"auths": {"gcr.io": {"auth": base64.b64encode(b"u:p").decode()}}}))
    monkeypatch.setenv("DOCKER_CONFIG", str(docker_dir))
    root = str(tmp_path / "proj")
    write_file(os.path.join(root, ".devspace", "config.yaml"), """\
version: tpu/v1
images:
  default: {image: gcr.io/p/app, createPullSecret: true}
  other: {image: quay.io/p/b, createPullSecret: true}
deployments:
  - name: x
    namespace: other
    manifests: {paths: []}
""")
    jfc, fc = JFakeCluster(str(tmp_path / "a")), FakeCluster(str(tmp_path / "b"))
    want = jregistry.init_registries(jfc, JLoader(root).load(interactive=False), "default")
    got = registry.init_registries(fc, ConfigLoader(root).load(interactive=False), "default")
    assert got == want == ["devspace-auth-gcr-io"]  # no local creds for quay.io
    assert fc.objects == jfc.objects and fc.namespaces == jfc.namespaces
    secret = fc.get_object("v1", "Secret", "devspace-auth-gcr-io", "other")
    assert secret["type"] == "kubernetes.io/dockerconfigjson"
    data = json.loads(base64.b64decode(secret["data"][".dockerconfigjson"]))
    assert data["auths"]["gcr.io"]["username"] == "u"


def test_entrypoint_override_equals_the_reference():
    df = "FROM python:3.12\nENTRYPOINT [\"python\"]\ncmd [\"app.py\"]\nRUN x\n"
    out = builders.apply_entrypoint_override(df, ["sleep", "inf"])
    assert out == jbuilders.apply_entrypoint_override(df, ["sleep", "inf"])
    assert 'ENTRYPOINT ["sleep", "inf"]' in out and out.count("ENTRYPOINT") == 1
    assert "cmd" not in out and "RUN x" in out


class _Cluster:
    """A backend that is not the fake."""


def test_create_builder_never_picks_another_builder(monkeypatch):
    """The builder the reference picks, for each case: ``FakeBuilder`` on
    the fake backend; ``KanikoBuilder`` for a configured ``build.kaniko``
    (its namespace, pull secret, cache and image from the config, else
    the caller's and the defaults) and as the fallback when docker is
    unreachable and a backend exists; docker when it answers; no backend
    and no docker raises as in the reference."""
    from devspace_tpu.config import latest as jlatest

    kaniko = latest.ImageConfig(image="gcr.io/p/app", build=latest.BuildConfig(
        kaniko=latest.KanikoConfig(cache=False, namespace="build", image="kaniko:v1")))
    plain = latest.ImageConfig(image="gcr.io/p/app")
    jkaniko = jlatest.ImageConfig(image="gcr.io/p/app", build=jlatest.BuildConfig(
        kaniko=jlatest.KanikoConfig(cache=False, namespace="build", image="kaniko:v1")))
    assert isinstance(images.create_builder(kaniko, FakeCluster("/nonexistent-fake")),
                      FakeBuilder)

    def fields(b):
        return (type(b).__name__, b.namespace, b.pull_secret, b.cache, b.kaniko_image)

    for available in (True, False):
        monkeypatch.setattr(builders.DockerBuilder, "available", lambda self: available)
        monkeypatch.setattr(jbuilders.DockerBuilder, "available", lambda self: available)
        got = images.create_builder(kaniko, _Cluster(), namespace="dev", pull_secret="regcred")
        want = jimages.create_builder(jkaniko, _Cluster(), namespace="dev",
                                      pull_secret="regcred")
        assert isinstance(got, builders.KanikoBuilder) and fields(got) == fields(want)
        assert fields(got) == ("KanikoBuilder", "build", "regcred", False, "kaniko:v1")
    monkeypatch.setattr(builders.DockerBuilder, "available", lambda self: False)
    fallback = images.create_builder(plain, _Cluster(), namespace="dev")
    assert fields(fallback) == ("KanikoBuilder", "dev", None, True, builders.KANIKO_IMAGE)
    assert builders.KANIKO_IMAGE == jbuilders.KANIKO_IMAGE
    no_fallback = latest.ImageConfig(image="x", build=latest.BuildConfig(
        docker=latest.DockerConfig(disable_fallback=True)))
    with pytest.raises(RuntimeError, match="no build engine"):
        images.create_builder(no_fallback, _Cluster())
    with pytest.raises(RuntimeError, match="no build engine"):
        images.create_builder(plain, None)
    monkeypatch.setattr(builders.DockerBuilder, "available", lambda self: True)
    assert isinstance(images.create_builder(plain, _Cluster()), builders.DockerBuilder)
