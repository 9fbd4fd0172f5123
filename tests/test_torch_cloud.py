"""The port's ``cloud/`` held against the reference's on one fake control
plane (``test_cloud.FakeCloud``, a stdlib GraphQL server speaking the
``manager_*`` contract): the provider registry (each package reads the
other's ``clouds.yaml``), key login and token refresh, a bad key, no
login, Space CRUD, ``bind_space`` (the kubeconfig and the generated cache
byte for byte the reference's), ``configure``'s refresh, no-op and
unreachable-provider fallback, registry auth, the CLI context's namespace
and kube context from a bound Space, and the cloud commands of both CLIs,
whose stdout must be equal line for line.

The fake mints its tokens with ``test_cloud.make_jwt``; the fixture pins
it to one token so that the files both packages write can be compared
byte for byte."""

import argparse
import base64
import http.server
import json
import os
import re
import sys
import threading

import pytest

import test_cloud
from test_cloud import VALID_KEY, FakeCloud, make_jwt

from devspace_tpu.cli.context import Context as JContext
from devspace_tpu.cli.main import main as jmain
from devspace_tpu.cloud import config as jconfig
from devspace_tpu.cloud import configure as jconfigure
from devspace_tpu.cloud import provider as jprovider
from devspace_tpu.config.generated import GeneratedConfig as JGeneratedConfig
from devspace_tpu.utils import log as jlogutil
from devspace_tpu_torch.cli.context import Context
from devspace_tpu_torch.cli.main import main
from devspace_tpu_torch.cloud import config, configure, provider
from devspace_tpu_torch.cloud.config import CloudProvider, ProviderRegistry
from devspace_tpu_torch.cloud.provider import CloudError, Provider, token_valid
from devspace_tpu_torch.config.generated import GeneratedConfig
from devspace_tpu_torch.kube.kubeconfig import KubeConfig
from devspace_tpu_torch.utils import log as logutil

TOKEN = make_jwt(10 * 365 * 86400.0)


class _Stdout:
    """Whatever ``sys.stdout`` is when a line is written (capture swaps it
    between a fixture's set-up and the test)."""

    def write(self, text):
        sys.stdout.write(text)

    def flush(self):
        sys.stdout.flush()

    def isatty(self):
        return False


@pytest.fixture
def cloud_env(tmp_path, monkeypatch):
    FakeCloud.spaces = {}
    FakeCloud.next_id = 1
    monkeypatch.setattr(test_cloud, "make_jwt", lambda exp_offset=3600.0: TOKEN)
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), FakeCloud)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    host = f"http://127.0.0.1:{server.server_address[1]}"
    for var, name in (("DEVSPACE_CLOUD_CONFIG", "clouds.yaml"), ("KUBECONFIG", "kubeconfig"),
                      ("DOCKER_CONFIG", "docker")):
        monkeypatch.setenv(var, str(tmp_path / name))
    monkeypatch.setenv("DEVSPACE_NONINTERACTIVE", "1")
    monkeypatch.delenv("DEVSPACE_FAKE_BACKEND", raising=False)
    monkeypatch.delenv("DEVSPACE_RELEASE_DIR", raising=False)
    logutil.set_logger(logutil.StdoutLogger(stream=_Stdout()))
    jlogutil.set_logger(jlogutil.StdoutLogger(stream=_Stdout()))
    registry = ProviderRegistry.load()
    registry.providers["test"] = CloudProvider(name="test", host=host)
    registry.default = "test"
    registry.save()
    yield {"host": host, "tmp": tmp_path}
    server.shutdown()
    server.server_close()


def _provider(key=VALID_KEY) -> Provider:
    registry = ProviderRegistry.load()
    entry = registry.get("test")
    entry.key = key
    return Provider(entry, registry)


def _jprovider(key=VALID_KEY):
    registry = jconfig.ProviderRegistry.load()
    entry = registry.get("test")
    entry.key = key
    return jprovider.Provider(entry, registry)


def _read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def test_jwt_claims_and_validity_equal_the_reference():
    tokens = [make_jwt(3600), make_jwt(-10), make_jwt(60), "garbage", None, "a.b.c",
              "x." + base64.urlsafe_b64encode(b'{"sub": "no-exp"}').decode().rstrip("=") + ".s"]
    for token in tokens:
        assert provider.token_valid(token) == jprovider.token_valid(token), token
        assert provider.token_valid(token, slack=0) == jprovider.token_valid(token, slack=0)
        try:
            want = jprovider.parse_token_claims(token or "")
        except jprovider.CloudError as e:
            with pytest.raises(CloudError, match=re.escape(str(e)[:20])):
                provider.parse_token_claims(token or "")
        else:
            assert provider.parse_token_claims(token) == want
    assert config.DEFAULT_PROVIDER_NAME == jconfig.DEFAULT_PROVIDER_NAME
    assert config.DEFAULT_PROVIDER_HOST == jconfig.DEFAULT_PROVIDER_HOST


def test_registry_round_trip_between_the_packages(cloud_env, tmp_path):
    registry = ProviderRegistry.load()
    assert set(registry.providers) == {"test", config.DEFAULT_PROVIDER_NAME}
    with pytest.raises(KeyError, match="not found"):
        registry.get("nope")
    # the reference reads what the port wrote, and the port what it writes
    jreg = jconfig.ProviderRegistry.load()
    assert jreg.default == "test" and jreg.get("test").host == cloud_env["host"]
    jreg.providers["test"].key, jreg.providers["test"].token = "k", "t"
    jreg.providers["alt"] = jconfig.CloudProvider(name="alt", host="http://alt")
    jreg.save()
    back = ProviderRegistry.load()
    assert [(p.name, p.host, p.key, p.token) for p in back.providers.values()] == \
        [(p.name, p.host, p.key, p.token) for p in jreg.providers.values()]
    # both save the same registry to the same bytes
    back.save(), jreg.save()
    mine = _read(os.environ["DEVSPACE_CLOUD_CONFIG"])
    jreg.path = str(tmp_path / "ref.yaml")
    jreg.save()
    assert mine == _read(tmp_path / "ref.yaml")


def test_key_login_and_token_refresh(cloud_env):
    p = _provider(key=None)
    p.login(key=VALID_KEY)
    assert p.entry.token == TOKEN
    saved = jconfig.ProviderRegistry.load().get("test")  # persisted, readable by the reference
    assert (saved.key, saved.token) == (VALID_KEY, TOKEN)
    p.entry.token = make_jwt(-10)  # an expired cached token is minted again
    assert p.token() == TOKEN and token_valid(p.token())


def test_a_bad_key_and_no_login_fail_as_the_reference(cloud_env):
    for make, error in ((_provider, CloudError), (_jprovider, jprovider.CloudError)):
        with pytest.raises(error, match="invalid access key"):
            make(key=None).login(key="wrong")
        p = make(key=None)
        p.entry.token = None
        with pytest.raises(error, match="not logged in to provider 'test'"):
            p.token()
    p = _provider(key=None)
    p.entry.token = None
    with pytest.raises(CloudError, match="devspace-tpu-torch login"):
        p.token()


def test_space_crud(cloud_env):
    p, jp = _provider(), _jprovider()
    space = p.create_space("dev1")
    assert (space.space_id, space.namespace, space.domain) == (1, "space-dev1",
                                                              "dev1.spaces.test")
    assert [s.__dict__ for s in jp.get_spaces()] == [s.__dict__ for s in p.get_spaces()]
    assert p.get_space("dev1").space_id == p.get_space("1").space_id == 1
    with pytest.raises(CloudError, match="space 'ghost' not found on provider 'test'"):
        p.get_space("ghost")
    p.delete_space(space.space_id)
    assert p.get_spaces() == [] and FakeCloud.spaces == {}


@pytest.mark.parametrize("bind_with", ["port", "reference"])
def test_bind_space_writes_the_reference_kubeconfig(cloud_env, tmp_path, monkeypatch,
                                                    bind_with):
    """The port's binding and the reference's, each from a fresh fake,
    write the same kubeconfig and generated cache; each package reads
    the binding the other wrote."""
    written = {}
    for who, make, gen_cls, bind in (
            ("port", _provider, GeneratedConfig, configure.bind_space),
            ("reference", _jprovider, JGeneratedConfig, jconfigure.bind_space)):
        FakeCloud.spaces, FakeCloud.next_id = {}, 1
        kube = tmp_path / f"kube-{who}"
        monkeypatch.setenv("KUBECONFIG", str(kube))
        p = make()
        gen = gen_cls(str(tmp_path / who))
        assert bind(p, p.create_space("dev2"), gen) == "devspace-dev2"
        written[who] = (_read(kube), _read(tmp_path / who / ".devspace" / "generated.yaml"))
    assert written["port"] == written["reference"]
    kc = KubeConfig.load(str(tmp_path / f"kube-{bind_with}"))
    assert kc.current_context == "devspace-dev2"
    cluster, user, ctx = kc.resolve()
    assert (cluster.server, cluster.ca_data, ctx.namespace) == ("https://1.2.3.4:6443",
                                                                b"FAKE-CA", "space-dev2")
    assert token_valid(user.token, slack=0)
    space = GeneratedConfig.load(str(tmp_path / bind_with)).space
    assert (space.name, space.provider_name, space.namespace) == ("dev2", "test", "space-dev2")
    configure.remove_kube_context("dev2", str(tmp_path / f"kube-{bind_with}"))
    kc = KubeConfig.load(str(tmp_path / f"kube-{bind_with}"))
    assert "devspace-dev2" not in kc.contexts and kc.current_context == ""


def test_configure_refresh_noop_and_unreachable_fallback(cloud_env, tmp_path, capsys):
    p = _provider()
    gen = GeneratedConfig(str(tmp_path))
    configure.bind_space(p, p.create_space("dev3"), gen)
    assert configure.configure(GeneratedConfig(str(tmp_path / "other"))) is None
    # a stale token is refreshed and saved; the kubeconfig is rewritten
    gen.space.token = make_jwt(-10)
    assert configure.configure(gen) == "devspace-dev3"
    assert gen.space.token == TOKEN
    assert GeneratedConfig.load(str(tmp_path)).space.token == TOKEN
    # a fresh token needs no call: the provider's host is unreachable now
    registry = ProviderRegistry.load()
    registry.providers["test"].host = "http://127.0.0.1:1"
    registry.save()
    assert configure.configure(gen) == "devspace-dev3"
    # a stale token with the provider unreachable keeps the cached context
    gen.space.token = make_jwt(-10)
    jgen = JGeneratedConfig.load(str(tmp_path))
    jgen.space.token = gen.space.token
    capsys.readouterr()
    assert configure.configure(gen) == jconfigure.configure(jgen) == "devspace-dev3"
    warned = [ln for ln in capsys.readouterr().out.splitlines() if "could not refresh" in ln]
    assert len(warned) == 2 and warned[0] == warned[1], warned


def test_registry_auth(cloud_env):
    auth = _provider().get_registry_auth()
    assert auth == _jprovider().get_registry_auth() == {
        "registry": "registry.test", "username": "sa", "password": "pw"}


def test_context_namespace_and_kube_context_from_a_bound_space(cloud_env, tmp_path,
                                                               monkeypatch):
    p = _provider()
    proj = tmp_path / "nsproj"
    (proj / ".devspace").mkdir(parents=True)
    (proj / ".devspace" / "config.yaml").write_text("version: tpu/v1\n")
    monkeypatch.chdir(proj)
    # the reference binds; the port's context reads the binding
    jconfigure.bind_space(_jprovider(), p.create_space("nsdev"), JGeneratedConfig(str(proj)))
    KubeConfig.load().current_context = "elsewhere"
    for ctx_cls in (JContext, Context):
        args = argparse.Namespace(namespace=None, kube_context=None, config=None)
        assert ctx_cls(args, require_config=False).namespace == "space-nsdev"
        args = argparse.Namespace(namespace="override", kube_context=None, config=None)
        assert ctx_cls(args, require_config=False).namespace == "override"
    # with no context named, the backend takes the Space's context, whose
    # stale token configure() refreshes first
    kc = KubeConfig.load()
    kc.contexts["elsewhere"] = kc.contexts["devspace-nsdev"]
    kc.current_context = "elsewhere"
    kc.save()
    gen = GeneratedConfig.load(str(proj))
    gen.space.token = make_jwt(-10)
    gen.save()
    from devspace_tpu_torch.kube.transport import KubeTransport

    opened = []
    monkeypatch.setattr(KubeTransport, "from_kubeconfig", classmethod(
        lambda cls, context=None, namespace=None: opened.append((context, namespace))))
    args = argparse.Namespace(namespace=None, kube_context=None, config=None)
    Context(args).backend
    assert opened == [("devspace-nsdev", "space-nsdev")]
    assert GeneratedConfig.load(str(proj)).space.token == TOKEN
    assert KubeConfig.load().current_context == "devspace-nsdev"


CLOCK = re.compile(r"\b\d\d:\d\d:\d\d\b")

CLOUD_FLOW = [
    ["add", "provider", "smoke", "--host", "{host}", "--use-as-default"],
    ["list", "providers"],
    ["login", "--key", "wrong"],
    ["login", "--key", VALID_KEY],
    ["create", "space", "s1"],
    ["create", "space", "s2", "--no-use"],
    ["list", "spaces"],
    ["use", "space", "s2"],
    ["list", "spaces"],
    ["use", "space", "s1", "--provider", "smoke"],
    ["use", "registry"],
    ["use", "registry", "alt.registry.test", "--provider", "smoke"],
    ["remove", "context", "s2"],
    ["remove", "space", "s2"],
    ["list", "spaces", "--provider", "smoke"],
    ["remove", "space", "ghost"],
    ["remove", "context", "--all"],
    ["remove", "context", "--all"],
    ["remove", "context"],
    ["create", "space", "s3"],
    ["remove", "space", "s3"],
    ["remove", "space", "s1"],
    ["add", "provider", "smoke", "--host", "{host}"],
    ["list", "providers"],
    ["remove", "provider", "smoke"],
    ["remove", "provider", "ghost"],
    ["list", "providers"],
    ["login", "--provider", "nope", "--key", "x"],
    ["list", "spaces", "--provider", "nope"],
]


def _run_flow(cli, root, host, monkeypatch, capsys):
    """Each command of CLOUD_FLOW through ``cli`` in a project of its own
    against a fresh fake: ``[(argv, rc, stdout lines)]`` and the files it
    left (registry, kubeconfig, docker config, generated cache)."""
    FakeCloud.spaces, FakeCloud.next_id = {}, 1
    files = {"DEVSPACE_CLOUD_CONFIG": root / "clouds.yaml", "KUBECONFIG": root / "kubeconfig",
             "DOCKER_CONFIG": root / "docker"}
    for var, path in files.items():
        monkeypatch.setenv(var, str(path))
    proj = root / "proj"
    (proj / ".devspace").mkdir(parents=True)
    (proj / ".devspace" / "config.yaml").write_text("version: tpu/v1\n")
    monkeypatch.chdir(proj)
    runs = []
    for argv in CLOUD_FLOW:
        argv = [a.format(host=host) for a in argv]
        capsys.readouterr()
        rc = cli(list(argv))
        runs.append((argv, rc, CLOCK.sub("HH:MM:SS", capsys.readouterr().out).splitlines()))
    left = {name: _read(path) for name, path in (
        ("clouds", files["DEVSPACE_CLOUD_CONFIG"]), ("kubeconfig", files["KUBECONFIG"]),
        ("docker", files["DOCKER_CONFIG"] / "config.json"),
        ("generated", proj / ".devspace" / "generated.yaml"))}
    return runs, left


def test_cloud_commands_print_what_the_reference_prints(cloud_env, tmp_path, monkeypatch,
                                                        capsys):
    (jruns, jleft), (runs, left) = (
        _run_flow(cli, tmp_path / name, cloud_env["host"], monkeypatch, capsys)
        for cli, name in ((jmain, "ref"), (main, "port")))
    for (argv, jrc, jout), (_, rc, out) in zip(jruns, runs):
        assert (rc, out) == (jrc, jout), argv
    assert left == jleft
    by_argv = {}
    for argv, rc, out in runs:
        by_argv.setdefault(" ".join(argv), (rc, out))  # a command's first run
    failed = [" ".join(argv) for argv, rc, _ in runs if rc == 1]
    assert failed == ["login --key wrong", "remove space ghost", "remove context",
                      "remove provider ghost", "login --provider nope --key x",
                      "list spaces --provider nope"]
    spaces = by_argv["list spaces"][1]
    assert any(ln.split()[:2] == ["s1", "1"] and ln.rstrip().endswith("*") for ln in spaces)
    assert by_argv["remove context"] == (1, ["[error] specify a space name or --all"])
    docker = json.loads(left["docker"])
    assert set(docker["auths"]) == {"registry.test", "alt.registry.test"}
    assert base64.b64decode(docker["auths"]["registry.test"]["auth"]) == b"sa:pw"
    assert b"devspace-" not in left["kubeconfig"] and FakeCloud.spaces == {}
    assert b"smoke" not in left["clouds"]
