"""Image builders: docker daemon, in-cluster kaniko, and a fake for tests.

The port's copy of ``devspace_tpu/builder/builders.py``, with the same
behaviour (reference: builder/interface.go {Authenticate, BuildImage,
PushImage}; builder/docker/docker.go; builder/kaniko/kaniko.go: pod
spawn, context upload over the sync engine's one-shot
``copy_to_container``, exec of /kaniko/executor).
"""

from __future__ import annotations

import os
import re
import time
from typing import Optional

from ..sync.session import copy_to_container
from ..utils import log as logutil
from . import dockerclient
from .dockerclient import DockerClient, DockerError, load_docker_auths


class BuildError(Exception):
    pass


def apply_entrypoint_override(dockerfile_content: str, entrypoint: list[str]) -> str:
    """Rewrite/append ENTRYPOINT for dev-mode (reference:
    builder/util.go CreateTempDockerfile — the dev override keeps the
    container alive so sync/terminal can attach before the app starts)."""
    import json

    lines = dockerfile_content.splitlines()
    out = [
        ln
        for ln in lines
        if not re.match(r"^\s*(ENTRYPOINT|CMD)\b", ln, re.IGNORECASE)
    ]
    out.append("ENTRYPOINT " + json.dumps(entrypoint))
    return "\n".join(out) + "\n"


class DockerBuilder:
    """Local docker daemon build + push."""

    def __init__(
        self,
        client: Optional[DockerClient] = None,
        logger: Optional[logutil.Logger] = None,
    ):
        self.client = client or DockerClient()
        self.log = logger or logutil.get_logger()
        self._auths = load_docker_auths()

    def available(self) -> bool:
        return self.client.ping()

    def _auth_for(self, image: str) -> Optional[dict]:
        registry = dockerclient.registry_from_image(image)
        for key, auth in self._auths.items():
            if registry in key:
                return auth
        return None

    def authenticate(self, image: str) -> Optional[dict]:
        return self._auth_for(image)

    def build(
        self,
        image: str,
        tag: str,
        context_dir: str,
        dockerfile_path: str,
        entrypoint_override: Optional[list[str]] = None,
        build_args: Optional[dict[str, str]] = None,
        target: Optional[str] = None,
        network: Optional[str] = None,
    ) -> None:
        override: Optional[bytes] = None
        df_outside = None
        if entrypoint_override:
            with open(dockerfile_path, "r", encoding="utf-8") as fh:
                override = apply_entrypoint_override(
                    fh.read(), entrypoint_override
                ).encode()
        elif os.path.abspath(dockerfile_path) != os.path.abspath(
            os.path.join(context_dir, "Dockerfile")
        ):
            df_outside = dockerfile_path
        context = DockerClient.make_build_context(
            context_dir, dockerfile_path=df_outside, dockerfile_override=override
        )
        auth = self._auth_for(image)
        registry_auth = (
            {dockerclient.registry_from_image(image): auth} if auth else None
        )
        for line in self.client.build(
            context,
            f"{image}:{tag}",
            build_args=build_args,
            target=target,
            network=network,
            registry_auth=registry_auth,
        ):
            self.log.debug("[build] %s", line)

    def push(self, image: str, tag: str) -> None:
        for line in self.client.push(image, tag, auth=self._auth_for(image)):
            self.log.debug("[push] %s", line)


KANIKO_IMAGE = "gcr.io/kaniko-project/executor:latest"
KANIKO_CONTEXT_PATH = "/workspace"


class KanikoBuilder:
    """In-cluster build: a kaniko pod receives the context through the sync
    engine's one-shot upload, then runs /kaniko/executor
    (reference: builder/kaniko/kaniko.go:84-255)."""

    def __init__(
        self,
        backend,
        namespace: str = "default",
        pull_secret: Optional[str] = None,
        cache: bool = True,
        kaniko_image: str = KANIKO_IMAGE,
        logger: Optional[logutil.Logger] = None,
    ):
        self.backend = backend
        self.namespace = namespace
        self.pull_secret = pull_secret
        self.cache = cache
        self.kaniko_image = kaniko_image
        self.log = logger or logutil.get_logger()

    def authenticate(self, image: str) -> None:
        # Kaniko pushes from inside the cluster using the mounted pull
        # secret (reference: kaniko.go Authenticate creates the secret).
        return None

    def build(
        self,
        image: str,
        tag: str,
        context_dir: str,
        dockerfile_path: str,
        entrypoint_override: Optional[list[str]] = None,
        build_args: Optional[dict[str, str]] = None,
        target: Optional[str] = None,
        network: Optional[str] = None,
    ) -> None:
        import random
        import string

        suffix = "".join(random.choices(string.ascii_lowercase + string.digits, k=5))
        pod_name = f"devspace-kaniko-{suffix}"
        volumes = []
        mounts = []
        if self.pull_secret:
            volumes.append(
                {
                    "name": "registry-auth",
                    "secret": {
                        "secretName": self.pull_secret,
                        "items": [
                            {"key": ".dockerconfigjson", "path": "config.json"}
                        ],
                    },
                }
            )
            mounts.append({"name": "registry-auth", "mountPath": "/kaniko/.docker"})
        manifest = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {"name": pod_name, "namespace": self.namespace},
            "spec": {
                "restartPolicy": "Never",
                "containers": [
                    {
                        "name": "kaniko",
                        "image": self.kaniko_image,
                        "command": ["sh", "-c", "sleep 7200"],
                        "volumeMounts": mounts,
                    }
                ],
                "volumes": volumes,
            },
        }
        self.backend.ensure_namespace(self.namespace)
        pod = self.backend.create_pod(manifest, namespace=self.namespace)
        try:
            self._wait_running(pod_name)
            # Upload build context (reference: kaniko.go:211-216 uses
            # sync.CopyToContainer).
            ctx_dest = f"{KANIKO_CONTEXT_PATH}/{suffix}"
            n = copy_to_container(
                self.backend, pod, context_dir, ctx_dest, logger=self.log
            )
            self.log.info("[kaniko] uploaded %d context entries", n)
            if entrypoint_override:
                with open(dockerfile_path, "r", encoding="utf-8") as fh:
                    content = apply_entrypoint_override(
                        fh.read(), entrypoint_override
                    )
                self._write_remote_file(pod, f"{ctx_dest}/Dockerfile", content)
            args = [
                "/kaniko/executor",
                f"--context={ctx_dest}",
                f"--dockerfile={ctx_dest}/Dockerfile",
                f"--destination={image}:{tag}",
            ]
            if self.cache:
                args.append("--cache=true")
            if target:
                args.append(f"--target={target}")
            for k, v in (build_args or {}).items():
                args.append(f"--build-arg={k}={v}")
            proc = self.backend.exec_stream(pod, args, container="kaniko")
            deadline = time.monotonic() + 1800
            while proc.poll() is None and time.monotonic() < deadline:
                try:
                    chunk = proc.stdout.read_available(timeout=0.5)
                    if chunk:
                        for ln in chunk.decode("utf-8", "replace").splitlines():
                            self.log.debug("[kaniko] %s", ln)
                except Exception:  # noqa: BLE001 — stream closed at exit
                    break
            rc = proc.wait(10)
            if rc != 0:
                err = proc.stderr.drain().decode("utf-8", "replace")
                raise BuildError(f"kaniko build failed (rc={rc}): {err[-2000:]}")
        finally:
            self.backend.delete_pod(pod_name, namespace=self.namespace)

    def _wait_running(self, pod_name: str, timeout: float = 300.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            pod = self.backend.get_pod(pod_name, namespace=self.namespace)
            if pod is not None and pod.phase == "Running":
                return
            time.sleep(1.0)
        raise BuildError(f"kaniko pod {pod_name} not running after {timeout}s")

    def _write_remote_file(self, pod, path: str, content: str) -> None:
        import shlex

        # identity on a real cluster; maps into the pod dir on the fake
        # backend (same convention as the sync engine's remote dirs)
        path = self.backend.translate_path(pod, path)
        out, err, rc = self.backend.exec_buffered(
            pod,
            [
                "sh",
                "-c",
                f"printf '%s' {shlex.quote(content)} > {shlex.quote(path)}",
            ],
        )
        if rc != 0:
            raise BuildError(f"failed writing {path}: {err.decode('utf-8', 'replace')}")

    def push(self, image: str, tag: str) -> None:
        pass  # kaniko pushes as part of the build


class FakeBuilder:
    """Records builds; used by tests and environments without a daemon."""

    def __init__(self):
        self.builds: list[dict] = []
        self.pushes: list[tuple[str, str]] = []

    def authenticate(self, image: str) -> None:
        return None

    def build(self, image, tag, context_dir, dockerfile_path, **kwargs) -> None:
        self.builds.append(
            {
                "image": image,
                "tag": tag,
                "context": context_dir,
                "dockerfile": dockerfile_path,
                **kwargs,
            }
        )

    def push(self, image: str, tag: str) -> None:
        self.pushes.append((image, tag))
