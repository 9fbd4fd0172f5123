"""Image builders: the docker daemon, and a fake for tests.

The port's copy of ``devspace_tpu/builder/builders.py`` (reference:
builder/interface.go {Authenticate, BuildImage, PushImage};
builder/docker/docker.go). The reference's in-cluster ``KanikoBuilder``
uploads its build context through the sync engine's remote shell
(``sync/session.py`` ``copy_to_container``), which the port does not
have yet (ROADMAP A21); until then ``images.create_builder`` refuses a
configuration that would pick it.
"""

from __future__ import annotations

import os
import re
from typing import Optional

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
