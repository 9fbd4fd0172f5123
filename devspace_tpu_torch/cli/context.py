"""CLI execution context: project root, config, backend selection.

The port's copy of ``devspace_tpu/cli/context.py`` (reference: the
per-command preamble every cobra command runs — configutil.SetDevSpaceRoot,
cloud.Configure, kubectl.NewClient, cmd/dev.go:130-160). Backend
precedence: the ``DEVSPACE_FAKE_BACKEND`` env (a local fake cluster for
clusterless deploys and tests) > the inline cluster of config.yaml > a
kubeconfig context (``--kube-context``, the config's
``cluster.kubeContext``, else the bound cloud Space's ``devspace-<space>``
context through ``cloud.configure``, else the kubeconfig's current
context). A bound Space's namespace wins over the default namespace.
With no backend it can reach, the context raises :class:`CLIError`; it
never falls back to the fake.
"""

from __future__ import annotations

import os
from typing import Optional

from ..config import latest
from ..config.loader import ConfigLoader, find_root, get_default_namespace
from ..utils import log as logutil

FAKE_BACKEND_ENV = "DEVSPACE_FAKE_BACKEND"


class CLIError(Exception):
    pass


class Context:
    def __init__(self, args, require_config: bool = True):
        self.args = args
        self.log = logutil.get_logger()
        root = find_root(os.getcwd())
        if root is None:
            if require_config:
                raise CLIError(
                    "no .devspace/ project found — run "
                    "'python -m devspace_tpu_torch init' first"
                )
            root = os.getcwd()
        self.root = root
        self.loader = ConfigLoader(self.root, self.log)
        self.config: Optional[latest.Config] = None
        if require_config:
            self.config = self.loader.load(
                config_name=getattr(args, "config", None),
                interactive=None,
            )
        self._backend = None

    @property
    def namespace(self) -> str:
        flag = getattr(self.args, "namespace", None)
        if flag:
            return flag
        if self.config is not None and self.config.cluster and self.config.cluster.namespace:
            return self.config.cluster.namespace
        # Bound cloud Space: its service account is namespace-scoped, so the
        # space namespace must win over the plain "default" fallback
        # (reference: cloud.Configure re-binds config to the active space).
        space = self.loader.generated.space
        if space is not None and space.namespace:
            return space.namespace
        if self.config is not None:
            return get_default_namespace(self.config)
        return "default"

    @property
    def is_gke(self) -> bool:
        """GKE contexts are named ``gke_<project>_<zone>_<cluster>`` by
        ``gcloud container clusters get-credentials`` (reference:
        kubectl/util.go:46 keys its RBAC ensure off the gcloud account).

        Asks the backend which context it actually connected with —
        inline-cluster and fake backends carry no context name and
        correctly report False.
        """
        transport = getattr(self.backend, "transport", None)
        name = getattr(transport, "context_name", None)
        return bool(name) and str(name).startswith("gke_")

    @property
    def backend(self):
        if self._backend is None:
            self._backend = self._create_backend()
        return self._backend

    def _create_backend(self):
        fake_root = os.environ.get(FAKE_BACKEND_ENV)
        if fake_root:
            from ..kube.fake import FakeCluster

            self.log.info("[cluster] using fake local backend at %s", fake_root)
            return FakeCluster(fake_root, logger=self.log, persist=True)
        cluster = self.config.cluster if self.config else None
        from ..kube.client import KubeClient
        from ..kube.transport import KubeTransport

        if cluster and cluster.api_server:
            transport = KubeTransport.from_inline(
                cluster.api_server,
                ca_cert_b64=cluster.ca_cert,
                token=cluster.user.token if cluster.user else None,
                namespace=self.namespace,
            )
            return KubeClient(transport, self.log)
        context = getattr(self.args, "kube_context", None) or (
            cluster.kube_context if cluster else None
        )
        if context is None:
            # Bound cloud Space wins over the kubeconfig's current context
            # (reference: cloud.Configure at the top of every command,
            # cmd/dev.go:142 -> cloud/configure.go:79-118).
            from ..cloud.configure import configure as cloud_configure

            context = cloud_configure(self.loader.generated, self.log)
        try:
            transport = KubeTransport.from_kubeconfig(
                context=context, namespace=self.namespace
            )
        except (KeyError, OSError, ValueError) as e:
            raise CLIError(
                f"no cluster backend: kubeconfig context "
                f"{context or '(current)'} cannot be used ({e}); set a "
                f"kubeconfig context, an inline cluster in config.yaml, or "
                f"{FAKE_BACKEND_ENV}=<dir> for the local fake cluster"
            ) from e
        return KubeClient(transport, self.log)

    def save_generated(self) -> None:
        self.loader.save_generated()
