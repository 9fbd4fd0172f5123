"""Cloud provider layer — Spaces as managed namespaces.

Reference: pkg/devspace/cloud (SURVEY §2.8): provider registry in
``~/.devspace/clouds.yaml``, GraphQL API client, browser token login,
Space CRUD and space -> kubeconfig-context materialization.

The port's copy of ``devspace_tpu/cloud/``, with the same behaviour: the
same registry file and default provider, the same ``manager_*`` GraphQL
operations, and the Space bound in ``.devspace/generated.yaml``, so
either package reads what the other wrote.
"""

from .config import CloudProvider, ProviderRegistry  # noqa: F401
from .provider import CloudError, Provider  # noqa: F401
