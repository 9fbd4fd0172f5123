"""Random string generation (reference: pkg/util/randutil — used for the
7-char image tags, pkg/devspace/image/build.go:86).

The port's copy of ``devspace_tpu/utils/randutil.py``, with the same behaviour.
"""

from __future__ import annotations

import secrets
import string

_ALPHANUM = string.ascii_lowercase + string.digits


def random_string(length: int = 7) -> str:
    return "".join(secrets.choice(_ALPHANUM) for _ in range(length))
