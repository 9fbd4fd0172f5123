"""torchrun's own flags, read back from a rendered container.

chart-gpu starts its app as ``torchrun --nnodes=N --nproc-per-node=K
--node-rank=$(NODE_RANK) --master-addr=<pod 0> --master-port=P <args>``.
The render-time checks read those flags back: ``deploy.chart``'s HPA
check and the TPU201-205 rules of ``lint.rules_gpu``.
"""

from __future__ import annotations

from typing import Optional

# flags of torchrun that take no value
_BOOLEAN = frozenset({"standalone", "no-python", "module", "m", "run-path"})


def _as_list(value) -> list:
    return list(value) if isinstance(value, list) else []


def torchrun_flags(container: dict) -> Optional[dict[str, str]]:
    """``{flag: value}`` of torchrun's own flags in a container's
    ``command`` and ``args``: names without their dashes, ``_`` read as
    ``-`` (torchrun takes both spellings), a flag without a value mapped
    to ``""``. None where the container does not start torchrun (the
    ``torchrun`` console script, or ``python -m torch.distributed.run``).
    The flags end at the first argument that is not one: the app."""
    argv = [str(a) for a in _as_list(container.get("command")) + _as_list(container.get("args"))]
    start = None
    for i, arg in enumerate(argv):
        if arg.rsplit("/", 1)[-1] == "torchrun" or (
                arg == "torch.distributed.run" and i > 0 and argv[i - 1] == "-m"):
            start = i + 1
            break
    if start is None:
        return None
    flags: dict[str, str] = {}
    i = start
    while i < len(argv) and argv[i].startswith("-"):
        name, eq, value = argv[i].lstrip("-").partition("=")
        name = name.replace("_", "-")
        if not eq and name not in _BOOLEAN and i + 1 < len(argv):
            i += 1
            value = argv[i]
        flags[name] = value
        i += 1
    return flags


def max_nodes(value) -> Optional[int]:
    """Hosts of an ``--nnodes`` value (``N``, or ``MIN:MAX`` for an
    elastic job); None when it is not an integer."""
    try:
        return int(str(value).rsplit(":", 1)[-1])
    except ValueError:
        return None
