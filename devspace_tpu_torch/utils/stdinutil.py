"""Interactive prompts: the port's copy of ``devspace_tpu/utils/stdinutil.py``
(reference: pkg/util/stdinutil/stdin.go GetFromStdin — survey-based
question/default/regex-validation prompts).

Non-interactive environments (CI, tests) answer every question with its
default; set ``DEVSPACE_NONINTERACTIVE=1`` or pass ``interactive=False``.
"""

from __future__ import annotations

import os
import re
import sys
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Question:
    question: str
    default: str = ""
    validation_pattern: Optional[str] = None
    validation_message: Optional[str] = None
    options: list[str] = field(default_factory=list)


def is_interactive() -> bool:
    if os.environ.get("DEVSPACE_NONINTERACTIVE"):
        return False
    return sys.stdin.isatty()


def ask(q: Question, logger=None, interactive: Optional[bool] = None) -> str:
    if interactive is None:
        interactive = is_interactive()
    if not interactive:
        if q.validation_pattern and not re.fullmatch(q.validation_pattern, q.default):
            raise ValueError(
                f"non-interactive answer {q.default!r} for {q.question!r} does not "
                f"match required pattern {q.validation_pattern}"
            )
        if q.options and q.default not in q.options:
            raise ValueError(
                f"non-interactive answer {q.default!r} for {q.question!r} is not "
                f"one of: {', '.join(q.options)}"
            )
        return q.default
    while True:
        prompt = q.question
        if q.options:
            prompt += " (" + "/".join(q.options) + ")"
        if q.default:
            prompt += f" [{q.default}]"
        sys.stderr.write(prompt + ": ")
        sys.stderr.flush()
        line = sys.stdin.readline()
        if line == "":  # EOF — a blank line would be "\n"
            raise EOFError(f"stdin closed while asking: {q.question!r}")
        answer = line.rstrip("\n") or q.default
        if q.options and answer not in q.options:
            sys.stderr.write(f"Please answer one of: {', '.join(q.options)}\n")
            continue
        if q.validation_pattern and not re.fullmatch(q.validation_pattern, answer):
            sys.stderr.write(
                (q.validation_message or f"Answer must match {q.validation_pattern}")
                + "\n"
            )
            continue
        return answer
