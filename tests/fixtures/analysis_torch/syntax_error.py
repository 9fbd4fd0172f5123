# expect: PY500
# A module that does not parse blocks every AST rule over it.
import torch


def broken(x:
    return torch.zeros(x)
