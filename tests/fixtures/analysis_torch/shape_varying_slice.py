# expect: JIT504
# A slice whose bounds move with the loop, into a compiled callable: a
# new argument shape per chunk (pad to a fixed bucket instead).
import torch


def _forward(params, tokens):
    return tokens * 2


forward_compiled = torch.compile(_forward)


def prefill(params, tokens, chunk):
    outs = []
    for start in range(0, tokens.shape[0], chunk):
        outs.append(forward_compiled(params, tokens[start:start + chunk]))
    return torch.cat(outs)
