# expect: JIT501
# The prefill offset as a Python int into a compiled callable: it is
# re-specialised for every chunk offset, and a graph captured the same
# way would replay the first chunk's offset for every later chunk.
import torch


def _prefill_chunk(params, pool, table, tokens, offset):
    return tokens + offset


prefill_compiled = torch.compile(_prefill_chunk)


def prefill(params, pool, table, chunks):
    offset = 0
    logits = None
    for tokens in chunks:
        logits = prefill_compiled(params, pool, table, tokens, offset)
        offset += tokens.shape[0]
    return logits
