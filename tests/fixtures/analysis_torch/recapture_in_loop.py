# expect: JIT500
# A CUDA graph and its capture built on every iteration: each pass pays
# a capture, and the graphs pile up in the shared memory pool.
import torch


def decode_all(step, tokens, n_steps):
    out = []
    for _ in range(n_steps):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            nxt = step(tokens)
        graph.replay()
        out.append(nxt.clone())
    return out
