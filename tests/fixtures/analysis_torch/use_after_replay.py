# expect: JIT503
# A graph's static output kept across replays without a clone: every
# stored reference is the same buffer, which each replay rewrites.
import torch


def decode_steps(graph, static_out, n):
    outs = []
    for _ in range(n):
        graph.replay()
        outs.append(static_out)
    return torch.stack(outs)


def first_and_second(graph, static_out):
    graph.replay()
    first = static_out
    graph.replay()
    return first, static_out.clone()
