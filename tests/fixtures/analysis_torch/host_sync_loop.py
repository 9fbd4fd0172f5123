# expect: JIT502
# Host syncs inside the decode loop: each blocks the host on the card's
# stream once per step.
import torch


def decode(model, tokens, n_steps):
    generated = []
    for _ in range(n_steps):
        logits = model(tokens)
        nxt = torch.argmax(logits, dim=-1)
        generated.append(nxt.item())
        probs = torch.softmax(logits, dim=-1)
        if float(probs.max()) < 0.1:
            break
        tokens = nxt[None]
        torch.cuda.synchronize()
    return generated, tokens.tolist()
