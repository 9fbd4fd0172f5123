"""Interleaved (virtual-stage) 1F1B pipeline schedule.

The port's own copy of ``devspace_tpu/parallel/interleaved.py`` (numpy
only; the port imports nothing of the JAX package). Megatron-LM's
interleaved schedule (Narayanan et al. 2021, "Efficient large-scale
language model training on GPU clusters"): each of the S pipeline ranks
holds V model CHUNKS instead of one contiguous stage. Virtual stage p
(of P = S*V) lives on rank p % S, so every stage-to-stage hop goes to
the next rank of the ring, and the fill/drain bubble shrinks ~V-fold
because a rank starts its first chunk after 1/V of the old fill time.

The whole schedule is compiled to STATIC per-tick tables (numpy
``[T, S]``: op, chunk, microbatch, ring slot, receive routing) that the
executor (``parallel/pipeline.interleaved_pipeline_lm_loss_and_grads``)
reads with its stage index; from the same tables every rank knows which
sends and receives each tick needs.

The builder generates Megatron's exact static per-rank op order --
warmup of ``2*(S-s-1) + (V-1)*S`` forwards on rank s, then strict
F,B,F,B 1F1B alternation, with chunk-cycling in groups of S
microbatches (forward ascending chunks, backward descending) -- and then
TICK-SIMULATES it under the lockstep constraints (F needs the upstream
activation a tick earlier, B the downstream gradient a tick earlier,
one op per rank per tick, in-order microbatches per virtual stage):
each rank executes the head of its queue when ready, else idles. The
simulation realizes Megatron's bubble exactly: 2*(S-1) chunk-ticks in
all, V-fold smaller than non-interleaved 1F1B's 2*(S-1)*V, a bubble
fraction of (S-1)/(M*V + S-1) when S divides M. Buffer depths
(activation stash per chunk, in-flight hops per edge) are derived from
the schedule afterwards and become the executor's buffer sizes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

OP_IDLE, OP_F, OP_B = 0, 1, 2


@dataclass(frozen=True)
class InterleavedSchedule:
    n_stages: int  # S devices
    n_chunks: int  # V chunks per device
    n_micro: int  # M microbatches
    total_ticks: int
    ring_depth: int  # max in-flight microbatches per (device, chunk)
    f_depth: int  # received-activation buffer slots per chunk (fwd edges)
    b_depth: int  # received-gradient buffer slots per chunk (bwd edges)
    # all [T, S] int32 tables
    op: np.ndarray  # OP_IDLE / OP_F / OP_B
    chunk: np.ndarray  # local chunk the op runs on
    mb: np.ndarray  # microbatch index of the op
    slot: np.ndarray  # activation-ring slot (F stores, B loads)
    recv_f_chunk: np.ndarray  # chunk to store the arriving fwd act (-1 none)
    recv_f_slot: np.ndarray
    recv_b_chunk: np.ndarray  # chunk to store the arriving grad (-1 none)
    recv_b_slot: np.ndarray

    @property
    def bubble_fraction(self) -> float:
        busy = 2 * self.n_micro * self.n_chunks  # per device
        return 1.0 - busy / (self.total_ticks or 1)


def _device_op_order(S: int, V: int, M: int, s: int) -> list:
    """Megatron's static op sequence for device ``s``: warmup forwards,
    then strict F,B alternation until forwards run out, then the
    backward drain. Forward order cycles chunks in groups of S
    microbatches ascending; backward mirrors it with chunks descending.
    Microbatches stay in-order per virtual stage by construction (the
    executor's ring/buffer slot math relies on it)."""
    groups = [range(g0, min(g0 + S, M)) for g0 in range(0, M, S)]
    fwd = [
        (v, m) for grp in groups for v in range(V) for m in grp
    ]
    bwd = [
        (v, m)
        for grp in groups
        for v in reversed(range(V))
        for m in grp
    ]
    # Warmup depth is the schedule's load-bearing constant: deep enough
    # that the steady state never starves (the first grad arrives just
    # as warmup ends on every device), shallow enough that in-flight
    # activations stay bounded.
    warmup = min(2 * (S - s - 1) + (V - 1) * S, len(fwd))
    queue = [(OP_F, v, m) for v, m in fwd[:warmup]]
    fi, bi = warmup, 0
    while fi < len(fwd) or bi < len(bwd):
        if fi < len(fwd):
            queue.append((OP_F, *fwd[fi]))
            fi += 1
        if bi < len(bwd):
            queue.append((OP_B, *bwd[bi]))
            bi += 1
    return queue


def build_interleaved_schedule(
    n_stages: int, n_chunks: int, n_micro: int
) -> InterleavedSchedule:
    S, V, M = n_stages, n_chunks, n_micro
    P = S * V
    f_done: dict[tuple[int, int], int] = {}  # (p, m) -> tick
    b_done: dict[tuple[int, int], int] = {}

    def f_ready(p: int, m: int, tau: int) -> bool:
        if m > 0 and (p, m - 1) not in f_done:
            return False  # in-order per stage (buffer slots rely on it)
        if p > 0 and f_done.get((p - 1, m), tau) >= tau:
            return False
        return True

    def b_ready(p: int, m: int, tau: int) -> bool:
        if m > 0 and (p, m - 1) not in b_done:
            return False
        if p == P - 1:
            if f_done.get((p, m), tau) >= tau:
                return False
        elif b_done.get((p + 1, m), tau) >= tau:
            return False
        return True

    ops: list[list[tuple[int, int, int]]] = []  # per tick: [(op,p,m)] per dev
    tau = 0
    if M % S == 0:
        # Megatron static order: realizes the exact 2*(S-1) bubble, but
        # its warmup symmetry needs full chunk-cycling groups (S | M —
        # Megatron-LM imposes the same divisibility requirement)
        queues = [_device_op_order(S, V, M, s) for s in range(S)]
        heads = [0] * S
        while any(heads[s] < len(queues[s]) for s in range(S)):
            tick_ops: list[tuple[int, int, int]] = [(OP_IDLE, 0, 0)] * S
            # select against the PREVIOUS ticks' state for every device
            # (readiness uses `>= tau`), then commit — ops chosen this
            # tick cannot feed each other within the tick
            for s in range(S):
                if heads[s] >= len(queues[s]):
                    continue
                op, v, m = queues[s][heads[s]]
                p = v * S + s
                ready = (
                    f_ready(p, m, tau) if op == OP_F else b_ready(p, m, tau)
                )
                if ready:
                    tick_ops[s] = (op, p, m)
            scheduled = False
            for s in range(S):
                op, p, m = tick_ops[s]
                if op == OP_F:
                    f_done[(p, m)] = tau
                elif op == OP_B:
                    b_done[(p, m)] = tau
                else:
                    continue
                heads[s] += 1
                scheduled = True
            if not scheduled:
                # an all-idle tick can never recover (readiness depends
                # only on ticks < tau): a genuine deadlock, which for
                # the divisible static order would be a builder bug
                raise RuntimeError(
                    f"interleaved schedule deadlocked at tick {tau} "
                    f"(S={S}, V={V}, M={M})"
                )
            ops.append(tick_ops)
            tau += 1
    else:
        # ragged microbatch count: greedy earliest-tick list scheduler
        # (backward-first with chunk-cycling forwards) — valid for ANY
        # (S, V, M), lands within a few ticks of the bound
        while len(f_done) + len(b_done) < 2 * P * M:
            tick_ops = [(OP_IDLE, 0, 0)] * S
            scheduled = False
            for s in range(S):
                best = None
                b_cands = []
                for v in range(V):
                    p = v * S + s
                    for m in range(M):
                        if (p, m) not in b_done and b_ready(p, m, tau):
                            b_cands.append(((m // S, -v, m), (OP_B, p, m)))
                            break
                if b_cands:
                    best = min(b_cands)[1]
                else:
                    f_cands = []
                    for v in range(V):
                        p = v * S + s
                        for m in range(M):
                            if (p, m) not in f_done and f_ready(p, m, tau):
                                f_cands.append(
                                    ((m // S, v, m), (OP_F, p, m))
                                )
                                break
                    if f_cands:
                        best = min(f_cands)[1]
                if best is not None:
                    tick_ops[s] = best
                    scheduled = True
            for s in range(S):
                op, p, m = tick_ops[s]
                if op == OP_F:
                    f_done[(p, m)] = tau
                elif op == OP_B:
                    b_done[(p, m)] = tau
            if not scheduled:
                raise RuntimeError(
                    f"interleaved schedule deadlocked at tick {tau} "
                    f"(S={S}, V={V}, M={M})"
                )
            ops.append(tick_ops)
            tau += 1

    total = len(ops)
    # activation-ring depth: max in-flight (F done, B pending) per stage
    ring_depth = 1
    for p in range(P):
        events = []
        for m in range(M):
            events.append((f_done[(p, m)], 1))
            events.append((b_done[(p, m)], -1))
        events.sort()
        cur = 0
        for _, delta in events:
            cur += delta
            ring_depth = max(ring_depth, cur)
    # received-buffer depths, PER DIRECTION: max outstanding activations
    # on any forward edge (produced at p, not yet consumed at p+1) and
    # max outstanding grads on any backward edge — a combined counter
    # would over-allocate the (typically depth-1) backward buffer
    def _edge_depth(produce, consume) -> int:
        depth = 1
        for p in range(P - 1):
            events = []
            for m in range(M):
                events.append((produce(p, m), 1))
                events.append((consume(p, m), -1))
            events.sort()
            cur = 0
            for _, delta in events:
                cur += delta
                depth = max(depth, cur)
        return depth

    f_depth = _edge_depth(
        lambda p, m: f_done[(p, m)], lambda p, m: f_done[(p + 1, m)]
    )
    b_depth = _edge_depth(
        lambda p, m: b_done[(p + 1, m)], lambda p, m: b_done[(p, m)]
    )

    op_t = np.zeros((total, S), np.int32)
    chunk_t = np.zeros((total, S), np.int32)
    mb_t = np.zeros((total, S), np.int32)
    slot_t = np.zeros((total, S), np.int32)
    recv_f_c = np.full((total, S), -1, np.int32)
    recv_f_s = np.zeros((total, S), np.int32)
    recv_b_c = np.full((total, S), -1, np.int32)
    recv_b_s = np.zeros((total, S), np.int32)
    for tau, tick_ops in enumerate(ops):
        for s in range(S):
            op, p, m = tick_ops[s]
            op_t[tau, s] = op
            if op == OP_IDLE:
                continue
            chunk_t[tau, s] = p // S
            mb_t[tau, s] = m
            slot_t[tau, s] = m % ring_depth
            if op == OP_F and p + 1 < P and tau + 1 < total:
                recv_f_c[tau + 1, (s + 1) % S] = (p + 1) // S
                recv_f_s[tau + 1, (s + 1) % S] = m % f_depth
            if op == OP_B and p > 0 and tau + 1 < total:
                recv_b_c[tau + 1, (s - 1) % S] = (p - 1) // S
                recv_b_s[tau + 1, (s - 1) % S] = m % b_depth
    return InterleavedSchedule(
        n_stages=S,
        n_chunks=V,
        n_micro=M,
        total_ticks=total,
        ring_depth=ring_depth,
        f_depth=f_depth,
        b_depth=b_depth,
        op=op_t,
        chunk=chunk_t,
        mb=mb_t,
        slot=slot_t,
        recv_f_chunk=recv_f_c,
        recv_f_slot=recv_f_s,
        recv_b_chunk=recv_b_c,
        recv_b_slot=recv_b_s,
    )
