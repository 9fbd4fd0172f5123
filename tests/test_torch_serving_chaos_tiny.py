"""The port's loadgen over two TINY torch replicas behind its gateway, one
SIGKILLed mid-trace, each stream held to the JAX package's greedy
``generate`` on the same checkpoint.

The checkpoint is made by the JAX package and converted for the port
(scripts/convert_checkpoint.py), as tests/test_torch_fleet.py's mixed
fleet does; the replicas are ``python -m devspace_tpu_torch.serve
--device cpu``. Prompt ids are mapped into TINY's vocabulary of 256
(chip_smoke.in_vocab) and each prompt plus its new tokens stays within
TINY's 128 positions. A corrupted stream passes only where it left the
JAX stream at a near tie of the JAX forward's logits (both tokens within
2^-6 of the largest logit's magnitude of the top one): the streams are
compared before that point.
"""

import dataclasses
import os
import sys
import threading

import numpy as np
import pytest

import chip_smoke as cs
from devspace_tpu_torch.serving import LoadGenerator, ReplicaFleet, ReplicaSpec, TraceSpec
from devspace_tpu_torch.serving import generate_trace
from devspace_tpu_torch.serving.gateway import RoutingGateway
from devspace_tpu_torch.serving.router import PrefixRouter, RouterConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 19 requests of 4-32 prompt tokens and 16-32 new ones (at most 64
# positions)
TRACE = TraceSpec(seed=41, kind="poisson", duration_s=2.0, rate_rps=8,
                  prompt_len=(4, 32), max_new_tokens=(16, 32))
VOCAB = 256
NEAR_TIE_REL = 2.0 ** -6


@dataclasses.dataclass
class CpuReplicaSpec(ReplicaSpec):
    """A torch replica on the CPU: the server's ``--device cpu``."""

    def command(self, port: int) -> list:
        return super().command(port) + ["--device", "cpu"]


def converted_checkpoint(jparams, tmp) -> str:
    """The JAX params saved by the JAX package and converted for the port."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import convert_checkpoint
    from devspace_tpu.training.checkpoint import save_checkpoint

    save_checkpoint(str(tmp / "orbax"), jparams)
    return convert_checkpoint.orbax_to_torch(str(tmp / "orbax"), str(tmp / "torch"))


def jax_streams(jparams, trace) -> dict:
    """{(prompt, n): the JAX package's greedy generate}, one per distinct
    request."""
    import jax
    import jax.numpy as jnp

    from devspace_tpu.models import transformer as jtfm

    generate = jax.jit(jtfm.generate, static_argnums=(2, 3))
    out = {}
    for e in trace:
        key = cs.request_key(e)
        if key not in out:
            toks = generate(jparams, jnp.asarray([e["prompt_ids"]], jnp.int32), jtfm.TINY,
                            e["max_new_tokens"])
            out[key] = [int(t) for t in np.asarray(toks[0])]
    return out


def assert_near_tie(jparams, prompt, expected, received):
    """The first position where ``received`` leaves ``expected`` exists,
    and both tokens there lie within NEAR_TIE_REL of the largest logit's
    magnitude below the JAX forward's top logit."""
    import jax.numpy as jnp

    from devspace_tpu.models import transformer as jtfm

    pos = next((i for i, (a, b) in enumerate(zip(expected, received)) if a != b), None)
    assert pos is not None, ("corrupted without a differing token", expected, received)
    logits = np.asarray(jtfm.forward(jparams, jnp.asarray([prompt + expected[:pos]], jnp.int32),
                                     jtfm.TINY)[0, -1], np.float32)
    gap = logits.max() - min(logits[expected[pos]], logits[received[pos]])
    assert gap <= NEAR_TIE_REL * np.abs(logits).max(), (pos, gap, expected, received)


def test_loadgen_over_torch_replicas_killed_mid_trace(tmp_path):
    import jax

    from devspace_tpu.models import transformer as jtfm

    jparams = jtfm.init_params(jtfm.TINY, jax.random.PRNGKey(0))
    trace = cs.in_vocab(generate_trace(TRACE), VOCAB)
    assert all(len(e["prompt_ids"]) + e["max_new_tokens"] <= 128 for e in trace)
    assert all(0 < t < VOCAB for e in trace for t in e["prompt_ids"])
    fleet = ReplicaFleet(spec=CpuReplicaSpec(
        module="devspace_tpu_torch.serve",
        # /readyz is SLO-gated: the TTFT objective the fleet phase gives
        # replicas sharing their host, so "healthy" means alive and ready
        env={"MODEL": "tiny", "SPEC": "0", "MAX_SLOTS": "4", "PYTHONPATH": REPO,
             **cs.FLEET_SLO_ENV},
        ready_timeout_s=120.0, probe_timeout_s=5.0), replicas=2, poll_interval=0.5)

    def start():
        fleet.spec.env["CHECKPOINT"] = converted_checkpoint(jparams, tmp_path)
        fleet.start()

    # the checkpoint is written and the replicas start while the JAX
    # package computes the expected streams
    starting = threading.Thread(target=start, daemon=True)
    starting.start()
    gw = None
    try:
        expected = jax_streams(jparams, trace)
        starting.join(timeout=180)
        assert fleet.all_healthy()
        router = PrefixRouter(replicas_fn=fleet.targets,
                              config=RouterConfig(admission=False, block_size=16))
        gw = RoutingGateway(router, port=0)
        gw.start()
        gen = LoadGenerator(
            lambda: {"gw": gw.base_url}, request_timeout_s=30, hang_timeout_s=60,
            max_attempts=4,
            expected_fn=lambda e: expected[cs.request_key(e)])
        victim = fleet.names()[0]
        watch = cs.ReplicaWatch(fleet)
        base = watch.tokens(victim)

        def kill():
            cs.wait_until(lambda: watch.tokens(victim) > base, 60,
                          f"a token from {victim}")
            return watch.kill(victim)

        report, old_pid = cs.run_while(gen, trace, kill)
        counts = report.counts()
        assert len(report.outcomes) == len(trace)
        assert counts["hung"] == 0 and counts["failed"] == 0, report.to_dict()
        assert counts["completed"] + counts["retried"] + counts["corrupted"] == len(trace)
        by_id = {e["id"]: e for e in trace}
        for o in report.outcomes:
            if o.outcome == "corrupted":
                e = by_id[o.id]
                assert_near_tie(jparams, e["prompt_ids"], expected[cs.request_key(e)],
                                o.received)
        assert report.total_tokens() == sum(
            by_id[o.id]["max_new_tokens"] for o in report.outcomes
            if o.outcome in ("completed", "retried"))
        cs.wait_until(lambda: fleet.replica(victim).pid != old_pid and fleet.all_healthy(),
                      120, "the killed replica's restart", interval=0.2)
    finally:
        if gw is not None:
            gw.stop()
        fleet.stop()
