"""The port's OBS7xx pack (devspace_tpu_torch/lint/rules_obs.py) against
the JAX package's: seeded bad catalogs (metric families, event entries,
timeline lanes) give equal findings under both, and the port's own
catalogs give none. ``load_metric_catalogs`` loads the port's catalogs,
which have no ``sync`` or ``trace`` family set."""

import pytest

from devspace_tpu.lint import LintContext as JContext
from devspace_tpu.lint import lint_obs_catalogs as jlint
from devspace_tpu.lint import run_rules as jrun
from devspace_tpu_torch.lint import LintContext as TContext
from devspace_tpu_torch.lint import lint_obs_catalogs as tlint
from devspace_tpu_torch.lint import load_metric_catalogs
from devspace_tpu_torch.lint import run_rules as trun

BAD_CATALOGS = {
    "names": (("BadName", "counter", "help", "sum"), ("ok_total", "summary", "help", "sum")),
    "suffix": (("requests", "counter", "help", "sum"), ("depth_total", "gauge", "help", "max"),
               ("latency", "histogram", "help", "sum"), ("load", "gauge", "help", "max")),
    "help": (("empty_help_total", "counter", "", "sum"),
             ("echo_total", "counter", "echo_total", "sum")),
    "agg": (("no_hint_total", "counter", "help"), ("maxed_total", "counter", "help", "max"),
            ("queue_seconds", "histogram", "help", "avg")),
    "dup": (("engine_requests_total", "counter", "help", "sum"),),
    "dup2": (("engine_requests_total", "counter", "help", "sum"),),
}


def keys(findings) -> list:
    # OBS702's message names the file that holds the suffix whitelist
    return sorted((f.rule_id, f.severity, f.location,
                   f.message.replace("devspace_tpu_torch/", "devspace_tpu/"))
                  for f in findings)


def test_seeded_catalogs_equal_the_reference():
    got = tlint(BAD_CATALOGS)
    assert keys(got) == keys(jlint(BAD_CATALOGS))
    assert {f.rule_id for f in got} == {"OBS700", "OBS701", "OBS702", "OBS703", "OBS704",
                                       "OBS705", "OBS706"}


@pytest.mark.parametrize("field, value", [
    ("event_catalog", [("engine", "BadName", "help"), ("engine", "ok", ""),
                       ("engine", "ok", "again"), ("engine", "short")]),
    ("timeline_tracks", ["decode", "", "decode", 3]),
])
def test_seeded_events_and_lanes_equal_the_reference(field, value):
    got = trun(TContext(**{field: value}), categories={"obs"})
    want = jrun(JContext(**{field: value}), categories={"obs"})
    assert keys(got) == keys(want) and len(got) >= 3


def test_the_ports_catalogs_are_clean():
    catalogs = load_metric_catalogs()
    assert set(catalogs) == {"engine", "serving", "resilience", "tracing", "events", "slo",
                             "collector", "fleet", "router"}
    assert all(len(fams) > 0 for fams in catalogs.values())
    assert tlint() == []
    assert tlint({}) == []  # an explicitly empty set lints the live events and lanes only
