"""The port's Go-template dialect (devspace_tpu_torch/deploy/gotemplate.py)
against the JAX package's: it is a copy of the reference's source, and
both engines give equal text (or the same ``TemplateError``) on every
template under ``examples/*/chart`` and both packages'
``generator/templates``, and on a table of the dialect's functions,
pipelines and control structures."""

import glob
import os

import pytest

from devspace_tpu.deploy import gotemplate as jgt
from devspace_tpu_torch.deploy import gotemplate as tgt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEMPLATES = sorted(
    p for pattern in ("examples/*/chart/**/*", "examples/*/*/chart/**/*",
                      "devspace_tpu/generator/templates/**/*",
                      "devspace_tpu_torch/generator/templates/**/*")
    for p in glob.glob(os.path.join(REPO, pattern), recursive=True)
    if p.endswith((".yaml", ".yml", ".tpl")))

CONTEXT = {
    "Values": {"name": "web", "replicas": 3, "image": {"repository": "r/web", "tag": "1.0"},
               "persistence": {"enabled": True, "size": "8Gi", "volumes": []},
               "service": {"port": 80, "type": "ClusterIP"}, "port": 8080,
               "resources": {"limits": {"cpu": "1"}}, "xs": ["p", "q"],
               "a-b": {"app.kubernetes.io/name": "web"}, "global": {"x": 1},
               "metrics": {"scrape": "true", "port": "8080", "path": "/metrics"}},
    "Release": {"Name": "rel", "Namespace": "ns", "Service": "devspace-tpu",
                "IsInstall": True, "IsUpgrade": False, "Revision": 1},
    "Chart": {"Name": "chart", "Version": "0.1.0", "AppVersion": "1"},
    "Capabilities": {"KubeVersion": {"Version": "v1.27.0", "Major": "1", "Minor": "27"}},
}


def outcome(gt, sources: dict, main: str, ctx: dict):
    """Text rendered by ``gt``'s Renderer, or the error it raised."""
    r = gt.Renderer(seed="rel/ns")
    try:
        for name, src in sources.items():
            r.load(name, src)
        return "ok", r.execute(main, ctx)
    except gt.TemplateError as e:
        return "TemplateError", str(e)
    except Exception as e:  # noqa: BLE001 — an engine fault is compared too
        return type(e).__name__, str(e)


def test_the_source_is_the_references():
    with open(jgt.__file__) as a, open(tgt.__file__) as b:
        assert a.read() == b.read()


def test_the_templates_are_the_ones_this_file_names():
    names = {os.path.relpath(p, REPO) for p in TEMPLATES}
    assert "examples/stateful-app/chart/packages/mysql/templates/_helpers.tpl" in names
    assert "devspace_tpu_torch/generator/templates/chart-gpu/templates/statefulset.yaml" in names
    assert len(names) >= 60


@pytest.mark.parametrize("path", TEMPLATES, ids=lambda p: os.path.relpath(p, REPO))
def test_template_renders_alike(path):
    # a chart's templates share one define namespace, as in the renderer
    chart_dir = os.path.dirname(path)
    while os.path.basename(chart_dir) == "templates" or not glob.glob(
            os.path.join(chart_dir, "[Cc]hart.yaml")):
        chart_dir = os.path.dirname(chart_dir)
    helpers = {p: open(p).read() for p in glob.glob(os.path.join(chart_dir, "templates",
                                                                  "_*.tpl"))}
    with open(path) as fh:
        sources = {**helpers, path: fh.read()}
    got, want = outcome(tgt, sources, path, CONTEXT), outcome(jgt, sources, path, CONTEXT)
    assert got == want


HELPERS = {
    "h": '{{- define "app.name" -}}{{ .Values.name | default "dflt" }}{{- end -}}'
         '{{- define "app.labels" -}}a: "1"\nb: "2"{{- end -}}',
}
TABLE = [
    # fields and pipelines
    ("{{ .Values.name }}", CONTEXT),
    ("{{ .Values.replicas }}", CONTEXT),
    ('{{ .Values.name | upper | quote }}', CONTEXT),
    ('{{ .Values.missing | default "fallback" }}', CONTEXT),
    ('{{ .a.b.c | default "d" }}', {}),
    # control structures and variables
    ("{{ if .a }}A{{ else if .b }}B{{ else }}C{{ end }}", {"a": 0, "b": "x"}),
    ("{{ if .a }}A{{ else if .b }}B{{ else }}C{{ end }}", {"a": [], "b": {}}),
    ("{{ if eq .x 5 }}eq{{ end }}", {"x": 5}),
    ("{{ if and .a (not .b) }}yes{{ end }}", {"a": 1, "b": 0}),
    ("{{ if or (lt .x 2) (ge .x 9) }}edge{{ end }}{{ if ne .x 3 }}!3{{ end }}", {"x": 9}),
    ("{{ range .xs }}[{{ . }}]{{ end }}", {"xs": [1, 2]}),
    ("{{ range $i, $v := .xs }}{{ $i }}={{ $v }};{{ end }}", {"xs": ["a", "b"]}),
    ("{{ range $k, $v := .m }}{{ $k }}:{{ $v }} {{ end }}", {"m": {"b": 2, "a": 1}}),
    ("{{ range .none }}x{{ else }}empty{{ end }}", {"none": []}),
    ("{{ with .cfg }}{{ .host }}:{{ .port }}{{ end }}", {"cfg": {"host": "h", "port": 80}}),
    ("{{ with .nope }}x{{ else }}d{{ end }}", {"nope": None}),
    ("{{ $n := .name }}{{ with .cfg }}{{ $n }}/{{ .port }}{{ end }}",
     {"cfg": {"port": 1}, "name": "app"}),
    ("{{ $x := .a }}{{ range .xs }}{{ $x }}{{ end }}", {"a": "v", "xs": [1, 2]}),
    ("{{ $v := 1 }}{{ $v = 2 }}{{ $v }}{{ $.top }}", {"top": "T"}),
    # define / include / template and indentation
    ('name: {{ include "app.name" . }}', {"Values": {"name": "x"}}),
    ('labels:\n{{ include "app.labels" . | indent 2 }}', {}),
    ('labels:{{ include "app.labels" . | nindent 2 }}', {}),
    ('{{ template "app.name" . }}', {"Values": {"name": "t"}}),
    # whitespace trimming and comments
    ("a\n  {{- if true }}\nb\n{{- end }}", {}),
    ("{{ if false }}x{{ end -}}\n  y", {}),
    ('a{{/* usage: {{ include "x" . }} */}}b', {}),
    ("x{{- /* c */ -}}\n  y", {}),
    # the function library
    ("resources:\n{{ toYaml .r | indent 2 }}", {"r": {"limits": {"cpu": "1", "mem": "2Gi"}}}),
    ("v: {{ toYaml .s | nindent 2 }}", {"s": "hello"}),
    ("{{ toJson .r }}|{{ .j | fromJson }}", {"r": {"a": [1, 2]}, "j": '{"b": 1}'}),
    ("{{ (fromYaml .y).k }}", {"y": "k: v\n"}),
    ('{{ printf "%s-%d" .a .b }}', {"a": "x", "b": 7}),
    ("{{ add 1 2 3 }}/{{ mul 2 3 }}/{{ sub 5 1 }}/{{ div 7 2 }}/{{ mod 7 2 }}", {}),
    ("{{ max 1 5 2 }}/{{ min 4 2 }}/{{ add1 3 }}", {}),
    ('{{ list "a" "b" | join "," }}', {}),
    ('{{ (dict "k" "v").k }}', {}),
    ('{{ $d := dict "a" 1 }}{{ $_ := set $d "b" 2 }}{{ keys $d | sortAlpha | join "," }}', {}),
    ('{{ hasKey .m "a" }}{{ .m | len }}', {"m": {"a": 1}}),
    ("{{ .s | trunc 3 }}", {"s": "abcdef"}),
    ('{{ .s | trimSuffix "-" | trimPrefix "x" | trim }}', {"s": "  xab-"}),
    ("{{ .s | b64enc }}/{{ .e | b64dec }}", {"s": "hi", "e": "aGk="}),
    ('{{ ternary "y" "n" .ok }}', {"ok": True}),
    ('{{ .s | replace "a" "b" | lower | title }}', {"s": "AAx"}),
    ('{{ contains "ab" .s }}{{ hasPrefix "x" .s }}{{ hasSuffix "b" .s }}', {"s": "xab"}),
    ('{{ (split "/" .s)._1 }}', {"s": "a/b"}),
    ('{{ splitList "," .s | last }}{{ first .xs }}{{ rest .xs | len }}', {"s": "a,b",
                                                                          "xs": [1, 2, 3]}),
    ('{{ index .Values "a-b" "app.kubernetes.io/name" }}', CONTEXT),
    ("{{ index .Values.xs 1 }}", CONTEXT),
    ('{{ index .Values "nope" | default "d" }}', CONTEXT),
    ('{{ regexReplaceAll "(a)" "abc" "${1}}" }}', {}),
    ('{{ regexMatch "^a.c$" "abc" }}', {}),
    ('{{ required "msg" .v }}', {"v": "x"}),
    ('{{ required "image is required" .v }}', {"v": ""}),
    ('{{ .x | toString | quote }}{{ .n | int }}{{ .f | float64 }}', {"x": 1, "n": "4",
                                                                     "f": "2.5"}),
    ("{{ .s | sha256sum | trunc 8 }}", {"s": "abc"}),
    ("{{ empty .a }}{{ empty .b }}{{ coalesce .a .b }}", {"a": "", "b": "z"}),
    ('{{ .Capabilities.KubeVersion.Minor }}{{ .Release.Name }}-{{ .Chart.Name }}', CONTEXT),
    ("{{ .x | kindOf }}{{ .x | typeOf }}", {"x": [1]}),
    ("{{ uniq .xs | len }}{{ without .xs 1 | len }}{{ has 2 .xs }}", {"xs": [1, 1, 2]}),
    ("{{ semverCompare \">=1.20\" .v }}", {"v": "1.27.0"}),
    ("{{ randAlphaNum 8 | len }}", {}),
    # errors
    ("{{ .x ", {}),
    ('{{ fail "boom" }}', {}),
    ('{{ include "nope" . }}', {}),
    ("{{ range .xs }}x", {"xs": [1]}),
    ("{{ if true }}x", {}),
    ("{{ .o.__class__ }}", {"o": {}}),
    ("{{ nosuchfunction 1 }}", {}),
]


@pytest.mark.parametrize("src, ctx", TABLE, ids=[src for src, _ in TABLE])
def test_dialect_table_renders_alike(src, ctx):
    sources = {**HELPERS, "main": src}
    got, want = outcome(tgt, sources, "main", ctx), outcome(jgt, sources, "main", ctx)
    assert got == want
