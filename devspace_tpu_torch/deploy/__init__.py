"""The port's deploy layer: its own copy of the Go-template dialect
(``gotemplate``), the chart renderer and ``ChartDeployer`` (``chart``),
the raw-manifest deployer (``manifests``), both applying through a
``kube/`` backend, the chart packages vendored from chart repos
(``packages``) and the legacy list-of-strings lint shims (``lint``)."""
