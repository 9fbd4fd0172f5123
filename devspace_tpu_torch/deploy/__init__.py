"""The port's deploy layer, render half: its own copy of the Go-template
dialect (``gotemplate``), the chart renderer and ``ChartDeployer``'s
render path (``chart``), and the raw-manifest render path
(``manifests``). Applying to a cluster needs ``kube/``, which the port
does not have yet."""
