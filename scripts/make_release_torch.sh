#!/bin/sh
# Package a release artifact of the PyTorch/CUDA port for
# `python -m devspace_tpu_torch upgrade --archive` (and for a plain
# untar-anywhere install): the devspace_tpu_torch package with its CUDA
# sources (csrc/; the kernels build on first use at the install site),
# docs, examples and README.md, in a versioned top-level directory named
# devspace-tpu-torch-<version>. No network, no build step: the artifact
# IS the source.
#
#   sh scripts/make_release_torch.sh [OUT.tgz]   (default dist/devspace-tpu-torch-<version>.tgz)
set -e
CALLER_PWD=$PWD
cd "$(dirname "$0")/.."
PYTHON=${PYTHON:-python3}
VERSION=$("$PYTHON" -c "import re; print(re.search(r'__version__\s*=\s*[\"\\']([^\"\\']+)', open('devspace_tpu_torch/__init__.py').read()).group(1))")
NAME="devspace-tpu-torch-$VERSION"
# resolve OUT against the CALLER's cwd (we cd'd away from it)
case "${1:-}" in
    "") mkdir -p dist; OUT="$PWD/dist/$NAME.tgz" ;;
    /*) OUT="$1" ;;
    *) OUT="$CALLER_PWD/$1" ;;
esac
STAGE=$(mktemp -d)
trap 'rm -rf "$STAGE"' EXIT
mkdir -p "$STAGE/$NAME"
cp -r devspace_tpu_torch docs examples README.md "$STAGE/$NAME/"
# strip caches and the kernels built in this checkout
find "$STAGE" -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
rm -rf "$STAGE/$NAME/devspace_tpu_torch/_build"
tar -C "$STAGE" -czf "$OUT" "$NAME"
echo "wrote $OUT ($(du -h "$OUT" | cut -f1))"
