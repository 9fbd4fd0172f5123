"""Project scaffolding for the port: language detection, Dockerfile and
chart generation (``generator.py``)."""
