"""Training of the port: synthetic corpora and the LM train step."""
