"""Models of the port (the Llama-family transformer: serving and training)."""
