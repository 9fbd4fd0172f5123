"""Models of the port: the Llama-family transformer (serving and training),
the Mixtral-style MoE, and the vision zoo (ResNet, ViT, the MLP)."""
