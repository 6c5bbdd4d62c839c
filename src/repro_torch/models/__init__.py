"""Model substrate of the port: the Mamba-2 (SSM) family, as ``nn.Module``s
holding the JAX package's parameter layout."""
