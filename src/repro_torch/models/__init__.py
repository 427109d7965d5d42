"""The LM side: layers, the Mamba2 block, the composable LM and weight
transfer from the JAX package's parameter trees."""
